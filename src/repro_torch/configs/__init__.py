"""Architecture configs: the 10 assigned archs, the shape cells and the
registry (a copy of ``repro.configs``), and ``zamba2-7b-instruct``, the
published Zamba2-7B-Instruct, which the reference does not have (it is
registered, and not in ``ARCH_NAMES``)."""

import importlib

from .base import ArchConfig, get_config, list_configs, register
from .shapes import SHAPES, ShapeSpec, all_cells, cell_is_runnable, get_shape

_MODULES = [
    "h2o_danube_3_4b",
    "qwen2_5_32b",
    "mistral_large_123b",
    "qwen3_14b",
    "internvl2_26b",
    "deepseek_v2_lite_16b",
    "deepseek_moe_16b",
    "hubert_xlarge",
    "zamba2_7b",
    "zamba2_7b_instruct",
    "mamba2_130m",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"{__name__}.{m}")


ARCH_NAMES = [
    "h2o-danube-3-4b",
    "qwen2.5-32b",
    "mistral-large-123b",
    "qwen3-14b",
    "internvl2-26b",
    "deepseek-v2-lite-16b",
    "deepseek-moe-16b",
    "hubert-xlarge",
    "zamba2-7b",
    "mamba2-130m",
]

__all__ = [
    "ARCH_NAMES",
    "ArchConfig",
    "SHAPES",
    "ShapeSpec",
    "all_cells",
    "cell_is_runnable",
    "get_config",
    "get_shape",
    "list_configs",
    "register",
]
