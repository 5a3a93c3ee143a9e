"""Architecture configs: the 10 assigned archs and the registry (a copy of
``repro.configs`` without the dry-run shape cells)."""

import importlib

from .base import ArchConfig, get_config, list_configs, register

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
    "get_config",
    "list_configs",
    "register",
]
