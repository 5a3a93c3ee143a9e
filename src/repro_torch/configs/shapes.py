"""The four assigned input-shape cells and per-arch skip rules (a copy of
``repro.configs.shapes``: the port imports nothing of the reference)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "get_shape", "cell_is_runnable", "all_cells"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic decode (SSM state / hybrid / sliding-window cache): the only
# archs long_500k runs for.  Pure full-attention archs skip it per assignment.
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in _LONG_OK_FAMILIES or cfg.attention == "swa"
        if not sub_quadratic:
            return False, "pure full-attention arch; long_500k needs sub-quadratic attention"
    return True, ""


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def all_cells(configs: List[ArchConfig]):
    """Yield (cfg, shape, runnable, reason) for the full 40-cell grid."""
    for cfg in configs:
        for shape in SHAPES.values():
            ok, why = cell_is_runnable(cfg, shape)
            yield cfg, shape, ok, why
