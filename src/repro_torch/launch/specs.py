"""Shape-only stand-ins for every model input, parameter, optimizer state
and cache (the port of ``repro.launch.specs``): ``torch.device("meta")``
tensors, where the reference has ``jax.eval_shape``'s
``ShapeDtypeStruct``s.  Nothing is allocated.

``params_shape`` runs ``models.init_params`` under a fake-tensor mode (its
draws from a CPU ``torch.Generator`` cannot feed a meta tensor, and a fake
tensor holds no storage) on one layer a segment, then hands back meta
tensors of the same dtypes, each stack at its segment's depth.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs import ArchConfig, ShapeSpec
from ..models import init_cache, init_params, segments_of
from ..optim.adamw import init_opt_state
from ..tree import tree_map

__all__ = ["cache_shape", "input_specs", "opt_shape", "params_shape"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Batch stand-ins for an (arch x shape) cell.

    train  : tokens/embeddings + labels
    prefill: tokens/embeddings only
    decode : one new token (B, 1) + scalar position
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32), "pos": _meta((), i32)}

    batch: Dict[str, Any] = {}
    if cfg.frontend == "audio_frames":
        batch["embeddings"] = _meta((b, s, cfg.d_model), dtype)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    if cfg.frontend == "vision_patches":
        fs = min(cfg.frontend_seq, s // 2)
        batch["embeddings"] = _meta((b, fs, cfg.d_model), dtype)
        batch["tokens"] = _meta((b, s - fs), i32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s - fs), i32)
        return batch
    batch["tokens"] = _meta((b, s), i32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), i32)
    return batch


def params_shape(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameter tree of ``cfg`` as meta tensors.

    The layers of a segment are alike, so ``init_params`` runs on the
    config cut to one layer a segment (the dense first layers of an MoE
    model kept) and each segment's stack then takes its real depth.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    short = dataclasses.replace(
        cfg, num_layers=cfg.first_dense_layers + 1 if cfg.is_moe else 1)
    depth = {f"seg{i}": n for i, (_, n) in enumerate(segments_of(cfg))}
    assert [k for k, _ in segments_of(short)] == \
        [k for k, _ in segments_of(cfg)], cfg.name
    with FakeTensorMode():
        fake = init_params(short, torch.Generator().manual_seed(0),
                           dtype=dtype)
    return {k: tree_map(lambda t: _meta(
        (depth[k],) + tuple(t.shape[1:]) if k in depth else t.shape,
        t.dtype), v) for k, v in fake.items()}


def opt_shape(p_shape, moment_dtype=torch.float32):
    return init_opt_state(p_shape, moment_dtype=moment_dtype)


def cache_shape(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16):
    return init_cache(cfg, batch, s_max, dtype=dtype, device="meta")
