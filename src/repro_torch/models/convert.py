"""Parameter trees from numpy: the bridge the tests use to run the port on
the reference's weights.

``params_from_numpy(cfg, tree, device, dtype)`` takes a nested dict of numpy
arrays in the reference's layout (for example ``repro.models.init_params``
with every leaf converted by ``numpy.asarray``) and returns the port's tree
of tensors, in either Mamba layout.  The port imports nothing of the
reference to do this: the caller hands numpy arrays in.

``split_to_fused`` and ``fused_to_split`` map a tree between the Mamba
mixer's two layouts (the fused ``in_proj``/``conv_w``/``conv_b`` and the
split projections of ``ssm_split_proj``) by concatenation in the fused
layout's order, so the two compute the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import segments_of

__all__ = ["fused_to_split", "params_from_numpy", "split_to_fused"]

# Leaves the reference keeps in f32 whatever the model dtype.
_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _convert(tree, device, dtype, name=""):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype, k) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind != "f" and arr.dtype.name != "bfloat16":
        raise TypeError(f"leaf {name!r} is not floating point: {arr.dtype}")
    t = torch.tensor(np.asarray(arr, dtype=np.float32))
    return t.to(device=device,
                dtype=torch.float32 if name in _F32_LEAVES else dtype)


def params_from_numpy(cfg, tree, device=None, dtype=torch.float32):
    """The port's parameter tree from a numpy tree in the reference layout.

    Raises:
        KeyError: a top-level entry the port's model expects is missing.
    """
    want = ["embed", "final_norm"] + [f"seg{i}" for i, _ in
                                      enumerate(segments_of(cfg))]
    # (an MoE model's seg0 is its dense first layers, seg1 its MoE layers;
    # a hybrid's shared attention blocks are stacked apart)
    if cfg.family == "hybrid":
        want.append("shared_attn")
    if not cfg.tie_embeddings:
        want.append("head")
    missing = [k for k in want if k not in tree]
    if missing:
        raise KeyError(f"parameter tree lacks {missing}")
    return {k: _convert(tree[k], device, dtype, k) for k in want}


# ------------------------------------------------- Mamba projection layouts
_SPLIT_PROJ = ("wz", "wx", "wb", "wc", "wdt")
_SPLIT_CONV = (("conv_w", ("conv_wx", "conv_wbc")),
               ("conv_b", ("conv_bx", "conv_bbc")))


def _map_mixers(fn, tree):
    """``fn`` applied to every Mamba mixer (a dict holding ``A_log``) of a
    parameter tree; every other leaf as it is."""
    if not isinstance(tree, dict):
        return tree
    if "A_log" in tree:
        return fn(tree)
    return {k: _map_mixers(fn, v) for k, v in tree.items()}


def split_to_fused(cfg, params):
    """The fused layout of a split-projection tree: ``in_proj`` the
    concatenation of ``wz, wx, wb, wc, wdt`` on the last dim, ``conv_w``
    and ``conv_b`` of x's and (B, C)'s (the fused layout's channel order),
    every other leaf shared.  The two trees compute the same thing."""
    def fuse(m):
        if "wz" not in m:
            return m
        out = {k: v for k, v in m.items()
               if k not in _SPLIT_PROJ + ("conv_wx", "conv_wbc", "conv_bx",
                                          "conv_bbc")}
        out["in_proj"] = torch.cat([m[k] for k in _SPLIT_PROJ], dim=-1)
        for fused, parts in _SPLIT_CONV:
            out[fused] = torch.cat([m[k] for k in parts], dim=-1)
        return out

    return _map_mixers(fuse, params)


def fused_to_split(cfg, params):
    """The split-projection layout of a fused tree (``split_to_fused``'s
    inverse: views of the fused leaves, split on the last dim)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def split(m):
        if "in_proj" not in m:
            return m
        out = {k: v for k, v in m.items()
               if k not in ("in_proj", "conv_w", "conv_b")}
        out.update(zip(_SPLIT_PROJ, torch.split(m["in_proj"],
                                                [di, di, n, n, h], dim=-1)))
        for fused, parts in _SPLIT_CONV:
            out.update(zip(parts, torch.split(m[fused], [di, 2 * n],
                                              dim=-1)))
        return out

    return _map_mixers(split, params)
