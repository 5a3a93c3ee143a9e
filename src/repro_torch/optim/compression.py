"""Gradient compression with error feedback (the port of
``repro.optim.compression``): int8 block quantisation in blocks of 256,

    q = quantize(g + e);  all_reduce(q);  e' = (g + e) - dequantize(q)

The codec and the error-feedback state only, as in the reference: the
reduction happens outside, in whatever collective the caller issues on its
mesh (the port's training step reduces its gradients through DTensor's
redistributions and does not compress them, as the reference's does not).  The same f32 operations as
the reference, and ``torch.round`` rounds half to even as ``jnp.round``
does, so payloads, scales and residuals equal the reference's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..tree import tree_map

__all__ = ["BLOCK", "QuantState", "compress_with_feedback",
           "decompress_and_update", "dequantize_int8", "init_error_feedback",
           "quantize_int8"]

BLOCK = 256


class QuantState(NamedTuple):
    q: torch.Tensor  # int8 payload, (blocks, BLOCK)
    scale: torch.Tensor  # f32 per-block scales, (blocks,)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize_int8(g: torch.Tensor) -> QuantState:
    flat, _ = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QuantState(q=q, scale=scale[:, 0])


def dequantize_int8(qs: QuantState, shape) -> torch.Tensor:
    flat = (qs.q.float() * qs.scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape))


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_with_feedback(grads, errors):
    """Returns (tree of ``QuantState``, new error tree of f32)."""

    def one(g, e):
        target = g.float() + e
        qs = quantize_int8(target)
        return qs, target - dequantize_int8(qs, g.shape)

    pairs = tree_map(one, grads, errors)
    return (tree_map(lambda _, pr: pr[0], grads, pairs),
            tree_map(lambda _, pr: pr[1], grads, pairs))


def decompress_and_update(qtree, shapes_like):
    """The dequantised tree, shaped and typed as ``shapes_like``."""
    return tree_map(
        lambda like, qs: dequantize_int8(qs, like.shape).to(like.dtype),
        shapes_like, qtree)
