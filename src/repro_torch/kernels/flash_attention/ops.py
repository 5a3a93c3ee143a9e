"""Causal / sliding-window GQA flash attention: the CUDA kernel's wrapper.

The port of ``repro.kernels.flash_attention`` (Pallas ``flash_attention``,
``kernel.py:94``).  ``flash_attention`` dispatches on where its tensors
lie: CPU tensors run ``ref.attention_plain``, CUDA tensors launch
``csrc/flash_attention.cu`` (or raise; nothing falls back).  Unlike the
reference's wrapper it pads nothing: the kernel masks the ragged last tile
itself.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import runtime
from .ref import attention_plain

__all__ = ["LAUNCHES", "flash_attention", "smem_bytes"]

# Kernel launches issued by ``flash_attention`` on CUDA tensors (a plain
# counter: callers zero it and read it back to prove a path ran through the
# kernel).
LAUNCHES = 0

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_MAX_DIM = 128
_TILE = 64


def smem_bytes(headdim: int) -> int:
    """Dynamic shared memory of one kernel block
    (``csrc/flash_attention.cu``)."""
    ld = headdim + 4
    return 4 * _TILE * (ld + max(ld, _TILE + 4) + headdim)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """o (B,S,H,D) from q (B,S,H,D) and k, v (B,S,KH,D), H % KH == 0.

    On CUDA: q, k and v are one type, float32 or bfloat16, contiguous and
    16-byte aligned on one device; D a multiple of 8 up to 128.  The kernel
    launches on the current stream without synchronising.

    Raises:
        ValueError: a shape, device or layout the kernel does not take.
        TypeError: a dtype the kernel does not take.
        RuntimeError: the library does not build or the launch fails.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    b, s, h, d = q.shape
    kh = k.shape[2]
    if kh <= 0 or h % kh:
        raise ValueError(f"query heads {h} are not a multiple of KV heads "
                         f"{kh}")
    if d % 8 or not 0 < d <= _MAX_DIM:
        raise ValueError(f"the flash-attention kernel takes a head dimension "
                         f"that is a multiple of 8 up to {_MAX_DIM}, got {d}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t, shape in (("k", k, (b, s, kh, d)), ("v", v, (b, s, kh, d))):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    fn = getattr(runtime.load_library(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, s, h, kh, d, int(bool(causal)), int(window), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    runtime.check(code, _ENTRY[q.dtype])
    global LAUNCHES
    LAUNCHES += 1
    return o
