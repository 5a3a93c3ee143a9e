"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and the model-facing
entry.

The port of ``repro.kernels.ssd`` (Pallas ``ssd_scan``, ``kernel.py:80``;
host wrapper ``ops.py::ssd``).  ``ssd_scan`` dispatches on where its
tensors lie: CPU tensors run ``ref.ssd_scan_plain``, CUDA tensors launch
``csrc/ssd.cu`` (or raise; nothing falls back).  ``ssd`` takes the model
layer's conventions (``A_log``, ``D``) and precomputes ``-exp(A_log)`` as
the reference's wrapper does.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import runtime
from .ref import ssd_scan_plain

__all__ = ["LAUNCHES", "smem_bytes", "ssd", "ssd_scan"]

# Kernel launches issued by ``ssd_scan`` on CUDA tensors (a plain counter:
# callers zero it and read it back to prove a path ran through the kernel).
LAUNCHES = 0

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_MAX_CHUNK = 64
_MAX_SMEM = 232448  # dynamic shared memory one H100 block may use


def smem_bytes(headdim: int, nstate: int, chunk: int) -> int:
    """Dynamic shared memory of one kernel block (``csrc/ssd.cu``)."""
    return 4 * ((headdim + 2 * chunk) * (nstate + 1) + chunk * headdim
                + chunk * chunk + 4 * chunk)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_scan(x, dt, a_neg, b, c, d, *, chunk: int = 64) -> torch.Tensor:
    """y (B,T,H,P) from x (B,T,H,P), dt (B,T,H), a_neg = -exp(A_log) (H,),
    b/c (B,T,N), d (H,).

    On CUDA: x, b and c are f32 or bf16 (one type), dt, a_neg and d f32,
    all contiguous; ``T % chunk == 0``, ``chunk`` a multiple of 4 up to 64,
    P and N multiples of 4.  The kernel launches on the current stream
    without synchronising.

    Raises:
        ValueError: ``T % chunk != 0`` (on every device), or a shape,
            device or layout the kernel does not take.
        TypeError: a dtype the kernel does not take.
        RuntimeError: the library does not build or the launch fails.
    """
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_neg, b, c, d, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, got {x.device}")
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if chunk % 4 or not 4 <= chunk <= _MAX_CHUNK or p % 4 or n % 4:
        raise ValueError(f"the SSD kernel takes chunk a multiple of 4 up to "
                         f"{_MAX_CHUNK} and P, N multiples of 4; got chunk="
                         f"{chunk}, P={p}, N={n}")
    if smem_bytes(p, n, chunk) > _MAX_SMEM:
        raise ValueError(f"P={p}, N={n}, chunk={chunk} need "
                         f"{smem_bytes(p, n, chunk)} bytes of shared memory, "
                         f"above the block limit {_MAX_SMEM}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, (bsz, t, h, p), x.device)
    _check("dt", dt, torch.float32, (bsz, t, h), x.device)
    _check("a_neg", a_neg, torch.float32, (h,), x.device)
    _check("b", b, x.dtype, (bsz, t, n), x.device)
    _check("c", c, x.dtype, (bsz, t, n), x.device)
    _check("d", d, torch.float32, (h,), x.device)
    y = torch.empty_like(x)
    fn = getattr(runtime.load_library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), b.data_ptr(),
                  c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz, t, h, p, n,
                  int(chunk), torch.cuda.current_stream().cuda_stream)
    runtime.check(code, _ENTRY[x.dtype])
    global LAUNCHES
    LAUNCHES += 1
    return y


def ssd(x, dt, a_log, b, c, d, *, chunk: int = 64) -> torch.Tensor:
    """Mamba2 SSD with the model layer's arguments (signature of
    ``ref.ssd_ref`` plus ``chunk``): ``-exp(A_log)`` precomputed in f32,
    ``dt`` and ``D`` in f32, inputs made contiguous."""
    a_neg = -torch.exp(a_log.float())
    return ssd_scan(x.contiguous(), dt.float().contiguous(), a_neg.contiguous(),
                    b.contiguous(), c.contiguous(), d.float().contiguous(),
                    chunk=chunk)
