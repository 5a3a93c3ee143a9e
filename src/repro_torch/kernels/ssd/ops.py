"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and the model-facing
entry.

The port of ``repro.kernels.ssd`` (Pallas ``ssd_scan``, ``kernel.py:80``;
host wrapper ``ops.py::ssd``).  ``ssd_scan`` dispatches on where its
tensors lie: CPU tensors run ``ref.ssd_scan_plain``, CUDA tensors launch
``csrc/ssd.cu`` (or raise; nothing falls back): per call a prologue that
forms G = C B^T once per (batch, chunk, group) and seg of every head, then
the scan, whose blocks each own one head and ``16 * _UNITS`` of its P
columns and carry their f32 state through the chunks, with the products on
the tensor cores in TF32 at f32 accuracy (three products each; the
source's note).  B and C are (B, T, N), shared by every head, or (B, T, G,
N), head h reading group h // (H / G); with ``final_state`` the scan also
writes the f32 state it carries at the last chunk's end (B, H, P, N),
which a prefill hands to decode.
``ssd`` takes the model layer's conventions (``A_log``, ``D``) and
precomputes ``-exp(A_log)`` as the reference's wrapper does.  ``LAUNCHES``
counts the kernel's calls (each the prologue and the scan).  On
``FakeTensor`` operands (``launch.dryrun``'s trace) ``_launch`` makes every
check, allocates the output and reports the call to
``runtime.shape_only`` in place of the launch, without the library or the
counter.

**Gradients.**  On CUDA tensors of which one requires grad (with grad
enabled), ``ssd_scan`` runs through ``_SsdScan``, a
``torch.autograd.Function``: its forward launches the kernel and saves only
the inputs; its backward recomputes ``ssd_scan_plain`` from them and
differentiates that (``runtime.plain_vjp``).  The backward is plain PyTorch
because the reference's Pallas kernel has none (no ``custom_vjp``; the
reference trains through its jnp scan).  A backward kernel is redesign work
for after the port (ROADMAP K.3).  Under ``no_grad`` or ``inference_mode``
the kernel launches directly, as serving does.
"""

from __future__ import annotations

import torch

from .. import runtime
from .ref import ssd_scan_plain

__all__ = ["LAUNCHES", "smem_bytes", "ssd", "ssd_flops", "ssd_scan"]

# Kernel calls issued by ``ssd_scan`` on CUDA tensors, one a call (the
# prologue and the scan; a plain counter: callers zero it and read it back
# to prove a path ran through the kernel).
LAUNCHES = 0

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_MAX_CHUNK = 64
_MAX_SMEM = 232448  # dynamic shared memory one H100 block may use
# Copied from csrc/ssd.cu (kSsdUnits, kSsdPiece, kSsdPad); a test holds
# these and ``smem_bytes`` to the source.
_UNITS = 2  # 16-row slices of one head's P a block
_PIECE = 32  # state columns of B and C a staged piece
_PAD = 8  # row padding of the staged tiles and the state (elements)


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def smem_bytes(headdim: int, nstate: int, chunk: int,
               dtype=torch.float32) -> int:
    """Dynamic shared memory of one scan block (``ssd_smem`` in
    ``csrc/ssd.cu``) for x, B and C of ``dtype``: two staged pieces of B and
    C, two chunks of the x slice, dt and seg, the f32 state of
    ``min(16 * _UNITS, headdim)`` rows, w, and the S warps' half of the
    chunk's end."""
    esize = torch.empty((), dtype=dtype).element_size()
    cp = (chunk + 15) // 16 * 16
    npad = (nstate + _PIECE - 1) // _PIECE * _PIECE
    width = 16 * _UNITS
    tile = cp * (_PIECE + _PAD)
    return (2 * _align16(2 * tile * esize)
            + _align16(2 * cp * (width + _PAD) * esize)
            + _align16(4 * cp * 4)
            + _align16(min(width, headdim) * (npad + _PAD) * 4)
            + _align16(cp * 4)
            + _align16(4 * _UNITS * 8 * 32 * 4))


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


def ssd_scan(x, dt, a_neg, b, c, d, *, chunk: int = 64,
             final_state: bool = False):
    """y (B,T,H,P) from x (B,T,H,P), dt (B,T,H), a_neg = -exp(A_log) (H,),
    b/c (B,T,N) or (B,T,G,N) with H % G == 0, d (H,); with
    ``final_state`` (y, the f32 state h_T (B,H,P,N)).

    On CUDA: x, b and c are f32 or bf16 (one type), dt, a_neg and d f32,
    all contiguous; ``T % chunk == 0``, ``chunk`` a multiple of 4 up to 64,
    P and N multiples of 4, and ``smem_bytes`` within a block's limit
    (N up to 1,248 at any P, chunk and type; more at P below 32).  The
    prologue and the scan launch on the current stream without
    synchronising.  Differentiable on every device: on CUDA tensors that
    require grad the kernel's forward pairs with the plain version's
    backward (module docstring); the final state is not (it is serving's).

    Raises:
        ValueError: ``T % chunk != 0`` (on every device), or a shape,
            device or layout the kernel does not take.
        TypeError: a dtype the kernel does not take.
        RuntimeError: the library does not build or the launch fails; the
            final state asked for on the gradient route.
        TypeError: a DTensor (``runtime.require_local``).
    """
    runtime.require_local("ssd_scan", x, dt, a_neg, b, c, d)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_neg, b, c, d, chunk=chunk,
                              final_state=final_state)
    inputs = (x, dt, a_neg, b, c, d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if final_state:
            raise RuntimeError("ssd_scan's final state has no gradient route")
        return _SsdScan.apply(*inputs, chunk)
    return _launch(*inputs, chunk, final_state)


class _SsdScan(torch.autograd.Function):
    """The kernel forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, b, c, d, chunk):
        ctx.save_for_backward(x, dt, a_neg, b, c, d)
        ctx.chunk = chunk
        return _launch(x, dt, a_neg, b, c, d, chunk)

    @staticmethod
    def backward(ctx, gy):
        chunk = ctx.chunk
        grads = runtime.plain_vjp(
            lambda *t: ssd_scan_plain(*t, chunk=chunk), ctx.saved_tensors,
            ctx.needs_input_grad[:6], gy, "ssd_scan.plain_backward")
        return (*grads, None)


def _launch(x, dt, a_neg, b, c, d, chunk, final_state: bool = False):
    """Check the operands and launch the kernel on CUDA tensors."""
    fake = runtime.is_fake(x, dt, a_neg, b, c, d)
    runtime.require_card("ssd_scan", x.device, fake)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    groups = b.shape[2] if b.ndim == 4 else 1
    bc_shape = (bsz, t, groups, n) if b.ndim == 4 else (bsz, t, n)
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the SSD "
                         f"chunk {chunk}")
    if chunk % 4 or not 4 <= chunk <= _MAX_CHUNK or p % 4 or n % 4:
        raise ValueError(f"the SSD kernel takes chunk a multiple of 4 up to "
                         f"{_MAX_CHUNK} and P, N multiples of 4; got chunk="
                         f"{chunk}, P={p}, N={n}")
    if groups < 1 or h % groups:
        raise ValueError(f"{h} heads do not split into {groups} groups of "
                         f"B and C")
    if smem_bytes(p, n, chunk, x.dtype) > _MAX_SMEM:
        raise ValueError(f"P={p}, N={n}, chunk={chunk} need "
                         f"{smem_bytes(p, n, chunk, x.dtype)} bytes of shared "
                         f"memory, above the block limit {_MAX_SMEM}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, (bsz, t, h, p), x.device)
    _check("dt", dt, torch.float32, (bsz, t, h), x.device)
    _check("a_neg", a_neg, torch.float32, (h,), x.device)
    _check("b", b, x.dtype, bc_shape, x.device)
    _check("c", c, x.dtype, bc_shape, x.device)
    _check("d", d, torch.float32, (h,), x.device)
    y = torch.empty_like(x)
    state = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if final_state else None)
    out = (y, state) if final_state else y
    if fake:
        runtime.shape_only("ssd", ssd_flops(bsz, t, h, p, n, chunk, groups),
                           sum(u.nbytes for u in (x, dt, a_neg, b, c, d, y)))
        return out
    fn = getattr(runtime.load_library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), b.data_ptr(),
                  c.data_ptr(), d.data_ptr(), y.data_ptr(),
                  state.data_ptr() if final_state else None, bsz, t, h, p, n,
                  groups, int(chunk), torch.cuda.current_stream().cuda_stream)
    runtime.check(code, _ENTRY[x.dtype])
    global LAUNCHES
    LAUNCHES += 1
    return out


def ssd_flops(bsz: int, t: int, h: int, p: int, n: int, chunk: int,
              groups: int = 1) -> float:
    """Operations of one chunked scan: C B^T once per (batch, chunk,
    group), shared by the group's heads; per (batch, head, chunk) the
    intra-chunk scores over the lower triangle, C h^T and the state
    update."""
    nc = t // chunk
    per_head = chunk * (chunk + 1) * p + 4.0 * chunk * p * n
    return 2.0 * chunk * chunk * n * bsz * nc * groups \
        + per_head * bsz * h * nc


def ssd(x, dt, a_log, b, c, d, *, chunk: int = 64,
        final_state: bool = False):
    """Mamba2 SSD with the model layer's arguments (signature of
    ``ref.ssd_ref`` plus ``chunk``): ``-exp(A_log)`` precomputed in f32,
    ``dt`` and ``D`` in f32, inputs made contiguous."""
    a_neg = -torch.exp(a_log.float())
    return ssd_scan(x.contiguous(), dt.float().contiguous(), a_neg.contiguous(),
                    b.contiguous(), c.contiguous(), d.float().contiguous(),
                    chunk=chunk, final_state=final_state)
