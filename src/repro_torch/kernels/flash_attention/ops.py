"""Causal / sliding-window GQA flash attention: the CUDA kernel's wrapper.

The port of ``repro.kernels.flash_attention`` (Pallas ``flash_attention``,
``kernel.py:94``).  ``flash_attention`` dispatches on where its tensors
lie: CPU tensors run ``ref.attention_plain``, CUDA tensors launch
``csrc/flash_attention.cu`` (or raise; nothing falls back).  Every kernel
runs on the tensor cores, one block per query tile of a (b, h) (and, where
V may be narrower than Q and K, per 128 columns of V):

* bfloat16: one design, a template over the tiles that the head dimension
  D sets.  ``wgmma`` fed by TMA: two consumer warpgroups (128 query rows)
  and one producer warp; K and V arrive in key tiles through a two-stage
  ring, Q and K in 64-column panels, D padded to a whole panel by the
  TMA's zero fill; P is rounded to bfloat16 before P V, as every
  tensor-core flash attention does;
* float32: ``wgmma`` on three TF32 products per operand pair
  (big = tf32(x), small = tf32(x - big); small.big + big.small + big.big),
  which keeps f32 accuracy.  A splitting warpgroup writes the big and small
  copies of each K and V tile (V transposed) for one consumer warpgroup of
  64 query rows.  Two designs, split at D = 128, each the faster on its
  side on an H100: up to it K and V^T share a two-stage ring and Q K^T is
  three products a k-step; above it Q's copies leave room for less, so K
  and V^T take rings of their own and two of the three products share
  one ``wgmma``.

Shared memory sets the key tile: up to D = 192 128 keys in bfloat16 and 32
in float32, above it 64 and 16 (float32's big and small copies of Q alone
take 128 KiB at D = 256).  Unlike the reference's wrapper it pads nothing
that the kernel can take: the TMA's zero fill and the kernel's masks cover
the ragged last tile and a D that fills no whole panel.

The C library has two entries per type (``csrc/flash_attention.cu``):
D up to 128 with V as wide as Q and K, and the wide ones for D from 136 to
256 (the reference's kernel takes any D; MLA's query and key heads are 192
wide) with V of its own width, a multiple of 8 up to D (MLA's is 128).
``_launch`` fits V to the entry it calls, zero-padding it to D (narrow) or
to a multiple of 8 (wide) and keeping the output's first Dv columns; each
output column weighs its own V column, so the padded ones change nothing
in the others.  ``LAUNCHES`` counts the launches of every entry;
``WIDE_LAUNCHES`` counts those of the wide entries alone, so a run can show
which entry ran.

**Shape-only route.**  On ``FakeTensor`` operands (a host-side trace of
the card's step, ``launch.dryrun``) ``_launch`` makes every check but the
pointer alignment, allocates what a launch allocates (the output, V's
padding) and, in place of the launch, reports the call with its flops and
bytes to ``runtime.shape_only``; it loads no library and moves neither
counter.  A real tensor never takes it.

**Gradients.**  On CUDA tensors of which one requires grad (with grad
enabled), ``flash_attention`` runs through ``_FlashAttention``, a
``torch.autograd.Function``: its forward launches the kernel and saves only
q, k and v; its backward recomputes ``attention_plain`` from them and
differentiates that (``runtime.plain_vjp``).  The backward is plain
PyTorch because the reference's Pallas kernel has none (no
``custom_vjp``; the reference trains through its jnp attention).  A
backward kernel is redesign work for after the port (ROADMAP B).  Under
``no_grad`` or ``inference_mode`` the kernel launches directly, as serving
does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import runtime
from .ref import attention_plain, live_pairs

__all__ = ["LAUNCHES", "WIDE_LAUNCHES", "block_rows", "flash_attention",
           "smem_bytes"]

# Kernel launches issued by ``flash_attention`` on CUDA tensors (a plain
# counter: callers zero it and read it back to prove a path ran through the
# kernel), every entry's; ``WIDE_LAUNCHES`` the wide entry's alone.
LAUNCHES = 0
WIDE_LAUNCHES = 0

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_WIDE_ENTRY = {torch.float32: "flash_attention_wide_f32",
               torch.bfloat16: "flash_attention_wide_bf16"}
# the narrow entries' largest D: up to it they take V as wide as Q and K
_NARROW_DIM = 128
_MAX_DIM = 256  # the wide entries'
# dtype -> (query rows of a kernel block, its dynamic shared memory in
# bytes at D <= 128; csrc/flash_attention.cu's kBm and kBf16Smem, kF32Bm
# and kF32Smem).  bfloat16: Q and two stages of K and V at 128 rows x 128
# padded columns; float32: the big and small copies of Q (64 rows) and two
# stages of K (32 rows) and V^T (128 x 32), 128 padded columns of 4 bytes.
# Both add 5 mbarriers and 1 KiB of alignment slack.
_BLOCK = {torch.bfloat16: (128, 5 * 2 * 128 * 128 + 5 * 8 + 1024),
          torch.float32: (64, (2 * 4 * 64 + 2 * (2 * 4 * 32 + 2 * 128))
                          * 128 + 5 * 8 + 1024)}


@functools.lru_cache(maxsize=None)
def _live_pairs(s: int, causal: bool, window: int) -> int:
    return live_pairs(s, causal=causal, window=window)


def block_rows(dtype) -> int:
    """Query rows of one tensor-core kernel block for q of ``dtype``."""
    return _BLOCK[dtype][0]


def smem_bytes(dtype) -> int:
    """Dynamic shared memory of one tensor-core kernel block for q of
    ``dtype`` and a head dimension up to 128, which the tiles pad to 128
    (``csrc/flash_attention.cu``)."""
    return _BLOCK[dtype][1]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """o (B,S,H,Dv) from q (B,S,H,D), k (B,S,KH,D) and v (B,S,KH,Dv),
    H % KH == 0.

    On CUDA: q, k and v are one type, float32 or bfloat16, contiguous and
    16-byte aligned on one device; D a multiple of 8 up to 256 (above 128
    the wide entries run) and Dv from 1 to D (V is zero-padded to the
    width the entry takes, module docstring).  The kernel launches on the
    current stream without synchronising.  Differentiable
    on every device: on CUDA tensors that require grad the kernel's forward
    pairs with the plain version's backward (module docstring).

    Raises:
        ValueError: a shape, device or layout the kernel does not take.
        TypeError: a dtype the kernel does not take.
        RuntimeError: the library does not build or the launch fails.
        TypeError: a DTensor (``runtime.require_local``).
    """
    runtime.require_local("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, scale)
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, go):
        causal, window, scale = ctx.mask
        grads = runtime.plain_vjp(
            lambda q, k, v: attention_plain(q, k, v, causal=causal,
                                            window=window, scale=scale),
            ctx.saved_tensors, ctx.needs_input_grad[:3], go,
            "flash_attention.plain_backward")
        return (*grads, None, None, None)


def _launch(q, k, v, causal, window, scale):
    """Check the operands and launch the kernel on CUDA tensors."""
    fake = runtime.is_fake(q, k, v)
    runtime.require_card("flash_attention", q.device, fake)
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
    dv = v.shape[-1]
    if not 0 < dv <= d:
        raise ValueError(f"V's width {dv} must be from 1 to the head "
                         f"dimension {d}")
    for name, t, shape in (("k", k, (b, s, kh, d)),
                           ("v", v, (b, s, kh, dv))):
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
        if not fake and t.data_ptr() % 16:  # a fake tensor has no pointer
            raise ValueError(f"{name} must be 16-byte aligned")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    wide = d > _NARROW_DIM
    # V's width as the entry takes it: D on the narrow entries, a multiple
    # of 8 on the wide ones
    width = -(-dv // 8) * 8 if wide else d
    if width != dv:
        v = F.pad(v, (0, width - dv))
    o = q.new_empty((b, s, h, width))
    if fake:
        pairs = b * h * _live_pairs(s, bool(causal), int(window))
        runtime.shape_only("flash_attention_wide" if wide else
                           "flash_attention", 2.0 * pairs * (d + width),
                           sum(t.nbytes for t in (q, k, v, o)))
    else:
        entry = (_WIDE_ENTRY if wide else _ENTRY)[q.dtype]
        fn = getattr(runtime.load_library(), entry)
        dims = (b, s, h, kh, d, width) if wide else (b, s, h, kh, d)
        with torch.cuda.device(q.device):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      *dims, int(bool(causal)), int(window), float(scale),
                      torch.cuda.current_stream().cuda_stream)
        runtime.check(code, entry)
        global LAUNCHES, WIDE_LAUNCHES
        LAUNCHES += 1
        WIDE_LAUNCHES += int(wide)
    return o if width == dv else o[..., :dv].contiguous()
