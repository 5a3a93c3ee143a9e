"""Plain PyTorch version of causal / sliding-window GQA attention.

``attention_plain`` is the plain version of the CUDA kernel
(``csrc/flash_attention.cu``) and computes what the reference's Pallas
kernel computes (``repro.kernels.flash_attention.kernel``): an f32 softmax
over the keys a query may see, with the kernel's masks

    kpos < S,   causal: qpos >= kpos,   window > 0: qpos - kpos < window,

and query head ``h`` reading KV head ``h // (H // KH)``.  Inputs in bf16
are raised to f32 and the output rounded back, as the kernel does.

It is query-chunked, as ``repro.models.layers.attention`` is: each block
of ``q_chunk`` queries scores only the key span it can see (the window
before it and, when causal, nothing after it), so it needs O(S * (window +
q_chunk)) memory and never the dense (S, S) scores; at the full width of
h2o-danube-3-4b (batch 2, 7,168 positions, 32 heads) those would take
13 GB.  The reference pads K and V in front by ``window`` to keep its span
static under ``jit``; eager PyTorch slices the span directly, which gives
the same scores.  Each row's softmax runs over its whole span at once, so
the chunk size changes only the order of the sums.

Layout: q (B, S, H, D), k and v (B, S, KH, D) -> (B, S, H, D) in q's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_plain", "live_pairs"]


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_chunk: int = 512) -> torch.Tensor:
    """Masked softmax attention, one query block at a time.

    Raises:
        ValueError: H is not a multiple of KH, or the shapes disagree.
    """
    b, s, h, d = q.shape
    kh = k.shape[2]
    if h % kh or k.shape != (b, s, kh, d) or v.shape[:3] != (b, s, kh):
        raise ValueError(f"attention takes q (B,S,H,D) and k/v (B,S,KH,D) "
                         f"with H % KH == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, s, kh, g, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, kh, g, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s, q_chunk):
        q1 = min(q0 + q_chunk, s)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        k1 = q1 if causal else s
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf[:, k0:k1])
        sc = sc * scale
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= qpos - kpos < window
        sc = sc.masked_fill(~mask, -torch.inf)
        p = torch.softmax(sc, dim=-1)
        out[:, q0:q1] = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, k0:k1])
    return out.reshape(b, s, h, -1).to(q.dtype)


def live_pairs(s: int, *, causal: bool = True, window: int = 0) -> int:
    """Unmasked (query, key) pairs of one (batch, head): the work the masks
    leave, which bounds the kernel's operations."""
    total = 0
    for qpos in range(s):
        hi = qpos + 1 if causal else s
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total
