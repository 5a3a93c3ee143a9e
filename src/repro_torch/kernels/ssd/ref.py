"""Plain PyTorch versions of the Mamba2 SSD scan (state-space duality).

``ssd_scan_plain`` is the plain version of the CUDA kernel
(``csrc/ssd.cu``): the port of ``repro.models.layers._ssd_chunked``, with
the intra-chunk terms vectorised over every chunk at once and the (P, N)
f32 state carried chunk to chunk in a loop.  It takes the kernel's operands
(``a_neg = -exp(A_log)`` precomputed) and, like the kernel, decays the
state by ``exp(seg_last)``.  ``ssd_ref`` is the literal stepwise recurrence
(the port of ``repro.kernels.ssd.ref.ssd_ref``), the tests' oracle:

    h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * x_t (outer) b_t
    y_t = c_t . h_t + d_h * x_t

Shapes: x (B,T,H,P), dt (B,T,H), a_neg / a_log (H,), b and c (B,T,N)
shared by every head, d (H,) -> y (B,T,H,P) in x's dtype; all recurrence
math in f32.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_ref", "ssd_scan_plain"]


def ssd_scan_plain(x, dt, a_neg, b, c, d, *, chunk: int = 64) -> torch.Tensor:
    """Chunked SSD scan; ``T`` must be a multiple of ``chunk``.

    Raises:
        ValueError: ``T % chunk != 0`` (the reference asserts the same).
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc = t // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)
    a = a_neg.float()
    dskip = d.float()

    seg = torch.cumsum(dtf * a, dim=2)  # (B,NC,C,H) within-chunk log decay
    # Intra-chunk: L[i,j] = exp(seg_i - seg_j) for i >= j.  The exponent is
    # masked, not the result (exp of a masked positive exponent overflows).
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,NC,C,C,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], li, -torch.inf))
    cb = torch.einsum("zgin,zgjn->zgij", cf, bf)
    scores = cb[..., None] * decay * dtf[:, :, None, :, :]
    y = torch.einsum("zgijh,zgjhp->zgihp", scores, xf)

    # Chunk summaries S_g = sum_j exp(seg_last - seg_j) dt_j x_j b_j^T.
    last = seg[:, :, -1:, :]
    w = torch.exp(last - seg) * dtf
    s_chunk = torch.einsum("zgch,zgchp,zgcn->zghpn", w, xf, bf)
    chunk_decay = torch.exp(last[:, :, 0])  # (B,NC,H)
    c_seg = cf[:, :, :, None, :] * torch.exp(seg)[..., None]  # (B,NC,C,H,N)

    state = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    inter = []
    for g in range(nc):
        inter.append(torch.einsum("zchn,zhpn->zchp", c_seg[:, g], state))
        state = state * chunk_decay[:, g, :, None, None] + s_chunk[:, g]
    y = y + torch.stack(inter, dim=1) + dskip[:, None] * xf
    return y.reshape(bsz, t, h, p).to(x.dtype)


def ssd_ref(x, dt, a_log, b, c, d) -> torch.Tensor:
    """Stepwise SSD recurrence, one token at a time (the tests' oracle)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        dec = torch.exp(dtf[:, i] * a)  # (B,H)
        state = state * dec[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, i], xf[:, i], bf[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, i], state))
    y = torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf
    return y.to(x.dtype)
