"""Model layers in PyTorch: the attention, gated-MLP and Mamba2 parts of
``repro.models.layers``.

Pure functions over dictionaries of tensors, with the reference's names,
parameter layout (the fused ``in_proj``, flat attention projections) and
precision policy: parameters and activations in the model dtype; norms,
softmax and SSD recurrences in f32.  The two full-sequence mixers launch
hand-written kernels on CUDA tensors and run their plain versions on CPU
tensors: ``attention`` through ``kernels.flash_attention.flash_attention``
and ``mamba_apply`` through ``kernels.ssd.ops.ssd``; ``plain=True`` takes
the plain version on every device (the on-card reference).
``decode_attention`` and ``mamba_decode_step`` are plain PyTorch: the
one-token steps have no kernel in the reference either.

The reference's split-projection layout (``ssm_split_proj``) is a TPU
sharding layout; the port does not shard yet (ROADMAP A.13).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_plain
from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_scan_plain

__all__ = ["apply_rope", "attention", "causal_conv1d", "decode_attention",
           "dense_init", "embed_init", "mamba_apply", "mamba_decode_step",
           "mamba_init", "mlp_apply", "mlp_init", "rms_norm", "rope_freqs"]


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype):
    """Fan-in scaled normal init, flattened out dims: (in_dim, *out_shape)."""
    shape = (in_dim,) + tuple(out_shape)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) rotated pairwise; positions: broadcastable to
    (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * inv  # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_chunk: int = 1024, scale: Optional[float] = None,
              plain: bool = False):
    """Grouped attention, causal or sliding-window (the reference's
    query-chunked ``attention``).

    q: (B, S, H, Dh); k, v: (B, S, KH, Dh) with H % KH == 0 -> (B, S, H, Dh).
    On CUDA tensors this launches the flash-attention kernel; on CPU
    tensors, or with ``plain=True``, it runs the plain version in query
    blocks of ``q_chunk``.  Both mask as the reference's kernel does, and
    for ``causal=True`` (every config of the repo) that is what the
    reference's layer computes.

    Raises:
        ValueError: ``S > q_chunk`` and ``S % q_chunk != 0`` (the reference
            asserts the same).
    """
    s = q.shape[1]
    if s > q_chunk and s % q_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"attention query chunk {q_chunk}")
    if plain:
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_chunk=q_chunk)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None):
    """One-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KH, Dh); ``pos``: tokens written
    so far, the current one (at index pos - 1) included.
    """
    b, _, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, 1, kh, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float())
    s = s * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos < pos
    if window > 0:
        valid &= kpos >= pos - window
    s = s.masked_fill(~valid, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, dh)


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype):
    return {"gate": dense_init(gen, d, (ff,), dtype),
            "up": dense_init(gen, d, (ff,), dtype),
            "down": dense_init(gen, ff, (d,), dtype)}


def mlp_apply(p, x):
    """Gated MLP: ``(silu(x gate) * (x up)) down``."""
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def _require_fused(cfg) -> None:
    if getattr(cfg, "ssm_split_proj", False):
        raise NotImplementedError(
            "ssm_split_proj is a TPU sharding layout; the port keeps the "
            "fused in_proj until it shards (ROADMAP A.13)")


def mamba_init(gen: torch.Generator, cfg, dtype):
    """One Mamba2 mixer's parameters, in the reference's layout."""
    _require_fused(cfg)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, (d,), dtype),
        "in_proj": dense_init(gen, d, (2 * di + 2 * n + h,), dtype),
        "conv_w": (conv_w * (1.0 / math.sqrt(cfg.ssm_conv))).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B,T,C), w: (K,C), b: (C,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):  # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _split(t, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(t, [di, di, n, n, cfg.ssm_heads], dim=-1)


def mamba_apply(p, x, cfg, *, plain: bool = False):
    """Full-sequence Mamba2 mixer.  x: (B,T,D) -> (B,T,D).

    Raises:
        ValueError: ``T % cfg.ssm_chunk != 0`` (the SSD scan's chunking).
    """
    _require_fused(cfg)
    bsz, t, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xin, b_in, c_in, dt = _split(x @ p["in_proj"], cfg)
    xbc = causal_conv1d(torch.cat([xin, b_in, c_in], dim=-1), p["conv_w"],
                        p["conv_b"])
    xin, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(bsz, t, h, hp)
    if plain:
        y = ssd_scan_plain(xh, dt, -torch.exp(p["A_log"].float()), b_in, c_in,
                           p["D"], chunk=cfg.ssm_chunk)
    else:
        y = ssd(xh, dt, p["A_log"], b_in, c_in, p["D"], chunk=cfg.ssm_chunk)
    y = rms_norm(y.reshape(bsz, t, di) * F.silu(z), p["norm"])
    return y @ p["out_proj"]


def mamba_decode_step(p, x, cfg, state):
    """Single-token Mamba2 step.

    x: (B,1,D); state: {"h": (B,H,P,N) f32, "conv": (B,K-1,conv_dim)}.
    Returns (y (B,1,D), new_state).
    """
    _require_fused(cfg)
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xin, b_in, c_in, dt = _split(x[:, 0] @ p["in_proj"], cfg)
    xbc = torch.cat([xin, b_in, c_in], dim=-1)  # (B, conv_dim)
    conv_hist = torch.cat([state["conv"], xbc[:, None]], dim=1)  # (B,K,cd)
    acc = torch.einsum("bkc,kc->bc", conv_hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xin, b_in, c_in = torch.split(acc.to(x.dtype), [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)

    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt * a)  # (B,H)
    xh = xin.reshape(bsz, h, hp).float()
    hnew = state["h"] * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, b_in.float())
    y = torch.einsum("bn,bhpn->bhp", c_in.float(), hnew)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = (y @ p["out_proj"])[:, None]
    return out, {"h": hnew, "conv": conv_hist[:, 1:]}
