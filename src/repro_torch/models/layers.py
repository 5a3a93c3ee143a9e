"""Model layers in PyTorch: the Mamba2 subset of ``repro.models.layers``.

Pure functions over dictionaries of tensors, with the reference's names,
parameter layout (the fused ``in_proj``) and precision policy: parameters
and activations in the model dtype, norms and SSD recurrences in f32.
``mamba_apply`` runs the SSD scan through ``kernels.ssd.ops.ssd``, which
launches the hand-written kernel on CUDA tensors and the plain version on
CPU tensors; ``plain=True`` takes the plain version on every device (the
on-card reference).  ``mamba_decode_step`` is plain PyTorch: the one-token
recurrence has no kernel in the reference either.

The reference's split-projection layout (``ssm_split_proj``) is a TPU
sharding layout; the port does not shard yet (ROADMAP A.13).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_scan_plain

__all__ = ["causal_conv1d", "dense_init", "embed_init", "mamba_apply",
           "mamba_decode_step", "mamba_init", "rms_norm"]


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
