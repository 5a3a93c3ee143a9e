"""Plain forward pass of Zamba2-7B-Instruct, written from its published
description (arXiv:2411.15242 and the published ``config.json``).

Written for the benchmark's correctness check, in plain PyTorch and f32
with TF32 off for matrix products and cuDNN (no kernel, no cache, no
batching across requests): a whole sequence (prompt and served tokens)
runs through every layer at once.  With ``e`` the token embeddings and
``u`` the use (0, 1, ...) of hybrid layer ``li`` (``hybrid_layer_ids``),
the shared transformer block ``u % num_mem_blocks`` runs there::

    t = o_proj(attn(rmsnorm_2D(concat(h, e))))          # no residual
    a = gelu(gate) * up,  [gate, up] = split(W_gu t' + B_u A_u t'),
        t' = rmsnorm_D(t)
    s = linear_u(W_down a)
    h = h + mamba_li(rmsnorm(h + s))                    # residual is h

and every other layer is ``h + mamba(rmsnorm(h))``.  Attention is causal
MHA with RoPE (rotating the two halves of each head, over all of its
dims) and the softmax scale ``(head_dim / 2) ** -0.5``.  The Mamba2 mixer
projects ``[z, xBC, dt]``, convolves xBC depthwise and causally (with
bias), applies SiLU, runs the SSD with B and C in ``mamba_ngroups`` groups
(head h reads group h // (H / G)), adds ``D x``, and normalises
``y * silu(z)`` per group (gated RMSNorm) before ``out_proj``.  The head
is tied to the embedding.

The SSD is the chunked quadratic (state-space dual) form at the published
``chunk_size`` (256; a sequence is zero-padded to a whole chunk, which
changes no earlier output), computed apart from any scan of the program.

Departures: ``dt`` is ``softplus(dt + dt_bias)`` with no floor, as the
published kernels run it (``time_step_limit`` null; transformers' plain
path alone clamps it at ``time_step_min``); weights are the benchmark's
random ones in the program's layout (``gate`` and ``up`` stored apart,
``W_gu`` their concatenation); f32 where the checkpoint is bf16.

The weights are the program's tree: ``embed``; ``seg0`` (one Mamba layer
a row: ``ln`` and ``mixer``: ``in_proj``, ``conv_w`` (K, channels),
``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``norm``, ``out_proj``);
``shared_attn`` (a block a row: ``ln1``, ``attn`` ``wq``/``wk``/``wv``/
``wo``, ``ln2``, ``mlp`` ``gate``/``up``/``down``); ``hybrid`` (a use a
row: ``linear``, ``adapter_a``, ``adapter_b``); ``final_norm``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["Arch", "forward", "logits_at"]


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes of one configuration file, as the reference reads them."""

    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    hybrid_ids: Tuple[int, ...]
    blocks: int
    ngroups: int
    d_state: int
    ssm_heads: int
    ssm_headdim: int
    d_inner: int
    d_conv: int
    chunk: int

    @classmethod
    def from_file(cls, c: dict) -> "Arch":
        """From a configuration file's published keys."""
        if c["hidden_act"] != "gelu" or not c["use_mem_rope"] or \
                c["use_shared_attention_adapter"] or c["use_long_context"]:
            raise ValueError("the reference is Zamba2-7B's path: GELU, "
                             "RoPE, MLP adapters only, no long context")
        d, expand = c["hidden_size"], c["mamba_expand"]
        return cls(
            layers=c["num_hidden_layers"], d_model=d,
            heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
            head_dim=c["attention_head_dim"], d_ff=c["intermediate_size"],
            vocab=c["vocab_size"], eps=float(c["rms_norm_eps"]),
            rope_theta=float(c["rope_theta"]),
            hybrid_ids=tuple(c["hybrid_layer_ids"]),
            blocks=c["num_mem_blocks"], ngroups=c["mamba_ngroups"],
            d_state=c["mamba_d_state"], ssm_heads=c["n_mamba_heads"],
            ssm_headdim=c["mamba_headdim"], d_inner=expand * d,
            d_conv=c["mamba_d_conv"], chunk=c["chunk_size"])


@contextlib.contextmanager
def _no_tf32():
    """f32 products: TF32 off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (B, H, S, Dh): the halves rotated by position, as the published
    ``rotate_half`` does."""
    s, dh = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * emb.cos() + half * emb.sin()


def _attention(arch: Arch, p, x, heads_per_block: int = 4):
    """Causal MHA of ``x`` (B, S, 2D) -> (B, S, D), a few heads at a time."""
    b, s, _ = x.shape
    h, dh = arch.heads, arch.head_dim

    def heads(w):
        return (x @ w).view(b, s, -1, dh).transpose(1, 2)

    q = _rope(heads(p["wq"]), arch.rope_theta)
    k = _rope(heads(p["wk"]), arch.rope_theta)
    v = heads(p["wv"])
    rep = h // arch.kv_heads
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    scale = (dh / 2) ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    out = torch.empty_like(q)
    for lo in range(0, h, heads_per_block):
        sl = slice(lo, lo + heads_per_block)
        w = (q[:, sl] @ k[:, sl].transpose(-1, -2)) * scale
        w = torch.softmax(w.masked_fill(mask, float("-inf")), dim=-1)
        out[:, sl] = w @ v[:, sl]
    return out.transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def _segsum(a):
    """(..., Q) -> (..., Q, Q): sum of a over (j, i] below the diagonal,
    -inf above it."""
    q = a.shape[-1]
    a = a[..., None].expand(*a.shape, q)
    low = torch.ones(q, q, dtype=torch.bool, device=a.device).tril(-1)
    cs = torch.cumsum(a.masked_fill(~low, 0.0), dim=-2)
    keep = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return cs.masked_fill(~keep, float("-inf"))


def _ssd(x, dt, a, bm, cm, chunk: int):
    """The SSD in its chunked quadratic form: x (B, L, H, P), dt (B, L, H),
    a (H,), bm / cm (B, L, H, N) (each head's own rows) -> y (B, L, H, P),
    without the D term.  L is padded with zeros to a whole chunk."""
    b, l, h, p = x.shape
    pad = -l % chunk
    if pad:
        x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    xd = (x * dt[..., None]).view(b, nc, chunk, h, p)
    ad = (a * dt).view(b, nc, chunk, h).permute(0, 3, 1, 2)  # (B, H, C, Q)
    bm = bm.reshape(b, nc, chunk, h, -1)
    cm = cm.reshape(b, nc, chunk, h, -1)
    acum = torch.cumsum(ad, dim=-1)
    decay = torch.exp(_segsum(ad))  # (B, H, C, Q, Q)
    # within a chunk: y_i = sum_j<=i (c_i . b_j) exp(sum_(j,i] a dt) dt_j x_j
    g = torch.einsum("bclhn,bcshn->bchls", cm, bm)
    y = torch.einsum("bchls,bcshp->bclhp", g * decay.permute(0, 2, 1, 3, 4),
                     xd)
    # each chunk's end state from its own steps, then carried chunk to chunk
    tail = torch.exp(acum[..., -1:] - acum)  # (B, H, C, Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bm, tail, xd)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))  # (B,H,C+1,C+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", cm, states,
                         torch.exp(acum))
    return y.reshape(b, nc * chunk, h, p)[:, :l]


def _mamba(arch: Arch, p, x):
    """The Mamba2 mixer over ``x`` (B, L, D)."""
    b, l, _ = x.shape
    di, h, pd = arch.d_inner, arch.ssm_heads, arch.ssm_headdim
    gn = arch.ngroups * arch.d_state
    z, xbc, dt = torch.split(x @ p["in_proj"], [di, di + 2 * gn, h], dim=-1)
    width = xbc.shape[-1]
    xbc = F.conv1d(xbc.transpose(1, 2), p["conv_w"].T[:, None, :],
                   p["conv_b"], padding=arch.d_conv - 1, groups=width)
    xbc = F.silu(xbc[..., :l].transpose(1, 2))
    xs, bm, cm = torch.split(xbc, [di, gn, gn], dim=-1)
    per = h // arch.ngroups
    bm = bm.reshape(b, l, arch.ngroups, -1).repeat_interleave(per, dim=2)
    cm = cm.reshape(b, l, arch.ngroups, -1).repeat_interleave(per, dim=2)
    dt = F.softplus(dt + p["dt_bias"])
    xs = xs.reshape(b, l, h, pd)
    y = _ssd(xs, dt, -torch.exp(p["A_log"]), bm, cm, arch.chunk)
    y = (y + p["D"][:, None] * xs).reshape(b, l, di)
    g = (y * F.silu(z)).view(b, l, arch.ngroups, -1)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + 1e-5)
    return (g.reshape(b, l, di) * p["norm"]) @ p["out_proj"]


def _row(tree, i: int):
    if isinstance(tree, dict):
        return {k: _row(v, i) for k, v in tree.items()}
    return tree[i]


def _shared(arch: Arch, p, u, x, e):
    """One use of a shared block: its output, before any residual."""
    t = _attention(arch, p["attn"], _rms(torch.cat([x, e], dim=-1), p["ln1"],
                                         arch.eps))
    t = _rms(t, p["ln2"], arch.eps)
    w_gu = torch.cat([p["mlp"]["gate"], p["mlp"]["up"]], dim=-1)
    gu = t @ w_gu + (t @ u["adapter_a"]) @ u["adapter_b"]
    gate, up = gu.chunk(2, dim=-1)
    return (F.gelu(gate) * up) @ p["mlp"]["down"] @ u["linear"]


def forward(arch: Arch, weights, tokens: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states (B, L, D) of ``tokens`` (B, L)."""
    with _no_tf32():
        x = weights["embed"][tokens].float()
        e = x
        for li in range(arch.layers):
            p = _row(weights["seg0"], li)
            z = x
            if li in arch.hybrid_ids:
                u = arch.hybrid_ids.index(li)
                z = x + _shared(arch, _row(weights["shared_attn"],
                                           u % arch.blocks),
                                _row(weights["hybrid"], u), x, e)
            x = x + _mamba(arch, p["mixer"], _rms(z, p["ln"], arch.eps))
        return _rms(x, weights["final_norm"], arch.eps)


def logits_at(arch: Arch, weights, hidden: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab) of final-normed hidden states (..., D), through
    the tied head."""
    with _no_tf32():
        return (hidden @ weights["embed"].T)[..., :arch.vocab]
