"""Block-level assembly (the port of ``repro.models.blocks``): the GQA/SWA
attention block with its KV cache, the pre-norm transformer block with a
dense or an MoE feed-forward, and the Mamba2 block, each with its
decode-step variant.

**The KV cache is written in place.**  ``attn_prefill`` and ``attn_decode``
write the new keys and values into the cache tensors they are given and
return the same tensors, where the reference (immutable arrays) returns
updated copies.  At the full width of h2o-danube-3-4b the cache is about
3 GB, so a copy per decode step would double its memory and time.  A
caller that runs two paths from one cache clones it first.

Not in this slice (each raises ``NotImplementedError`` naming ROADMAP):
MLA attention (``mla_*``, ROADMAP A.10 (c)) and the int8 KV cache
(``_kv_quant``, A.10 (e); no config of the repo selects it).
"""

from __future__ import annotations

import torch

from . import layers as L

__all__ = ["attn_apply", "attn_cache_shape", "attn_decode", "attn_init",
           "attn_prefill", "block_apply", "block_decode", "block_init",
           "block_prefill", "mamba_block_apply", "mamba_block_decode",
           "mamba_block_init", "mamba_state_shape"]


def _require_gqa(cfg) -> None:
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name} uses MLA attention, not ported yet (ROADMAP A.10 "
            f"(c))")


def _require_dense_cache(cache) -> None:
    if "k_scale" in cache:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP A.10 (e))")


# =============================================================== GQA attention


def attn_init(gen: torch.Generator, cfg, dtype):
    """Projections stored flat (D, H*Dh), as the reference stores them."""
    _require_gqa(cfg)
    d, kh, dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h = cfg.num_heads_padded
    dev = gen.device
    p = {
        "wq": L.dense_init(gen, d, (h * dh,), dtype),
        "wk": L.dense_init(gen, d, (kh * dh,), dtype),
        "wv": L.dense_init(gen, d, (kh * dh,), dtype),
        "wo": L.dense_init(gen, h * dh, (d,), dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * dh, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(kh * dh, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(kh * dh, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=dev)
    return p


def _head_mask(cfg, dtype, device):
    """(Hp, 1) mask zeroing the outputs of padded query heads."""
    hp, h = cfg.num_heads_padded, cfg.num_heads
    if hp == h:
        return None
    return (torch.arange(hp, device=device) < h).to(dtype)[:, None]


def _project_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    h, kh, dh = cfg.num_heads_padded, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kh, dh)
    v = v.reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg) -> int:
    return cfg.swa_window if cfg.attention == "swa" else 0


def _attend(p, x, cfg, q_chunk, plain):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = L.attention(q, k, v, causal=cfg.causal, window=_window(cfg),
                    q_chunk=q_chunk, plain=plain)
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    return o.reshape(b, s, -1) @ p["wo"], k, v


def attn_apply(p, x, cfg, *, q_chunk: int = 1024, plain: bool = False):
    """Full-sequence attention (train / prefill).  x: (B,S,D)."""
    _require_gqa(cfg)
    return _attend(p, x, cfg, q_chunk, plain)[0]


def attn_prefill(p, x, cfg, cache, *, q_chunk: int = 1024,
                 plain: bool = False):
    """Full attention over the prompt, writing K/V of positions [0, S) into
    ``cache`` in place.  Returns (out (B,S,D), cache)."""
    _require_gqa(cfg)
    _require_dense_cache(cache)
    out, k, v = _attend(p, x, cfg, q_chunk, plain)
    s = x.shape[1]
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return out, cache


def attn_decode(p, x, cfg, cache, pos: int):
    """One-token decode.  x: (B,1,D); cache {"k","v"}: (B,S_max,KH,Dh);
    ``pos`` is the index of the current token, whose K/V are written into
    ``cache`` in place.  Returns (out (B,1,D), cache)."""
    _require_gqa(cfg)
    _require_dense_cache(cache)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache["k"][:, pos:pos + 1] = k
    cache["v"][:, pos:pos + 1] = v
    o = L.decode_attention(q, cache["k"], cache["v"], pos + 1,
                           window=_window(cfg))
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    return o.reshape(b, 1, -1) @ p["wo"], cache


def attn_cache_shape(cfg, batch: int, s_max: int, dtype, device=None):
    """Zero KV cache of one attention block."""
    _require_gqa(cfg)
    if getattr(cfg, "kv_cache_dtype", "bf16") == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP A.10 (e))")
    shape = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ========================================================== transformer block


def block_init(gen: torch.Generator, cfg, dtype, *, moe: bool = False):
    """A block's parameters: the MoE feed-forward (``"moe"``) when ``moe``,
    else the gated MLP (``"mlp"``)."""
    dev = gen.device
    p = {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "attn": attn_init(gen, cfg, dtype),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if moe:
        p["moe"] = L.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _feed_forward(p, h, cfg):
    """(h + the feed-forward of norm(h), its aux loss): the MoE layer's, or
    0 for the gated MLP, as the reference gives them."""
    z = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = L.moe_apply(p["moe"], z, cfg)
    else:
        y = L.mlp_apply(p["mlp"], z)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def block_apply(p, x, cfg, *, q_chunk: int = 1024, plain: bool = False):
    """Pre-norm transformer block.  Returns (x, aux_loss)."""
    h = x + attn_apply(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                       q_chunk=q_chunk, plain=plain)
    return _feed_forward(p, h, cfg)


def block_prefill(p, x, cfg, cache, *, q_chunk: int = 1024,
                  plain: bool = False):
    """The block over a prompt, K/V written into ``cache``; the MoE aux
    loss is dropped, as the reference drops it."""
    a, cache = attn_prefill(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, cache, q_chunk=q_chunk, plain=plain)
    return _feed_forward(p, x + a, cfg)[0], cache


def block_decode(p, x, cfg, cache, pos: int):
    """One decode step of the block; the MoE aux loss is dropped."""
    a, cache = attn_decode(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           cfg, cache, pos)
    return _feed_forward(p, x + a, cfg)[0], cache


# ================================================================ Mamba block


def mamba_block_init(gen: torch.Generator, cfg, dtype):
    return {"ln": torch.ones(cfg.d_model, dtype=dtype, device=gen.device),
            "mixer": L.mamba_init(gen, cfg, dtype)}


def mamba_block_apply(p, x, cfg, *, plain: bool = False):
    return x + L.mamba_apply(p["mixer"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                             cfg, plain=plain)


def mamba_block_decode(p, x, cfg, state):
    y, new_state = L.mamba_decode_step(
        p["mixer"], L.rms_norm(x, p["ln"], cfg.norm_eps), cfg, state)
    return x + y, new_state


def mamba_state_shape(cfg, batch: int, dtype, device=None):
    """Zero decode state of one Mamba2 block."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
