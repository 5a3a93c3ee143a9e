"""Block-level assembly (the port of ``repro.models.blocks``): the GQA/SWA
and MLA attention blocks with their decode caches, the pre-norm transformer
block with a dense or an MoE feed-forward, the Mamba2 block, and the use of
a shared block in Zamba2's published hybrid layer (``hybrid_*``: the
attention on concat(h, embeddings), no residual inside, a per-use adapter
and ``linear``), each with its decode-step variant.

**The decode cache is written in place.**  ``attn_prefill`` and
``attn_decode`` (and their MLA forms) write the new entries into the cache
tensors they are given and return the same tensors, where the reference
(immutable arrays) returns updated copies.  At the full width of
h2o-danube-3-4b the cache is about 3 GB, so a copy per decode step would
double its memory and time.  A caller that runs two paths from one cache
clones it first.

**The int8 KV cache** (``kv_cache_dtype="int8"``; no config selects it, the
reference serves it on request) stores K and V as a per-token, per-head
symmetric int8 payload with the scale ``max|x| / 127`` (floored at 1e-8) in
the cache's dtype beside it, as the reference's ``_kv_quant`` does; decode
attends over the dequantised cache.  MLA keeps its latent cache (``ckv``,
``krope``) in the model dtype whatever ``kv_cache_dtype`` says, as the
reference does.

**MLA** (DeepSeek-V2) prefills through per-head K and V materialised from
the latent, query and key heads ``qk_nope_dim + qk_rope_dim`` wide (192 at
full size) and V ``v_head_dim`` wide (the flash kernel's wrapper takes
V at that width); decode is absorbed into the latent space and stays plain
PyTorch, its einsums in f32, as the reference's jnp is.

**On a mesh** every block takes the sharding context ``ctx``
(``layers.ShardCtx``): the attention of training and prefill pins q, k, v
and its output to heads over ``"model"`` where the reference pins them and
runs the flash kernel per rank (``layers.attention``), the MoE runs
expert-parallel, and a DTensor cache, sequence-sharded over ``"model"`` by
``distributed.sharding.cache_specs``, is written in place by each rank on
the positions its own shard holds (``_write_seq``).  One-token decode
attention over that cache is left to DTensor's rules.
"""

from __future__ import annotations

import math

import torch

from ..distributed.sharding import is_dtensor, shard_span
from ..obs.trace import region
from . import layers as L
from .layers import NULL_CTX, ShardCtx

__all__ = ["attn_apply", "attn_cache_shape", "attn_decode", "attn_init",
           "attn_prefill", "block_apply", "block_decode", "block_init",
           "block_prefill", "hybrid_apply", "hybrid_decode",
           "hybrid_prefill", "hybrid_use_init", "mamba_block_apply",
           "mamba_block_decode", "mamba_block_init", "mamba_state_shape",
           "mla_apply", "mla_decode", "mla_init", "mla_prefill"]


# =============================================================== GQA attention


def attn_init(gen: torch.Generator, cfg, dtype, d_in: int = 0):
    """Projections stored flat (D, H*Dh), as the reference stores them, q, k
    and v from ``d_in`` (default D) wide inputs; an MLA config's are
    ``mla_init``'s."""
    if cfg.attention == "mla":
        return mla_init(gen, cfg, dtype)
    d, kh, dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    h = cfg.num_heads_padded
    d_in = d_in or d
    dev = gen.device
    p = {
        "wq": L.dense_init(gen, d_in, (h * dh,), dtype),
        "wk": L.dense_init(gen, d_in, (kh * dh,), dtype),
        "wv": L.dense_init(gen, d_in, (kh * dh,), dtype),
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
    h, kh, dh = cfg.num_heads_padded, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.split_heads(q, h, dh)
    k = L.split_heads(k, kh, dh)
    v = L.split_heads(v, kh, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _window(cfg) -> int:
    return cfg.swa_window if cfg.attention == "swa" else 0


def _scale(cfg):
    """The config's softmax scale, or None for 1 / sqrt(head_dim)."""
    return cfg.attn_scale or None


def _attend(p, x, cfg, q_chunk, plain, ctx: ShardCtx = NULL_CTX,
            hints: bool = False):
    """(out, k, v) of full-sequence attention; ``hints`` pins q, k, v and
    the output to heads over ``"model"``, where the reference's
    ``attn_apply`` pins them."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if hints:
        q, k, v = (ctx.constrain(t, ctx.dp, None, ctx.tp_axis, None)
                   for t in (q, k, v))
    o = L.attention(q, k, v, causal=cfg.causal, window=_window(cfg),
                    q_chunk=q_chunk, scale=_scale(cfg), plain=plain, ctx=ctx)
    if hints:
        o = ctx.constrain(o, ctx.dp, None, ctx.tp_axis, None)
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    return o.reshape(b, s, -1) @ p["wo"], k, v


def attn_apply(p, x, cfg, ctx: ShardCtx = NULL_CTX, *, q_chunk: int = 1024,
               plain: bool = False):
    """Full-sequence attention (train / prefill).  x: (B,S,D)."""
    if cfg.attention == "mla":
        return mla_apply(p, x, cfg, ctx, q_chunk=q_chunk, plain=plain)
    return _attend(p, x, cfg, q_chunk, plain, ctx, hints=True)[0]


def _kv_quant(x):
    """x: (..., Dh) -> (int8 payload, f32 scale (...,)): per row of Dh, the
    symmetric scale ``max|x| / 127`` floored at 1e-8 and ``x / scale``
    rounded half to even (``torch.round``, as ``jnp.round`` rounds) and
    clipped to [-127, 127].  Under ``jit`` XLA turns the reference's
    division by the constant 127 into a product with f32(1/127), so the
    port multiplies too: the scales are the jitted reference's bit for
    bit."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale[..., None].float()).to(dtype)


def _write_seq(dst, src, at) -> None:
    """``src`` (B, S, ...) into ``dst[:, at:at + S]`` in place; ``at`` an
    int or a 0-d int64 tensor on ``dst``'s device (then an ``index_copy_``,
    which a CUDA graph can replay at another position).

    A DTensor cache is sequence-sharded over ``"model"`` (``cache_specs``):
    each rank writes the positions its own shard holds, from ``src``
    gathered over every axis but the cache's batch axes; ``at`` an int."""
    s = src.shape[1]
    if isinstance(at, torch.Tensor):
        idx = at.view(1) if s == 1 else at + torch.arange(s, device=at.device)
        dst.index_copy_(1, idx, src.to(dst.dtype))
        return
    if not is_dtensor(dst):
        dst[:, at:at + s] = src
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = dst.device_mesh
    want = tuple(pl if pl == Shard(0) else Replicate()
                 for pl in dst.placements)
    src_l = src.redistribute(mesh, want).to_local()
    lo, hi = shard_span(dst, 1)
    a, b = max(lo, at), min(hi, at + s)
    if a < b:
        dst.to_local()[:, a - lo:b - lo] = src_l[:, a - at:b - at]


def _write_kv(cache, k, v, at) -> None:
    """K and V of positions [at, at + S) into ``cache`` in place, quantised
    when the cache is int8 (its scales stored in the cache's dtype)."""
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            payload, scale = _kv_quant(t)
            _write_seq(cache[name], payload, at)
            _write_seq(cache[f"{name}_scale"], scale, at)
    else:
        _write_seq(cache["k"], k, at)
        _write_seq(cache["v"], v, at)


def attn_prefill(p, x, cfg, cache, ctx: ShardCtx = NULL_CTX, *,
                 q_chunk: int = 1024, plain: bool = False):
    """Full attention over the prompt, writing K/V of positions [0, S) into
    ``cache`` in place.  Returns (out (B,S,D), cache)."""
    with region("model.attn"):
        if cfg.attention == "mla":
            return mla_prefill(p, x, cfg, cache, ctx, q_chunk=q_chunk,
                               plain=plain)
        out, k, v = _attend(p, x, cfg, q_chunk, plain, ctx)
        _write_kv(cache, k, v, 0)
        return out, cache


def attn_decode(p, x, cfg, cache, pos):
    """One-token decode.  x: (B,1,D); cache {"k","v"}: (B,S_max,KH,Dh)
    (int8 with ``k_scale``/``v_scale`` (B,S_max,KH) beside them); ``pos``
    is the index of the current token, whose K/V are written into
    ``cache`` in place: an int, or a 0-d int64 tensor on the step's device
    (not with a DTensor cache).  Returns (out (B,1,D), cache)."""
    with region("model.attn"):
        if cfg.attention == "mla":
            return mla_decode(p, x, cfg, cache, pos)
        return _gqa_decode(p, x, cfg, cache, pos)


def _positions(pos, b: int, device):
    """(B, 1) int32 positions of the token being decoded, from an int or a
    0-d tensor ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.to(torch.int32).expand(b, 1)
    return torch.full((b, 1), pos, dtype=torch.int32, device=device)


def _gqa_decode(p, x, cfg, cache, pos):
    b = x.shape[0]
    positions = _positions(pos, b, x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    _write_kv(cache, k, v, pos)
    if "k_scale" in cache:
        kc = _kv_dequant(cache["k"], cache["k_scale"], x.dtype)
        vc = _kv_dequant(cache["v"], cache["v_scale"], x.dtype)
    else:
        kc, vc = cache["k"], cache["v"]
    o = L.decode_attention(q, kc, vc, pos + 1, window=_window(cfg),
                           scale=_scale(cfg))
    hm = _head_mask(cfg, o.dtype, o.device)
    if hm is not None:
        o = o * hm
    return o.reshape(b, 1, -1) @ p["wo"], cache


def attn_cache_shape(cfg, batch: int, s_max: int, dtype, device=None):
    """Zero decode cache of one attention block: MLA's latent ``ckv`` (B,
    S_max, kv_lora_rank) and ``krope`` (B, S_max, qk_rope_dim); else K and
    V (B, S_max, KH, Dh), int8 with per-token-per-head scales in ``dtype``
    under ``kv_cache_dtype="int8"``."""
    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.attention == "mla":
        return {"ckv": zeros((batch, s_max, cfg.kv_lora_rank)),
                "krope": zeros((batch, s_max, cfg.qk_rope_dim))}
    shape = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    if getattr(cfg, "kv_cache_dtype", "bf16") == "int8":
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:3]), "v_scale": zeros(shape[:3])}
    return {"k": zeros(shape), "v": zeros(shape)}


# ================================================================ MLA (DSv2)


def mla_init(gen: torch.Generator, cfg, dtype):
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vdim, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": L.dense_init(gen, d, (h * (nope + rope),), dtype),
        "wkv_a": L.dense_init(gen, d, (lora + rope,), dtype),
        "kv_norm": torch.ones(lora, dtype=dtype, device=gen.device),
        "wkv_b": L.dense_init(gen, lora, (h * (nope + vdim),), dtype),
        "wo": L.dense_init(gen, h * vdim, (d,), dtype),
    }


def _mla_qkv(p, x, cfg, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), the normed latent ckv
    (B,S,lora), k_rope (B,S,rope)), rope applied."""
    nope, rope, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    q = L.split_heads(x @ p["wq"], cfg.num_heads, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]  # (B, S, lora + rope)
    ckv, k_rope = kv_a[..., :lora], kv_a[..., lora:]
    ckv = L.rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(p, x, cfg, q_chunk, plain, ctx: ShardCtx = NULL_CTX,
                hints: bool = False):
    """MLA over the full sequence: (out (B,S,D), ckv, k_rope); ``hints``
    pins the heads over ``"model"`` where the reference's ``mla_apply``
    pins them."""
    b, s, _ = x.shape
    h, nope, vdim = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, positions)
    if hints:
        q_nope = ctx.constrain(q_nope, ctx.dp, None, ctx.tp_axis, None)
    kv = L.split_heads(ckv @ p["wkv_b"], h, nope + vdim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if hints:
        k, v = (ctx.constrain(t, ctx.dp, None, ctx.tp_axis, None)
                for t in (k, v))
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    o = L.attention(q, k, v, causal=cfg.causal, q_chunk=q_chunk, scale=scale,
                    plain=plain, ctx=ctx)
    return o.reshape(b, s, h * vdim) @ p["wo"], ckv, k_rope


def mla_apply(p, x, cfg, ctx: ShardCtx = NULL_CTX, *, q_chunk: int = 1024,
              plain: bool = False):
    """Training / prefill MLA: per-head K (``k_nope`` and the shared
    ``k_rope``) and V materialised from the latent, attention at the scale
    1/sqrt(nope + rope).  V (``v_head_dim`` wide) is narrower than Q and K;
    ``layers.attention`` hands it to the flash kernel's wrapper at its
    own width."""
    return _mla_attend(p, x, cfg, q_chunk, plain, ctx, hints=True)[0]


def mla_prefill(p, x, cfg, cache, ctx: ShardCtx = NULL_CTX, *,
                q_chunk: int = 1024, plain: bool = False):
    """``mla_apply`` over the prompt, writing the latent ``ckv`` and
    ``krope`` of positions [0, S) into ``cache`` in place (the projections
    run once; the reference computes them twice, to the same values)."""
    out, ckv, k_rope = _mla_attend(p, x, cfg, q_chunk, plain, ctx)
    _write_seq(cache["ckv"], ckv, 0)
    _write_seq(cache["krope"], k_rope, 0)
    return out, cache


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed MLA decode: scores ``q_nope W_uk . ckv + q_rope . krope``
    in the latent space, values latent until ``W_uv`` and ``wo``; the
    einsums after the query's absorption in f32, as the reference's.  The
    current token's ``ckv``/``krope`` are written into ``cache`` at
    ``pos`` in place (an int, or a 0-d int64 tensor as in
    ``attn_decode``)."""
    b = x.shape[0]
    nope, rope, vdim, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
    h = cfg.num_heads
    positions = _positions(pos, b, x.device)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(p, x, cfg, positions)
    _write_seq(cache["ckv"], ckv_new, pos)
    _write_seq(cache["krope"], krope_new, pos)
    wkb = p["wkv_b"].reshape(lora, h, nope + vdim)
    w_uk, w_uv = wkb[..., :nope], wkb[..., nope:]
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)  # (B, 1, H, lora)
    scale = 1.0 / math.sqrt(nope + rope)

    def scores(qs, cs):
        s_lat = torch.einsum("bqhl,bkl->bhqk", qs[0].float(), cs[0].float())
        s_rope = torch.einsum("bqhr,bkr->bhqk", qs[1].float(), cs[1].float())
        return (s_lat + s_rope) * scale

    def values(prob, cs):
        return torch.einsum("bhqk,bkl->bqhl", prob, cs[0].float())

    qs, cs = (q_lat, q_rope), (cache["ckv"], cache["krope"])
    if is_dtensor(cache["ckv"]):
        ctx_lat = L.seq_sharded_attention(qs, cs, pos + 1, 0, scores, values)
    else:
        s = scores(qs, cs)
        kpos = torch.arange(s.shape[-1], device=x.device)
        s = s.masked_fill(~(kpos < pos + 1), -torch.inf)
        ctx_lat = values(torch.softmax(s, dim=-1), cs)
    o = torch.einsum("bqhl,lhv->bqhv", ctx_lat, w_uv.float()).to(x.dtype)
    return o.reshape(b, 1, h * vdim) @ p["wo"], cache


# ========================================================== transformer block


def block_init(gen: torch.Generator, cfg, dtype, *, moe: bool = False,
               d_in: int = 0):
    """A block's parameters: the MoE feed-forward (``"moe"``) when ``moe``,
    else the gated MLP (``"mlp"``); the first norm and q, k, v on ``d_in``
    (default D) wide inputs."""
    dev = gen.device
    p = {
        "ln1": torch.ones(d_in or cfg.d_model, dtype=dtype, device=dev),
        "attn": attn_init(gen, cfg, dtype, d_in),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if moe:
        p["moe"] = L.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def _gathered(h, ctx: ShardCtx):
    """On a mesh, a block's input with its sequence whole (batch over dp):
    the all-gather the reference leaves to GSPMD after the
    sequence-parallel residual that ``models.forward`` keeps between
    layers (and their remat checkpoints).  Gathering before the block's
    first operation keeps every product, and its gradient, off a
    sequence-sharded operand, which DTensor cannot flatten."""
    return ctx.constrain(h, ctx.dp, None, None)


def _feed_forward(p, h, cfg, ctx: ShardCtx = NULL_CTX):
    """(h + the feed-forward of norm(h), its aux loss): the MoE layer's, or
    0 for the gated MLP, as the reference gives them."""
    z = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y, aux = L.moe_apply(p["moe"], z, cfg, ctx)
    else:
        y = L.mlp_apply(p["mlp"], z, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def block_apply(p, x, cfg, ctx: ShardCtx = NULL_CTX, *, q_chunk: int = 1024,
                plain: bool = False):
    """Pre-norm transformer block.  Returns (x, aux_loss)."""
    x = _gathered(x, ctx)
    h = x + attn_apply(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                       ctx, q_chunk=q_chunk, plain=plain)
    return _feed_forward(p, h, cfg, ctx)


def block_prefill(p, x, cfg, cache, ctx: ShardCtx = NULL_CTX, *,
                  q_chunk: int = 1024, plain: bool = False):
    """The block over a prompt, K/V written into ``cache``; the MoE aux
    loss is dropped, as the reference drops it."""
    a, cache = attn_prefill(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, cache, ctx, q_chunk=q_chunk, plain=plain)
    return _feed_forward(p, x + a, cfg, ctx)[0], cache


def block_decode(p, x, cfg, cache, pos, ctx: ShardCtx = NULL_CTX):
    """One decode step of the block; the MoE aux loss is dropped."""
    a, cache = attn_decode(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                           cfg, cache, pos)
    return _feed_forward(p, x + a, cfg, ctx)[0], cache


# ============================================= Zamba2's published hybrid layer


def hybrid_use_init(gen: torch.Generator, cfg, dtype):
    """One use's own parameters: its ``linear`` (D, D) and, with
    ``adapter_rank`` r, its adapter on gate and up, ``adapter_a`` (D, r)
    and ``adapter_b`` (r, 2 F)."""
    d, r = cfg.d_model, cfg.adapter_rank
    p = {"linear": L.dense_init(gen, d, (d,), dtype)}
    if r:
        p["adapter_a"] = L.dense_init(gen, d, (r,), dtype)
        p["adapter_b"] = L.dense_init(gen, r, (2 * cfg.d_ff,), dtype)
    return p


def _hybrid_in(p, x, emb, cfg):
    """The shared block's normed input: concat(h, embeddings) under
    ``hybrid_concat_embed``, else h."""
    if cfg.hybrid_concat_embed:
        x = torch.cat([x, emb], dim=-1)
    return L.rms_norm(x, p["ln1"], cfg.norm_eps)


def _hybrid_out(p, u, a, cfg, ctx: ShardCtx = NULL_CTX):
    """The shared block's MLP on its normed attention output (no residual),
    with use ``u``'s adapter, through use ``u``'s ``linear``."""
    t = L.rms_norm(a, p["ln2"], cfg.norm_eps)
    adapter = (u["adapter_a"], u["adapter_b"]) if "adapter_a" in u else None
    y = L.mlp_apply(p["mlp"], t, ctx, act=cfg.mlp_act, adapter=adapter)
    return y @ u["linear"]


def hybrid_apply(p, u, x, emb, cfg, ctx: ShardCtx = NULL_CTX, *,
                 q_chunk: int = 1024, plain: bool = False, use: int = 0,
                 block: int = 0):
    """One use of shared block ``p`` (use ``u``'s parameters) over the full
    sequence: ``linear_u(mlp(norm(o_proj(attn(norm(concat(h, e)))))))``,
    what the published hybrid layer adds to its Mamba layer's input."""
    with region("model.hybrid", use=use, block=block):
        a = attn_apply(p["attn"], _hybrid_in(p, x, emb, cfg), cfg, ctx,
                       q_chunk=q_chunk, plain=plain)
        return _hybrid_out(p, u, a, cfg, ctx)


def hybrid_prefill(p, u, x, emb, cfg, cache, ctx: ShardCtx = NULL_CTX, *,
                   q_chunk: int = 1024, plain: bool = False, use: int = 0,
                   block: int = 0):
    """``hybrid_apply`` over a prompt, K/V written into the use's
    ``cache``."""
    with region("model.hybrid", use=use, block=block):
        a, _ = attn_prefill(p["attn"], _hybrid_in(p, x, emb, cfg), cfg,
                            cache, ctx, q_chunk=q_chunk, plain=plain)
        return _hybrid_out(p, u, a, cfg, ctx)


def hybrid_decode(p, u, x, emb, cfg, cache, pos, ctx: ShardCtx = NULL_CTX, *,
                  use: int = 0, block: int = 0):
    """One decode step of a use of the shared block."""
    with region("model.hybrid", use=use, block=block):
        a, _ = attn_decode(p["attn"], _hybrid_in(p, x, emb, cfg), cfg, cache,
                           pos)
        return _hybrid_out(p, u, a, cfg, ctx)


# ================================================================ Mamba block


def mamba_block_init(gen: torch.Generator, cfg, dtype):
    return {"ln": torch.ones(cfg.d_model, dtype=dtype, device=gen.device),
            "mixer": L.mamba_init(gen, cfg, dtype)}


def mamba_block_apply(p, x, cfg, ctx: ShardCtx = NULL_CTX, *,
                      plain: bool = False, add=None,
                      final_state: bool = False):
    """``x + mamba(norm(x + add))`` (``add`` a published hybrid layer's
    shared-block output; none elsewhere); with ``final_state`` (that, the
    mixer's decode state after the last step)."""
    with region("model.ssm"):
        x = _gathered(x, ctx)
        z = x if add is None else x + add
        y = L.mamba_apply(p["mixer"], L.rms_norm(z, p["ln"], cfg.norm_eps),
                          cfg, plain=plain, ctx=ctx, final_state=final_state)
        if final_state:
            return x + y[0], y[1]
        return x + y


def mamba_block_decode(p, x, cfg, state, add=None):
    with region("model.ssm"):
        z = x if add is None else x + add
        y, new_state = L.mamba_decode_step(
            p["mixer"], L.rms_norm(z, p["ln"], cfg.norm_eps), cfg, state)
        return x + y, new_state


def mamba_state_shape(cfg, batch: int, dtype, device=None):
    """Zero decode state of one Mamba2 block."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_bc_width
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
