"""Full-model assembly for every family of the repo (``dense``, ``moe``,
``vlm``, ``audio``, ``ssm`` and ``hybrid``; the port of
``repro.models.model``): parameters stacked
on a leading layer dimension (``params["seg0"]``, as the reference's
scanned segments store them), embeddings, the two frontend stubs and the
head, the full-sequence ``forward`` and ``loss_fn`` of training, the decode
cache, ``prefill`` and ``decode_step``.  Layers run in a Python loop where
the reference scans.

Segments per family, as the reference lays them out: ``dense``, ``vlm``
and ``audio`` one ``("dense", L)``; ``moe`` ``("dense",
first_dense_layers)`` then ``("moe", L - first_dense_layers)``; ``ssm``
one ``("mamba", L)``; ``hybrid`` one ``("zamba", L)`` of Mamba2 blocks
plus ``params["shared_attn"]``, ``n_shared_attn_blocks`` stacked dense
transformer blocks, each application of one with a KV cache of its own
(``cache["shared_attn"]``).  The reference's ``zamba2-7b`` runs the shared
block ``(li // every) % n_shared`` before layer ``li`` with ``li %
hybrid_attn_every == 0``, as a residual block.  The published hybrid
layer (``zamba2-7b-instruct``: ``hybrid_layer_ids``) runs use ``u`` of
the shared blocks, block ``u % n_shared``, at its ``u``-th hybrid layer
``li``, with ``e`` the token embeddings::

    t = o_proj(attn(rmsnorm(concat(h, e))))            # no residual
    a = act(gate) * up,  [gate, up] = W_gu t' + B_u A_u t',  t' = rmsnorm(t)
    s = linear_u(W_down a)
    h = h + mamba_li(rmsnorm(h + s))                    # residual h

(``blocks.hybrid_*``; ``params["hybrid"]`` stacks each use's ``linear``
and adapter), and every other layer ``h + mamba(rmsnorm(h))``.  A VLM's
batch carries ``embeddings`` (B, frontend_seq, D), the patch embeddings
put before its text tokens; its loss is over the text tail, and decode
positions after a prefill start at ``frontend_seq`` plus the text tokens.
An audio model's batch is its frame embeddings (B, S, D) and its labels;
it never reads ``params["embed"]``, whose gradient is then zero, as
``jax.grad`` gives it.

``forward``'s ``remat`` maps the reference's ``jax.checkpoint`` policies
onto ``torch.utils.checkpoint``, per layer: ``"full"`` keeps only each
layer's input and recomputes the layer in the backward pass (on the card
the SSD and flash kernels launch again there); ``"dots"`` also keeps the
outputs of the plain matrix products (``aten.mm``/``addmm``, the
reference's ``checkpoint_dots_with_no_batch_dims``) through a selective
checkpoint; ``"none"`` keeps everything.  The gradients are the same under
all three.  A hybrid layer's shared-attention application and its Mamba
block are checkpointed as one body, as the reference checkpoints them; the
shared blocks' gradients sum over their applications, as under
``jax.grad``.

Reference behaviour kept on purpose: ``prefill`` leaves the Mamba caches
untouched, a hybrid's too, and fills only its shared-attention caches (the
reference does not capture the SSM state from a prompt, so decode starts
from a zero state), except under ``prefill_ssm_state``
(``zamba2-7b-instruct``), where it writes each mixer's final SSM state
(the scan's) and its last ``ssm_conv - 1`` conv inputs into the cache, so
decode continues the prompt as the published model does; a prompt whose
length is not a multiple of ``cfg.ssm_chunk`` is refused by the SSD scan,
and an attention prompt longer than ``q_chunk`` that is not a multiple of
it by the attention.

**Spans.**  Under ``obs.trace.tracing(tracer)`` a step records
``model.prefill`` or ``model.decode_step``, a ``model.layer`` per layer
and ``model.head``, with the blocks' and layers' spans inside
(``model.attn``, ``model.moe.*``, ``model.ffn``, ``model.ssm``, and
``model.hybrid`` (``use``, ``block``) around a published hybrid layer's
shared-block use up to its ``linear``, its ``model.attn`` and
``model.ffn`` inside); with no
tracer set each is the shared no-op.  A decode step replayed as a CUDA
graph (``models.graph``) records its ``model.decode_step`` alone.

**The cache is written in place, for every family.**  ``prefill`` and
``decode_step`` write into the cache tensors they are given (attention K/V
at the positions they fill, Mamba states at every decode step) and hand
back a dict holding the same tensors.  A caller that runs two paths gives
each its own cache (or clones one first).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed.sharding import is_dtensor, mesh_map
from ..obs.trace import region
from . import blocks as B
from . import layers as L
from .graph import DecodeGraphs
from .layers import NULL_CTX, ShardCtx, mesh_scope

__all__ = ["decode_step", "embed_inputs", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "segments_of"]

Params = Dict[str, Any]


def segments_of(cfg) -> Tuple[Tuple[str, int], ...]:
    """The model's segments of homogeneous blocks, as (kind, layers)."""
    if cfg.family == "ssm":
        return (("mamba", cfg.num_layers),)
    if cfg.family == "hybrid":
        return (("zamba", cfg.num_layers),)
    if cfg.is_moe:
        fd = cfg.first_dense_layers
        return ((("dense", fd),) if fd else ()) + (("moe",
                                                     cfg.num_layers - fd),)
    return (("dense", cfg.num_layers),)


def _stack_init(fn, count: int):
    """``count`` draws of ``fn()`` stacked on a new dim 0, filled layer by
    layer so only one layer exists twice at a time."""
    first = fn()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((count,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, count):
        put(out, fn(), i)
    return out


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as views (writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Random parameters from ``gen`` (made on ``gen.device``), in the
    reference's tree layout; embeddings padded to ``vocab_padded``."""
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                       dtype)}
    for i, (kind, count) in enumerate(segments_of(cfg)):
        if kind in ("dense", "moe"):
            fn = functools.partial(B.block_init, gen, cfg, dtype,
                                   moe=kind == "moe")
        else:  # the Mamba backbone of ``ssm`` and ``hybrid``
            fn = functools.partial(B.mamba_block_init, gen, cfg, dtype)
        p[f"seg{i}"] = _stack_init(fn, count)
    if cfg.family == "hybrid":
        d_in = 2 * cfg.d_model if cfg.hybrid_concat_embed else 0
        p["shared_attn"] = _stack_init(
            functools.partial(B.block_init, gen, cfg, dtype, d_in=d_in),
            cfg.n_shared_attn_blocks)
        if cfg.hybrid_layer_ids:
            p["hybrid"] = _stack_init(
                functools.partial(B.hybrid_use_init, gen, cfg, dtype),
                len(cfg.hybrid_layer_ids))
    p["final_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=gen.device)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, (cfg.vocab_padded,), dtype)
    return p


def lookup(embed, tokens) -> torch.Tensor:
    """``embed[tokens]``.  A DTensor table is looked up through
    ``local_map``: the table gathered whole on every rank, each rank's own
    tokens (their batch placement), the table's gradient partial over the
    axes the tokens are sharded on.  DTensor's own index rules do not
    carry the lookup's gradient on every PyTorch version."""
    if not is_dtensor(embed):
        return embed[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = embed.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not is_dtensor(tokens):  # the same tokens on every rank
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tok = tuple(tokens.placements)
    grad = tuple(Partial() if x == Shard(0) else Replicate() for x in tok)
    return mesh_map(mesh, lambda e, t: e[t], (embed, tokens), (rep, tok),
                    (tok,), (grad, tok))


def embed_inputs(cfg, params: Params, batch) -> torch.Tensor:
    """Token embedding, or the frontend stub's: an audio model's batch is
    its frame embeddings; a VLM's patch embeddings, cast to the token
    embeddings' dtype, come before its text tokens."""
    if cfg.frontend == "audio_frames":
        return batch["embeddings"]
    tok = lookup(params["embed"], batch["tokens"])
    if cfg.frontend == "vision_patches":
        return torch.cat([batch["embeddings"].to(tok.dtype), tok], dim=1)
    return tok


def _mask_pad_logits(cfg, logits):
    """The dtype's lowest value on the padded vocab tail."""
    vp = logits.shape[-1]
    if vp == cfg.vocab_size:
        return logits
    col = torch.arange(vp, device=logits.device)
    # filled on the device (no copy from the host, which a capture refuses)
    neg = logits.new_full((), torch.finfo(torch.float32).min)
    return torch.where(col < cfg.vocab_size, logits, neg)


def _n_attn_apps(cfg) -> int:
    """A hybrid model's shared-attention applications: one at each of its
    ``hybrid_layer_ids``, or one every ``hybrid_attn_every`` layers from
    layer 0."""
    if cfg.hybrid_layer_ids:
        return len(cfg.hybrid_layer_ids)
    return -(-cfg.num_layers // cfg.hybrid_attn_every)


def _shared_at(cfg, li: int):
    """(application, shared block) run at hybrid layer ``li``, or None."""
    if cfg.hybrid_layer_ids:
        if li not in cfg.hybrid_layer_ids:
            return None
        use = cfg.hybrid_layer_ids.index(li)
        return use, use % cfg.n_shared_attn_blocks
    every = cfg.hybrid_attn_every
    if li % every:
        return None
    return li // every, (li // every) % cfg.n_shared_attn_blocks


def _zamba_body(lp, shared, li, x, *, cfg, q_chunk, plain, ctx, uses=None,
                emb=None):
    """Hybrid layer ``li``: its shared-attention application, if any, then
    its Mamba block (the published layer's: the application's output added
    to the Mamba block's input; ``uses`` each use's parameters)."""
    at = _shared_at(cfg, li)
    if at is not None and cfg.hybrid_layer_ids:
        s = B.hybrid_apply(shared[at[1]], uses[at[0]], x, emb, cfg, ctx,
                           q_chunk=q_chunk, plain=plain, use=at[0],
                           block=at[1])
        return B.mamba_block_apply(lp, x, cfg, ctx, plain=plain, add=s)
    if at is not None:
        x, _ = B.block_apply(shared[at[1]], x, cfg, ctx, q_chunk=q_chunk,
                             plain=plain)
    return B.mamba_block_apply(lp, x, cfg, ctx, plain=plain)


def _logits(cfg, params, x, ctx: ShardCtx = NULL_CTX):
    """Final norm and the (tied or own) head; the padded tail unmasked;
    on a mesh pinned to (dp, None, tp), as the reference pins them."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    return ctx.constrain(logits, ctx.dp, None, ctx.tp_axis)


def _head(cfg, params, x):
    """Final norm, head and the padded tail masked (``model.head``)."""
    with region("model.head"):
        return _mask_pad_logits(cfg, _logits(cfg, params, x))


# Plain matrix products without batch dims: what ``remat="dots"`` keeps.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, remat: str):
    """``body`` wrapped by the checkpoint policy ``remat`` names."""
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _keep_dots))
    raise ValueError(f"remat must be 'full', 'dots' or 'none', got {remat!r}")


def _unstack(tree, count: int):
    """The ``count`` layers of a stacked tree, each leaf split once
    (``unbind``), so the backward pass stacks each leaf's layer gradients
    in one step."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(count)]
    if is_dtensor(tree) and any(
            p.is_shard(0) and tree.device_mesh.size(i) > 1
            for i, p in enumerate(tree.placements)):
        # DTensor splits no sharded dim: the hybrid's shared blocks, whose
        # leading dim (not a layer dim) the FSDP rule may shard, are
        # gathered on it first, as GSPMD gathers them in the reference
        from torch.distributed.tensor import Replicate

        tree = tree.redistribute(tree.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in tree.placements])
    return torch.unbind(tree, 0)


def forward(cfg, params: Params, batch, ctx: ShardCtx = NULL_CTX, *,
            remat: str = "full", q_chunk: int = 1024, plain: bool = False):
    """Full-sequence forward pass; returns (logits (B, S, Vp), aux loss).

    The logits are unmasked over the padded vocabulary tail, as the
    reference's are; ``loss_fn`` masks them.  ``remat`` is the per-layer
    checkpoint policy (module docstring); ``plain=True`` runs the
    attention's and the SSD scan's plain versions on every device, as in
    ``prefill``.  On a mesh (``ctx``; parameters and batch DTensors placed
    by ``distributed.sharding``) the residual stream is pinned where the
    reference pins it: batch over dp after the embedding and each segment,
    and (dp, tp, None) before each layer, its sequence-parallel layout.

    Raises:
        ValueError: an unknown ``remat``; a sequence length the SSD chunk
            or the attention's query chunk does not divide.
    """
    with mesh_scope(ctx):
        return _forward(cfg, params, batch, ctx, remat, q_chunk, plain)


def _forward(cfg, params, batch, ctx, remat, q_chunk, plain):
    x = embed_inputs(cfg, params, batch)
    x = ctx.constrain(x, ctx.dp, None, None)
    emb = x if cfg.hybrid_concat_embed else None
    uses = (_unstack(params["hybrid"], len(cfg.hybrid_layer_ids))
            if cfg.hybrid_layer_ids else None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, count) in enumerate(segments_of(cfg)):
        if kind == "zamba":
            shared = _unstack(params["shared_attn"],
                              cfg.n_shared_attn_blocks)
        for li, lp in enumerate(_unstack(params[f"seg{i}"], count)):
            x = ctx.constrain(x, ctx.dp, ctx.tp_axis, None)
            if kind in ("dense", "moe"):
                body = functools.partial(B.block_apply, lp, cfg=cfg, ctx=ctx,
                                         q_chunk=q_chunk, plain=plain)
                x, aux = _remat(body, remat)(x)
                aux_total = aux_total + aux
            elif kind == "zamba":
                body = functools.partial(_zamba_body, lp, shared, li,
                                         cfg=cfg, q_chunk=q_chunk,
                                         plain=plain, ctx=ctx, uses=uses,
                                         emb=emb)
                x = _remat(body, remat)(x)
            else:
                body = functools.partial(B.mamba_block_apply, lp, cfg=cfg,
                                         ctx=ctx, plain=plain)
                x = _remat(body, remat)(x)
        x = ctx.constrain(x, ctx.dp, None, None)
    return _logits(cfg, params, x, ctx), aux_total


def loss_fn(cfg, params: Params, batch, ctx: ShardCtx = NULL_CTX, *,
            remat: str = "full", q_chunk: int = 1024,
            aux_weight: float = 0.01, plain: bool = False):
    """Next-token (or frame-label) cross entropy, as the reference computes
    it: f32 logits, the padded vocabulary tail masked to the lowest f32,
    ``logsumexp`` in f32, labels below 0 ignored; a VLM's loss over its
    text tail.  The label's logit is gathered, which gives the value of
    the reference's one-hot einsum.  ``aux_weight`` times the MoE layers'
    summed aux loss is added.

    Returns (loss, {"ce": ce, "aux": aux}).
    """
    with mesh_scope(ctx):
        return _loss(cfg, params, batch, ctx, remat, q_chunk, aux_weight,
                     plain)


def _ce_parts(cfg, logits, labels):
    """(the summed cross entropy of the labelled positions, their count):
    f32 logits, the padded tail masked, ``logsumexp`` in f32, the label's
    logit gathered."""
    lf = _mask_pad_logits(cfg, logits.float())
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def _ce_on_mesh(cfg, logits, labels, ctx):
    """``_ce_parts`` through ``local_map``: each rank's rows with the whole
    vocabulary (gathered over ``"model"``), the two sums partial over the
    DP axes the rows are sharded on."""
    from torch.distributed.tensor import DTensor

    bax = ctx.batch_axes(labels.shape[0])
    rows = ctx.mesh_placements({bax: 0})
    sums = ctx.mesh_placements(partial=ctx.dp_axes if bax else ())
    if not is_dtensor(labels):  # the same labels on every rank
        labels = DTensor.from_local(labels, ctx.mesh, ctx.mesh_placements(),
                                    run_check=False)
    return mesh_map(ctx.mesh, functools.partial(_ce_parts, cfg),
                    (logits, labels), (rows, rows), (sums, sums))


def _loss(cfg, params, batch, ctx, remat, q_chunk, aux_weight, plain):
    logits, aux = forward(cfg, params, batch, ctx, remat=remat,
                          q_chunk=q_chunk, plain=plain)
    labels = batch["labels"]  # (B, S_out) integer, -1 => ignore
    if logits.shape[1] != labels.shape[1]:  # vlm: the text tail only
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    if ctx.mesh is None:
        total, count = _ce_parts(cfg, logits, labels)
    else:
        total, count = _ce_on_mesh(cfg, logits, labels, ctx)
    ce = total / torch.clamp(count, min=1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def init_cache(cfg, batch: int, s_max: int, dtype=torch.float32,
               device=None):
    """Per-segment stacked decode caches: each layer's attention cache
    (``blocks.attn_cache_shape``: K and V, int8 ones with their scales, or
    MLA's latent) for attention segments (dense and MoE), zero Mamba states
    for SSM and hybrid segments, and a hybrid model's attention cache per
    shared-attention application under ``"shared_attn"``."""
    def stacked(one, count):
        return {k: torch.zeros((count,) + tuple(v.shape), dtype=v.dtype,
                               device=device) for k, v in one.items()}

    cache: Dict[str, Any] = {}
    for i, (kind, count) in enumerate(segments_of(cfg)):
        if kind in ("dense", "moe"):
            one = B.attn_cache_shape(cfg, batch, s_max, dtype, device="meta")
        else:
            one = B.mamba_state_shape(cfg, batch, dtype, device="meta")
        cache[f"seg{i}"] = stacked(one, count)
        if kind == "zamba":
            cache["shared_attn"] = stacked(
                B.attn_cache_shape(cfg, batch, s_max, dtype, device="meta"),
                _n_attn_apps(cfg))
    return cache


def prefill(cfg, params: Params, cache, batch, ctx: ShardCtx = NULL_CTX, *,
            q_chunk: int = 1024, plain: bool = False):
    """Run a full prompt; returns (last-token logits (B, V), cache).

    Attention segments write K/V of every prompt position into ``cache`` in
    place, a hybrid's shared-attention applications into theirs; Mamba
    segments leave their states untouched, as the reference's do, unless
    ``cfg.prefill_ssm_state``, under which each writes its final SSM and
    conv state.
    ``plain=True`` runs the attention's and the SSD scan's plain versions on
    every device (the on-card reference for the kernel path).  A VLM's
    prompt is its patch embeddings and then its tokens, so its decode
    starts at position ``frontend_seq`` plus the text tokens.  On a mesh
    the residual stream is pinned to batch over dp before each layer, as
    the reference pins it, and each rank writes its own shard of a
    sequence-sharded cache.
    """
    with mesh_scope(ctx):
        return _prefill(cfg, params, cache, batch, ctx, q_chunk, plain)


def _layers(cfg):
    """Every layer of the model in order: (segment index, kind, index in
    the segment)."""
    for i, (kind, count) in enumerate(segments_of(cfg)):
        for li in range(count):
            yield i, kind, li


def _put_state(lc, st) -> None:
    """A Mamba layer's new decode state into its cache in place (on a mesh
    in the cache's placements first)."""
    for k, t in st.items():
        if is_dtensor(t):
            t = t.redistribute(lc[k].device_mesh, lc[k].placements)
        lc[k].copy_(t)


def _prefill(cfg, params, cache, batch, ctx, q_chunk, plain):
    with region("model.prefill") as sp:
        x = embed_inputs(cfg, params, batch)
        sp.set(batch=x.shape[0], tokens=x.shape[1])
        x = ctx.constrain(x, ctx.dp, None, None)
        emb = x if cfg.hybrid_concat_embed else None
        for layer, (i, kind, li) in enumerate(_layers(cfg)):
            lp = _layer(params[f"seg{i}"], li)
            with region("model.layer", layer=layer, kind=kind):
                x = ctx.constrain(x, ctx.dp, None, None)
                if kind in ("dense", "moe"):
                    x, _ = B.block_prefill(lp, x, cfg,
                                           _layer(cache[f"seg{i}"], li), ctx,
                                           q_chunk=q_chunk, plain=plain)
                    continue
                at = _shared_at(cfg, li) if kind == "zamba" else None
                add = None
                if at is not None and cfg.hybrid_layer_ids:
                    add = B.hybrid_prefill(
                        _layer(params["shared_attn"], at[1]),
                        _layer(params["hybrid"], at[0]), x, emb, cfg,
                        _layer(cache["shared_attn"], at[0]), ctx,
                        q_chunk=q_chunk, plain=plain, use=at[0], block=at[1])
                elif at is not None:
                    x, _ = B.block_prefill(
                        _layer(params["shared_attn"], at[1]), x, cfg,
                        _layer(cache["shared_attn"], at[0]), ctx,
                        q_chunk=q_chunk, plain=plain)
                if cfg.prefill_ssm_state:
                    x, st = B.mamba_block_apply(lp, x, cfg, ctx, plain=plain,
                                                add=add, final_state=True)
                    _put_state(_layer(cache[f"seg{i}"], li), st)
                else:
                    x = B.mamba_block_apply(lp, x, cfg, ctx, plain=plain,
                                            add=add)
        return _head(cfg, params, x[:, -1:])[:, 0], dict(cache)


def decode_step(cfg, params: Params, cache, tokens, pos,
                ctx: ShardCtx = NULL_CTX):
    """One decode step.  tokens: (B, 1) integer; ``pos`` is the index of the
    token being generated (unused by SSM layers, as in the reference): an
    int, or off a mesh a 0-d int64 tensor on the step's device.

    Returns (logits (B, V), cache).  The cache is written in place:
    attention K/V at ``pos`` (a hybrid's per shared-attention
    application), Mamba states in full; the same tensors come back.  On a
    mesh the new Mamba states take their cache's placements first.

    On CUDA, off a mesh and with no forced routing, the step is captured
    as a CUDA graph on the second call with the same config, tokens' shape
    and parameter and cache tensors, and replayed from the third
    (``models.graph``: the same kernels, the same bits; the logits a fresh
    tensor each call).  The span ``model.decode_step`` says which
    (``graph``); under a replay no span opens inside it.
    """
    with mesh_scope(ctx):
        return DECODE.step(cfg, params, cache, tokens, pos, ctx), dict(cache)


def _decode_step(cfg, params, cache, tokens, pos, ctx):
    """The eager decode step: its logits, the cache written in place."""
    x = lookup(params["embed"], tokens)
    emb = x if cfg.hybrid_concat_embed else None
    for layer, (i, kind, li) in enumerate(_layers(cfg)):
        lp, lc = _layer(params[f"seg{i}"], li), _layer(cache[f"seg{i}"], li)
        with region("model.layer", layer=layer, kind=kind):
            if kind in ("dense", "moe"):
                x, _ = B.block_decode(lp, x, cfg, lc, pos, ctx)
                continue
            at = _shared_at(cfg, li) if kind == "zamba" else None
            add = None
            if at is not None and cfg.hybrid_layer_ids:
                add = B.hybrid_decode(
                    _layer(params["shared_attn"], at[1]),
                    _layer(params["hybrid"], at[0]), x, emb, cfg,
                    _layer(cache["shared_attn"], at[0]), pos, ctx,
                    use=at[0], block=at[1])
            elif at is not None:
                x, _ = B.block_decode(
                    _layer(params["shared_attn"], at[1]), x, cfg,
                    _layer(cache["shared_attn"], at[0]), pos, ctx)
            x, st = B.mamba_block_decode(lp, x, cfg, lc, add=add)
            _put_state(lc, st)
    return _head(cfg, params, x)[:, 0]


DECODE = DecodeGraphs(_decode_step)
