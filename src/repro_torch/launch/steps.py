"""Step factories: train, prefill and decode steps, on one device or on a
mesh (the port of ``repro.launch.steps``).

No ``jit`` and no donation: each step runs eagerly.  ``make_*_step(cfg,
mesh)`` run the model with ``make_ctx(mesh)``; on a mesh their arguments
are DTensors.  ``jit_train_step``, ``jit_prefill_step`` and
``jit_decode_step`` keep the reference's names and signatures: the step
they return places parameters, optimizer state, batch, cache and tokens
on the mesh by the sharding rules (``param_specs``; ``opt_state_specs``
for the ZeRO moments; ``batch_specs``; ``cache_specs`` for the
sequence-sharded KV cache), where the reference's ``jit`` takes
``in_shardings``, and hands its outputs back in the same placements (the
logits' batch over the DP axes, the metrics as plain tensors).  A plain
tensor argument is taken to hold the same values on every rank; each rank
keeps its own shard of it.  Prefill and decode run under
``torch.no_grad()`` (DTensor does not take ``torch.inference_mode``).

``make_train_step``'s step differentiates ``models.loss_fn`` with
``torch.autograd.grad`` over parameter aliases that require grad (the
caller's parameters are not written; a leaf the loss does not read gets a
zero gradient, as under ``jax.grad``), takes each gradient to its
parameter's placements (a reduce-scatter where it arrives partial), then
applies ``optim.adamw_update``.  ``n_micro > 1`` splits the batch on dim 0
and accumulates f32 gradients divided by ``n_micro``, and the loss
likewise, in the reference's order; the metrics' ``ce`` and ``aux`` are the
last microbatch's, as the reference's scan leaves them.  On a mesh a
microbatch is the same global rows as off it, placed again by
``batch_specs``.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import (MeshAxes, batch_specs, cache_specs,
                                    opt_state_specs, param_specs, place,
                                    whole)
from ..models import decode_step, loss_fn, prefill
from ..models.layers import NULL_CTX, ShardCtx, mesh_scope
from ..optim.adamw import AdamWConfig, OptState, adamw_update
from ..tree import leaves, tree_map, unflatten

__all__ = ["jit_decode_step", "jit_prefill_step", "jit_train_step",
           "make_ctx", "make_decode_step", "make_prefill_step",
           "make_train_step"]


def make_ctx(mesh) -> ShardCtx:
    if mesh is None:
        return NULL_CTX
    ax = MeshAxes(mesh)
    return ShardCtx(mesh=mesh, dp_axes=ax.dp, tp_axis=ax.tp)


def _microbatch(batch, i: int, bb: int, ctx: ShardCtx, cfg):
    """Rows [i * bb, (i + 1) * bb) of every batch entry, placed again by
    ``batch_specs`` on a mesh."""
    if ctx.mesh is None:
        return {k: v[i * bb:(i + 1) * bb] for k, v in batch.items()}
    mb = {k: whole(v)[i * bb:(i + 1) * bb] for k, v in batch.items()}
    return place(mb, batch_specs(cfg, MeshAxes(ctx.mesh), mb), ctx.mesh)


def make_train_step(cfg, mesh=None, *, opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: str = "full", q_chunk: int = 1024,
                    aux_weight: float = 0.01, n_micro: int = 1):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``.

    ``batch`` is a dict of tensors on the parameters' device (DTensors on
    the mesh, when there is one).
    """
    ctx = make_ctx(mesh)

    def one_loss(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, parts = loss_fn(cfg, live, mb, ctx, remat=remat,
                              q_chunk=q_chunk, aux_weight=aux_weight)
        flat = leaves(live)
        # a leaf the loss never reads (an audio model's ``embed``) gets a
        # zero gradient, as ``jax.grad`` gives it
        grads = [torch.zeros_like(t) if g is None else g for t, g in
                 zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))]
        if ctx.mesh is not None:
            grads = [g.redistribute(t.device_mesh, t.placements)
                     for t, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                unflatten(params, grads))

    def train_step(params, opt, batch):
        if n_micro == 1:
            loss, parts, grads = one_loss(params, batch)
        else:
            bb = next(iter(batch.values())).shape[0] // n_micro
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(n_micro):
                mloss, parts, mgrads = one_loss(
                    params, _microbatch(batch, i, bb, ctx, cfg))
                grads = tree_map(lambda a, g: a + g.float() / n_micro, grads,
                                 mgrads)
                loss = loss + mloss / n_micro
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads, opt)
        return new_params, new_opt, {"loss": loss, **parts, **om}

    def step(params, opt, batch):
        with mesh_scope(ctx):
            return train_step(params, opt, batch)

    return step


def make_prefill_step(cfg, mesh=None, *, q_chunk: int = 1024,
                      n_micro: int = 1):
    """``prefill_step(params, cache, batch) -> (logits, cache)``.

    ``n_micro > 1`` is chunked prefill: the prompt batch split on dim 0,
    each part into a fresh zero cache, the caches joined on their batch dim
    (dim 1 of the stacked caches).
    """
    ctx = make_ctx(mesh)

    def one(params, cache, batch):
        return prefill(cfg, params, cache, batch, ctx, q_chunk=q_chunk)

    def prefill_step(params, cache, batch):
        if n_micro == 1:
            return one(params, cache, batch)
        bb = next(iter(batch.values())).shape[0] // n_micro
        outs = []
        for i in range(n_micro):
            mb = _microbatch(batch, i, bb, ctx, cfg)
            sub = tree_map(lambda a: a.new_zeros(
                (a.shape[0], a.shape[1] // n_micro) + tuple(a.shape[2:])),
                cache)
            outs.append(one(params, sub, mb))
        logits = torch.cat([o[0] for o in outs], dim=0)
        new_cache = tree_map(lambda *cs: torch.cat(cs, dim=1),
                             *[o[1] for o in outs])
        return logits, new_cache

    def step(params, cache, batch):
        with mesh_scope(ctx):
            return prefill_step(params, cache, batch)

    return step


def make_decode_step(cfg, mesh=None):
    """``step(params, cache, tokens, pos) -> (logits, cache)``; the cache is
    written in place (``models.model``)."""
    ctx = make_ctx(mesh)

    def step(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos, ctx)

    return step


# ------------------------------------------------------------ mesh bundling
def _logits_out(logits, ax: MeshAxes, mesh):
    """The logits with their batch over the DP axes (when it divides)."""
    return place({"logits": logits},
                 batch_specs(None, ax, {"logits": logits}), mesh)["logits"]


def jit_train_step(cfg, mesh, p_shape, o_shape, b_shape, **kw):
    """``step(params, opt, batch) -> (params, opt, metrics)`` with the
    FSDP/TP/ZeRO placements: parameters by ``param_specs``, moments by
    ``opt_state_specs``, the step count replicated, the batch by
    ``batch_specs``; parameters and moments come back in the same
    placements, the metrics as plain tensors."""
    ax = MeshAxes(mesh)
    ps = param_specs(p_shape, ax, cfg)
    os_ = opt_state_specs(p_shape, ax, cfg)
    o_specs = OptState(step=(), mu=os_, nu=os_)
    bs = batch_specs(cfg, ax, b_shape)
    fn = make_train_step(cfg, mesh, **kw)

    def step(params, opt, batch):
        params = place(params, ps, mesh)
        opt = place(opt, o_specs, mesh)
        new_p, new_o, metrics = fn(params, opt, place(batch, bs, mesh))
        return (place(new_p, ps, mesh), place(new_o, o_specs, mesh),
                {k: whole(v) for k, v in metrics.items()})

    return step


def jit_prefill_step(cfg, mesh, p_shape, c_shape, b_shape, **kw):
    """``step(params, cache, batch) -> (logits, cache)`` with parameters by
    ``param_specs``, the cache by ``cache_specs`` (sequence-sharded over
    ``"model"``) and the batch by ``batch_specs``."""
    ax = MeshAxes(mesh)
    ps = param_specs(p_shape, ax, cfg)
    cs = cache_specs(c_shape, ax, cfg)
    bs = batch_specs(cfg, ax, b_shape)
    fn = make_prefill_step(cfg, mesh, **kw)

    @torch.no_grad()
    def step(params, cache, batch):
        logits, cache = fn(place(params, ps, mesh), place(cache, cs, mesh),
                           place(batch, bs, mesh))
        return _logits_out(logits, ax, mesh), place(cache, cs, mesh)

    return step


def jit_decode_step(cfg, mesh, p_shape, c_shape, batch: int, **kw):
    """``step(params, cache, tokens, pos) -> (logits, cache)`` with
    parameters by ``param_specs``, the cache by ``cache_specs`` and the
    tokens' batch over the DP axes when ``batch`` divides them."""
    ax = MeshAxes(mesh)
    ps = param_specs(p_shape, ax, cfg)
    cs = cache_specs(c_shape, ax, cfg)
    tok = batch_specs(cfg, ax, {"tokens": torch.empty((batch, 1),
                                                      device="meta")})
    fn = make_decode_step(cfg, mesh, **kw)

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        tokens = place({"tokens": tokens}, tok, mesh)["tokens"]
        logits, cache = fn(place(params, ps, mesh), place(cache, cs, mesh),
                           tokens, pos)
        return _logits_out(logits, ax, mesh), place(cache, cs, mesh)

    return step
