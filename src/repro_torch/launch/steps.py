"""Step factories: train, prefill and decode steps on one device (the port
of ``repro.launch.steps``).

No ``jit``: each step runs eagerly.  The reference's ``mesh`` argument
attaches shardings at its ``jit`` boundary; the port does not shard yet,
so ``mesh`` must be ``None`` and ``jit_*_step`` wait with ``launch.specs``
for ROADMAP A.13.

``make_train_step``'s step differentiates ``models.loss_fn`` with
``torch.autograd.grad`` over parameter aliases that require grad (the
caller's parameters are plain tensors and are not written; a leaf the
loss does not read gets a zero gradient, as under ``jax.grad``), then
applies ``optim.adamw_update``.  ``n_micro > 1`` splits the batch on dim 0 and
accumulates f32 gradients divided by ``n_micro``, and the loss likewise,
in the reference's order; the metrics' ``ce`` and ``aux`` are the last
microbatch's, as the reference's scan leaves them.
"""

from __future__ import annotations

import torch

from ..models import decode_step, loss_fn, prefill
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import leaves, tree_map, unflatten

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step"]


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port runs on one device; meshes and shardings come with "
            "ROADMAP A.13")


def make_train_step(cfg, mesh=None, *, opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: str = "full", q_chunk: int = 1024,
                    aux_weight: float = 0.01, n_micro: int = 1):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``.

    ``batch`` is a dict of tensors on the parameters' device.

    Raises:
        NotImplementedError: ``mesh`` is not ``None`` (ROADMAP A.13).
    """
    _single_device(mesh)

    def one_loss(params, mb):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, parts = loss_fn(cfg, live, mb, remat=remat, q_chunk=q_chunk,
                              aux_weight=aux_weight)
        flat = leaves(live)
        # a leaf the loss never reads (an audio model's ``embed``) gets a
        # zero gradient, as ``jax.grad`` gives it
        grads = [torch.zeros_like(t) if g is None else g for t, g in
                 zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                unflatten(params, grads))

    def train_step(params, opt, batch):
        if n_micro == 1:
            loss, parts, grads = one_loss(params, batch)
        else:
            bb = next(iter(batch.values())).shape[0] // n_micro
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(n_micro):
                mb = {k: v[i * bb:(i + 1) * bb] for k, v in batch.items()}
                mloss, parts, mgrads = one_loss(params, mb)
                grads = tree_map(lambda a, g: a + g.float() / n_micro, grads,
                                 mgrads)
                loss = loss + mloss / n_micro
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads, opt)
        return new_params, new_opt, {"loss": loss, **parts, **om}

    return train_step


def make_prefill_step(cfg, mesh=None, *, q_chunk: int = 1024,
                      n_micro: int = 1):
    """``prefill_step(params, cache, batch) -> (logits, cache)``.

    ``n_micro > 1`` is chunked prefill: the prompt batch split on dim 0,
    each part into a fresh zero cache, the caches joined on their batch dim
    (dim 1 of the stacked caches).

    Raises:
        NotImplementedError: ``mesh`` is not ``None`` (ROADMAP A.13).
    """
    _single_device(mesh)

    def one(params, cache, batch):
        return prefill(cfg, params, cache, batch, q_chunk=q_chunk)

    def prefill_step(params, cache, batch):
        if n_micro == 1:
            return one(params, cache, batch)
        bb = next(iter(batch.values())).shape[0] // n_micro
        outs = []
        for i in range(n_micro):
            mb = {k: v[i * bb:(i + 1) * bb] for k, v in batch.items()}
            sub = tree_map(lambda a: a.new_zeros(
                (a.shape[0], a.shape[1] // n_micro) + tuple(a.shape[2:])),
                cache)
            outs.append(one(params, sub, mb))
        logits = torch.cat([o[0] for o in outs], dim=0)
        new_cache = tree_map(lambda *cs: torch.cat(cs, dim=1),
                             *[o[1] for o in outs])
        return logits, new_cache

    return prefill_step


def make_decode_step(cfg, mesh=None):
    """``step(params, cache, tokens, pos) -> (logits, cache)``; the cache is
    written in place (``models.model``).

    Raises:
        NotImplementedError: ``mesh`` is not ``None`` (ROADMAP A.13).
    """
    _single_device(mesh)

    def step(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)

    return step
