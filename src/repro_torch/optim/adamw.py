"""AdamW with global-norm clipping and a warmup + cosine schedule (the port
of ``repro.optim.adamw``).

The reference's f32 arithmetic, operation for operation: ``lr_at`` takes
the step as a tensor and works in f32, the bias corrections are
``b ** step`` in f32, and ``global_norm`` sums the leaves' squares in
``jax.tree`` order (dict keys sorted).  The update is functional, as the
reference's is: ``adamw_update`` returns new parameter and moment trees and
leaves its arguments alone, under ``torch.no_grad()``.  Moments are kept
in ``moment_dtype`` (f32 unless asked), the math in f32.

On a mesh the trees hold DTensors: parameters and gradients placed by
``distributed.sharding.param_specs``, moments by ``opt_state_specs``
(ZeRO: sharded further over "data").  The same code runs under DTensor's
rules, which meet the two placements leaf by leaf, and ``global_norm`` is
the norm of the whole gradient (each leaf's sum of squares reduced over
its shards), not a rank's share.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "lr_at"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moments may be stored bf16 (half the optimizer memory; the math stays
    # f32)
    moment_dtype: Any = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moment (tree like the params)
    nu: Any  # second moment


def init_opt_state(params, moment_dtype=torch.float32) -> OptState:
    """Zero moments shaped as ``params``, on their device, and step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                           device=p.device), params)
    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at ``step`` (a tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    ``jax.tree`` order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """Returns ``(new_params, new_state, metrics)``; the arguments are not
    written."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1t = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2t = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mhat = m2 / b1t
        vhat = v2 / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m2.to(m.dtype),
                v2.to(v.dtype))

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, OptState(step=step, mu=new_m, nu=new_v), {
        "grad_norm": gnorm, "lr": lr}
