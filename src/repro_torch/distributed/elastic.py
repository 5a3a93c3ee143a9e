"""Elastic rescale: re-derive placements for a changed device set and
reshard a state (the port of ``repro.distributed.elastic``).

Checkpoints are logical (full arrays, ``checkpoint.save`` gathers a
DTensor's whole value), so scaling from mesh (d1, m1) to (d2, m2) is: load
-> rebuild specs for the new mesh -> place each leaf by them.  Failure
handling in ``launch.train`` uses this to resume on the mesh it is given.
"""

from __future__ import annotations

from typing import Optional

from ..tree import tree_map
from .sharding import (MeshAxes, is_dtensor, opt_state_specs, param_specs,
                       place, whole)

__all__ = ["choose_mesh_shape", "reshard_state"]


def choose_mesh_shape(n_devices: int, *, model_axis: Optional[int] = None):
    """Largest (data, model) grid for the healthy device count.

    Keeps the model axis if it still divides; otherwise picks the biggest
    power-of-two model axis that fits (TP must divide attention/ffn dims).
    """
    if model_axis and n_devices % model_axis == 0:
        return (n_devices // model_axis, model_axis)
    m = 1
    while m * 2 <= n_devices and (n_devices % (m * 2) == 0) and m * 2 <= 16:
        m *= 2
    return (n_devices // m, m)


def reshard_state(cfg, mesh, params, opt_state=None):
    """``params`` (and the optimizer state) placed on ``mesh`` by the
    sharding rules: DTensors of another mesh's placements redistributed
    (the same mesh) or gathered and cut again (another mesh), plain
    tensors cut to each rank's shard.  ``mesh=None`` gathers every leaf to
    a plain tensor.  Returns ``params``, or ``(params, opt_state)``."""
    from ..optim.adamw import OptState

    def onto(tree, specs):
        if mesh is None:
            return tree_map(whole, tree)
        tree = tree_map(lambda t: t if is_dtensor(t) and t.device_mesh is mesh
                        else whole(t), tree)
        return place(tree, specs, mesh)

    ax = None if mesh is None else MeshAxes(mesh)
    params = onto(params, None if ax is None else
                  param_specs(params, ax, cfg))
    if opt_state is None:
        return params
    ospec = None if ax is None else opt_state_specs(opt_state.mu, ax, cfg)
    opt = OptState(step=onto(opt_state.step, ()),
                   mu=onto(opt_state.mu, ospec), nu=onto(opt_state.nu, ospec))
    return params, opt
