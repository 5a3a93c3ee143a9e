"""Sharding on ``torch.distributed`` meshes (the port of
``repro.distributed``): the layout rules, elastic resharding and the
collective-traffic record."""

from .collectives import Collective, collective_bytes, record_collectives
from .elastic import choose_mesh_shape, reshard_state
from .sharding import (MeshAxes, Spec, batch_specs, cache_specs, is_dtensor,
                       mesh_map, opt_state_specs, param_specs, place,
                       placements, whole)

__all__ = ["Collective", "MeshAxes", "Spec", "batch_specs", "cache_specs",
           "choose_mesh_shape", "collective_bytes", "is_dtensor", "mesh_map",
           "opt_state_specs", "param_specs", "place", "placements",
           "record_collectives", "reshard_state", "whole"]
