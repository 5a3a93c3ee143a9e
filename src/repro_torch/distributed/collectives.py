"""Collective traffic of a sharded step (the port's counterpart of
``repro.distributed.hlo_analysis``).

The reference parses compiled HLO for its collectives; eager PyTorch has no
HLO, so ``record_collectives`` records the collectives a block of code
issues instead: a ``TorchDispatchMode`` over the ``_c10d_functional`` ops
that DTensor's redistributions and ``local_map`` regions go through (an op
on DTensors is handed on to DTensor, so the collectives DTensor issues
inside it, where an operand must be redistributed, reach the mode too), each
kept as ``(kind, shape, dtype, axis)``: the HLO kind (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``; ``broadcast``, which
HLO has no kind for, under its own name), the op's *output* shape on this
rank, the dtype in HLO's spelling (``f32``, ``bf16``, ...) and the mesh
axis (or axes) of its process group.  ``collective_bytes`` prices the
records with the reference's ring factors and dtype bytes: per-rank sums,
as the reference's per-device program gives.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["DTYPE_BYTES", "Collective", "collective_bytes",
           "collectives_of", "record_collectives"]

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_FACTOR = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# _c10d_functional op -> HLO kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


class Collective(NamedTuple):
    kind: str
    shape: tuple
    dtype: str
    axis: Optional[object]  # mesh axis name, tuple of names, or None


def collective_bytes(records) -> Dict[str, object]:
    """Sum collective output bytes per kind, and the ring model's per-rank
    traffic, over ``records`` (``Collective``s or ``(kind, shape, dtype)``
    tuples), under the reference's keys."""
    by_kind: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    ici = 0.0
    for rec in records:
        kind, shape, dtype = rec[0], rec[1], rec[2]
        b = math.prod(shape) * DTYPE_BYTES[dtype]
        by_kind[kind] += b
        counts[kind] += 1
        ici += b * _FACTOR[kind]
    return {
        "ici_bytes": ici,
        "bytes_by_kind": dict(by_kind),
        "counts": dict(counts),
        "total_output_bytes": float(sum(by_kind.values())),
    }


def _axis_of(mesh, group_name: str):
    """The mesh axis (or axes) whose process group is ``group_name``."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    for i, a in enumerate(names):
        if mesh.get_group(i).group_name == group_name:
            return a
    return tuple(names)


def collectives_of(func, args, kwargs, result, mesh=None) -> list:
    """The ``Collective``s of one dispatched op (none unless it is a
    ``_c10d_functional`` collective), for a dispatch mode that has run it
    (``record_collectives``'s, ``launch.dryrun``'s tracker)."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return []
    kind = _KINDS.get(func._opname)
    if kind is None:
        return []
    group = kwargs.get("group_name", args[-1])
    outs = result if isinstance(result, (list, tuple)) else [result]
    return [Collective(kind, tuple(t.shape), _HLO_DTYPE[t.dtype],
                       _axis_of(mesh, group)) for t in outs]


@contextlib.contextmanager
def record_collectives(mesh=None):
    """Record the collectives issued inside the block into the yielded
    list of ``Collective`` (each with the axis of ``mesh`` its group
    spans, when a mesh is given)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    out: List[Collective] = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # let DTensor run first: the collectives it issues while it
                # redistributes an operand, and the local ops below it,
                # then dispatch with this mode still on the stack
                return NotImplemented
            kwargs = kwargs or {}
            result = func(*args, **kwargs)
            out.extend(collectives_of(func, args, kwargs, result, mesh))
            return result

    with _Recorder():
        yield out
