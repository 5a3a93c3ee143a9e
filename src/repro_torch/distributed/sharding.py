"""Sharding rules: logical parameter, optimizer, batch and cache layouts on
mesh axes (the port of ``repro.distributed.sharding``).

Scheme, as the reference's:
  * batch/tokens sharded over the DP axes ("pod", "data");
  * TP over "model": attention by heads (replicating KV projections when
    kv_heads does not divide the axis), MLP by d_ff, vocab by "model";
  * FSDP: the non-TP matrix dim of each weight sharded over "data";
  * ZeRO: optimizer moments additionally sharded over "data" on the largest
    still-replicated dim;
  * decode KV caches sharded over "model" on the *sequence* axis
    (flash-decoding style) and over DP on batch when divisible.

The rules walk the port's trees with ``tree.leaves_with_paths``, whose paths
spell the reference's ("seg0/attn/wq", ...), and return a tree of ``Spec``:
one entry per tensor dim, each ``None``, an axis name or a tuple of names
(the reference's ``PartitionSpec``).  ``MeshAxes`` takes a
``torch.distributed.device_mesh.DeviceMesh`` or a plain ``(shape, names)``
descriptor, so the rules run without a process group; ``placements`` turns
a spec into the DTensor placements of a mesh, ``place`` puts a tree on a
mesh by its specs, ``whole`` takes a DTensor's full value back, and
``mesh_map`` runs a function on each rank's local shards (``local_map``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from ..tree import leaves_with_paths, tree_map, unflatten

__all__ = [
    "MeshAxes",
    "Spec",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "param_specs",
    "is_dtensor",
    "mesh_map",
    "place",
    "placements",
    "shard_span",
    "whole",
]


class Spec(tuple):
    """Per-dimension sharding of one tensor: each entry ``None``
    (replicated), a mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


class MeshAxes:
    """Axis-name bundle; dp includes 'pod' when present in the mesh.

    ``mesh`` is a ``DeviceMesh`` (its ``mesh_dim_names`` and shape) or a
    ``(shape, names)`` pair.
    """

    def __init__(self, mesh):
        if isinstance(mesh, tuple) and len(mesh) == 2:
            shape, names = mesh
            self.mesh = None
        else:
            shape, names = tuple(mesh.shape), mesh.mesh_dim_names
            self.mesh = mesh
        if names is None or len(names) != len(shape):
            raise ValueError(f"a mesh needs one name per dim, got {names} "
                             f"for shape {tuple(shape)}")
        self.names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.names,
                                              (int(n) for n in shape)))
        self.tp = "model" if "model" in self.names else None
        self.dp: Tuple[str, ...] = tuple(a for a in ("pod", "data")
                                         if a in self.names)
        self.dp_size = math.prod(self.shape[a] for a in self.dp)
        self.tp_size = self.shape[self.tp] if self.tp else 1

    def dp_spec(self):
        return self.dp if len(self.dp) > 1 else (self.dp[0] if self.dp
                                                 else None)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


# ------------------------------------------------------------- parameter rules
def _leaf_spec(path: str, shape, ax: MeshAxes, cfg) -> Spec:
    """Spec for one parameter leaf, identified by its tree path.  The
    branches run in the reference's order: the first suffix that matches
    decides (``"attn"`` before ``"gate"``/``"up"``)."""
    tp, dp = ax.tp, ax.dp_spec()
    r = len(shape)
    stacked = path.startswith("seg") and r >= 2  # leading layer dim
    L = (None,) if stacked else ()
    s = shape[1:] if stacked else shape

    def fsdp(dim_size):
        if not getattr(cfg, "weights_fsdp", True):
            return None
        return dp if _div(dim_size, ax.dp_size) else None

    def tpd(dim_size):
        return tp if _div(dim_size, ax.tp_size) else None

    if "embed" in path or path.endswith("head"):
        # (V, D) or (D, V): vocab over tp, other dim over dp
        big = max(range(len(s)), key=lambda i: (s[i], -i))
        spec = [None, None]
        spec[big] = tpd(s[big])
        spec[1 - big] = fsdp(s[1 - big])
        return Spec(*spec)

    # Attention (flat projections: plain matrix rules)
    if "attn" in path:
        if path.endswith(("wq", "wk", "wv")):  # (D, H*Dh)
            return Spec(*L, fsdp(s[0]), tpd(s[1]))
        if path.endswith("wo"):  # (H*Dh, D)
            return Spec(*L, tpd(s[0]), fsdp(s[1]))
        if path.endswith(("bq", "bk", "bv")):  # (H*Dh,)
            return Spec(*L, tpd(s[0]))
        if path.endswith("wkv_a"):  # (D, lora+rope)
            return Spec(*L, fsdp(s[0]), None)
        if path.endswith("wkv_b"):  # (lora, H*(nope+v))
            return Spec(*L, None, tpd(s[1]))
    # MLP
    if path.endswith(("gate", "up")):  # (D, F)
        return Spec(*L, fsdp(s[0]), tpd(s[1]))
    if path.endswith("down"):  # (F, D)
        return Spec(*L, tpd(s[0]), fsdp(s[1]))
    # MoE
    if path.endswith("router"):
        return Spec(*L, None, None)
    if path.endswith(("wg", "wu", "wd")):  # (E, D, F) / (E, F, D)
        return Spec(*L, tpd(s[0]), None, None)
    # Mamba (fused): in_proj boundaries do not align with shards -> FSDP only
    if path.endswith("in_proj"):  # (D, 2di+2n+h)
        return Spec(*L, fsdp(s[0]), None)
    # Mamba (split projections): inner/head dims shard over TP
    if path.endswith(("wz", "wx")):  # (D, di)
        return Spec(*L, fsdp(s[0]), tpd(s[1]))
    if path.endswith("wdt"):  # (D, H)
        return Spec(*L, fsdp(s[0]), tpd(s[1]))
    if path.endswith(("wb", "wc")):  # (D, N) tiny
        return Spec(*L, fsdp(s[0]), None)
    if path.endswith("conv_wx"):  # (K, di)
        return Spec(*L, None, tpd(s[1]))
    if path.endswith("conv_bx"):  # (di,)
        return Spec(*L, tpd(s[0]))
    if path.endswith("out_proj"):  # (di, D)
        if getattr(cfg, "ssm_split_proj", False):
            return Spec(*L, tpd(s[0]), fsdp(s[1]))
        return Spec(*L, None, fsdp(s[1]))
    # conv_w, conv_b, conv_wbc, conv_bbc, A_log, D, dt_bias, norms and
    # everything else: replicated (tiny)
    return Spec(*L, *([None] * len(s)))


def _map_paths(fn, tree):
    """``fn(path, shape)`` over a tree of tensors (or anything with a
    ``shape``), in ``jax.tree`` order, rebuilt in ``tree``'s structure."""
    return unflatten(tree, [fn(p, tuple(leaf.shape))
                            for p, leaf in leaves_with_paths(tree)])


def param_specs(params_shape, ax: MeshAxes, cfg):
    """Tree of ``Spec`` matching a params tree (of tensors, meta tensors or
    anything with a ``shape``)."""
    return _map_paths(lambda p, s: _leaf_spec(p, s, ax, cfg), params_shape)


def opt_state_specs(params_shape, ax: MeshAxes, cfg):
    """ZeRO: moments take the param spec, then shard the largest
    still-replicated dim over dp (if divisible)."""

    def zero(path, shape):
        spec = _leaf_spec(path, shape, ax, cfg)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        # an axis may appear at most once per spec: skip leaves already
        # dp-sharded by the FSDP rule
        used = set()
        for e in entries:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    used.add(a)
        if any(a in used for a in ax.dp):
            return Spec(*entries)
        # skip the leading stacked-layer dim (index 0) when searching
        best, best_dim = -1, -1
        start = 1 if path.startswith("seg") and len(shape) >= 2 else 0
        for i in range(start, len(shape)):
            if entries[i] is None and _div(shape[i], ax.dp_size):
                if shape[i] > best:
                    best, best_dim = shape[i], i
        if best_dim >= 0 and ax.dp:
            entries[best_dim] = ax.dp_spec()
        return Spec(*entries)

    return _map_paths(zero, params_shape)


# ------------------------------------------------------------ batch/activation
def batch_specs(cfg, ax: MeshAxes, batch_shape):
    """Input batch: leading (global batch) dim over dp when divisible."""

    def spec(_, shape):
        first = ax.dp_spec() if _div(shape[0], ax.dp_size) else None
        return Spec(first, *([None] * (len(shape) - 1)))

    return _map_paths(spec, batch_shape)


# ------------------------------------------------------------------ decode kv
def cache_specs(cache_shape, ax: MeshAxes, cfg):
    """Stacked caches: (count, B, S, ...) KV -> batch over dp, seq over tp
    (sequence-sharded decode); mamba states -> batch over dp, heads over
    tp."""

    def spec(p, s):
        dp, tp = ax.dp_spec(), ax.tp
        bdim = dp if len(s) > 1 and _div(s[1], ax.dp_size) else None
        tdim = tp if len(s) > 2 and _div(s[2], ax.tp_size) else None
        if p.endswith(("k_scale", "v_scale")) and len(s) == 4:  # (L,B,S,KH)
            return Spec(None, bdim, tdim, None)
        if p.endswith(("k", "v")) and len(s) == 5:  # (L, B, S, KH, Dh)
            return Spec(None, bdim, tdim, None, None)
        if p.endswith(("ckv", "krope")) and len(s) == 4:  # (L, B, S, dim)
            return Spec(None, bdim, tdim, None)
        if p.endswith("h") and len(s) == 5:  # (L, B, H, P, N) f32 ssm state
            return Spec(None, bdim, tdim, None, None)
        if p.endswith("conv") and len(s) == 4:  # (L, B, K-1, C)
            return Spec(None, bdim, None, None)
        return Spec(*([None] * len(s)))

    return _map_paths(spec, cache_shape)


# ------------------------------------------------------------------ placements
def placements(spec, mesh) -> tuple:
    """The DTensor placements (one per mesh dim) of ``spec`` on ``mesh``
    (a ``DeviceMesh``): ``Shard(d)`` on each mesh dim named by the entry
    of tensor dim ``d``, ``Replicate()`` elsewhere.  A tuple entry
    ``("pod", "data")`` shards its dim over both mesh dims, the first name
    major, which is DTensor's order when the names follow the mesh's.

    Raises:
        ValueError: an axis the mesh lacks, an axis named twice, or a tuple
            entry whose names are not in the mesh's order.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in group:
            if a not in names or a in seen:
                raise ValueError(f"spec {spec} names axis {a!r} on mesh "
                                 f"{names}")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {group} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_span(t, dim: int):
    """[lo, hi): the indices of ``dim`` that this rank's shard of the
    DTensor ``t`` holds: DTensor's chunking (chunks of the ceiling size,
    the mesh dims in order) in plain integers, so it needs no tensor op
    and runs on fake tensors too."""
    coord = t.device_mesh.get_coordinate()
    lo, size = 0, t.shape[dim]
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            full = -(-size // t.device_mesh.size(i))
            start = min(coord[i] * full, size)
            lo, size = lo + start, min(full, size - start)
    return lo, lo + size


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def whole(t):
    """A DTensor's full value as a plain tensor (a collective every rank
    of its mesh takes part in); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def place(tree, specs, mesh):
    """Each leaf of ``tree`` on ``mesh`` as its spec in ``specs`` says: a
    DTensor already so placed as it is, another DTensor redistributed, a
    plain tensor (the same on every rank) cut to this rank's shard without
    communication."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        pl = placements(spec, mesh)
        if is_dtensor(t):
            if t.device_mesh is mesh and tuple(t.placements) == pl:
                return t
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return tree_map(one, tree, specs)


def mesh_map(mesh, fn, args, ins, outs, grads=None):
    """``fn`` on each rank's local shards of ``args`` (DTensors
    redistributed to the placements ``ins``; their gradients arrive as
    ``grads``, by default as ``ins``), its outputs placed as ``outs`` (a
    tuple with one entry per output): ``local_map``."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
