"""Model layers in PyTorch: the attention, gated-MLP, MoE and Mamba2 parts
of ``repro.models.layers``.

Pure functions over dictionaries of tensors, with the reference's names,
parameter layout (the fused ``in_proj``, flat attention projections) and
precision policy: parameters and activations in the model dtype; norms,
softmax and SSD recurrences in f32.  The two full-sequence mixers launch
hand-written kernels on CUDA tensors and run their plain versions on CPU
tensors: ``attention`` through ``kernels.flash_attention.flash_attention``
and ``mamba_apply`` through ``kernels.ssd.ops.ssd``; ``plain=True`` takes
the plain version on every device (the on-card reference).
``decode_attention`` and ``mamba_decode_step`` are plain PyTorch: the
one-token steps have no kernel in the reference either.

The MoE feed-forward (``moe_init``, ``moe_local``, ``moe_apply``) is the
reference's token-choice routing with per-expert capacity: the experts
are batched products over the stacked weights, as in the reference, and no
kernel is involved.  Both of its selections take the
reference's ``lax.top_k`` order (the larger value first, the lower index
first among equal values) through a stable descending sort, and each
token sums its experts' contributions in increasing expert index, the
order of the reference's scatter-add, so a call gives the same bits on
every run.  ``recording(RoutingLog())`` keeps each call's routing (off by
default), a log made with ``force=`` replays another run's routing
(``RoutingLog``), and ``same_routing`` and ``routing_flips`` compare two
logs (a flip between two f32 orders must be a near-tie).

**On a mesh** (``ctx = ShardCtx(mesh=...)``, ``launch.steps.make_ctx``) the
layers take DTensors placed by ``distributed.sharding`` and leave what the
reference leaves to GSPMD to DTensor's own rules; ``ctx.constrain`` is the
reference's sharding hint, a ``redistribute``.  What the reference writes
as ``shard_map``, and the two kernels, run through ``local_map`` on each
rank's local shard: the MoE experts over ``"model"`` and tokens over the
DP axes (its output all-reduced over ``"model"``, its load fractions
averaged over every axis before the aux product), the flash kernel on the
rank's query heads (with the KV heads of its own head range when KV is
replicated) and the SSD kernel on the rank's SSM heads.  The reference
shards the SSD's chunk dimension as a hint; the port shards the kernel by
heads instead, which gives the same numbers since every head is
independent.  A kernel wrapper handed a DTensor raises
(``kernels.runtime.require_local``).  The split-projection Mamba layout
(``ssm_split_proj``: ``wz/wx/wb/wc/wdt`` and split convolutions) computes
what the fused ``in_proj`` does with its inner and head dims sharded over
``"model"``; ``models.convert`` maps one layout onto the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import (Spec, is_dtensor, mesh_map, placements,
                                    shard_span)
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_plain
from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_scan_plain
from ..obs.trace import region

__all__ = ["NULL_CTX", "Routing", "RoutingLog", "ShardCtx", "apply_rope",
           "attention", "causal_conv1d", "decode_attention", "dense_init",
           "embed_init", "gated_norm", "grad_as_forward", "mamba_apply",
           "mamba_decode_step", "mamba_init", "mesh_scope", "mlp_apply",
           "mlp_init", "moe_apply", "moe_capacity", "moe_init", "moe_local",
           "recording", "rms_norm", "rope_freqs", "routing_flips",
           "same_routing", "seq_sharded_attention", "split_heads"]


# ----------------------------------------------------------------- shard hooks


class ShardCtx(NamedTuple):
    """Sharding context threaded through model code.

    mesh=None => one device; otherwise a ``DeviceMesh`` whose ``dp_axes``
    and ``tp_axis`` are logical mesh axis names, used by the ``local_map``
    regions (MoE, kernels) and by ``constrain`` hints.
    """

    mesh: Optional[object] = None
    dp_axes: tuple = ("data",)
    tp_axis: str = "model"

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def size(self, axes) -> int:
        """Devices along one axis name or a tuple of names."""
        names = axes if isinstance(axes, tuple) else (axes,)
        return math.prod(self.mesh.size(self.mesh.mesh_dim_names.index(a))
                         for a in names)

    def constrain(self, x, *spec_entries):
        """``x`` redistributed to the spec when a mesh is present, else
        ``x``.

        Uneven sharding is allowed for intermediates, but axes larger than
        the dim itself (e.g. batch=1 over dp=16) are dropped, as the
        reference drops them.
        """
        if self.mesh is None:
            return x
        clean = [None if e is not None and dim < self.size(e) else e
                 for dim, e in zip(x.shape, spec_entries)]
        return x.redistribute(self.mesh, placements(Spec(*clean), self.mesh))

    def mesh_placements(self, shard=None, partial=()) -> tuple:
        """``placements`` of the spec that puts each key of ``shard`` (an
        axis name, or a tuple of names, major first) on its tensor dim,
        with ``Partial()`` on each still-replicated axis in ``partial``."""
        from torch.distributed.tensor import Partial, Replicate

        shard = shard or {}
        entries = [None] * (max(shard.values(), default=-1) + 1)
        for axes, d in shard.items():
            entries[d] = axes
        return tuple(
            Partial() if isinstance(pl, Replicate) and a in partial else pl
            for a, pl in zip(self.mesh.mesh_dim_names,
                             placements(Spec(*entries), self.mesh)))

    def batch_axes(self, b: int):
        """The DP axes a batch of ``b`` shards over ((): replicated), as
        ``batch_specs`` decides."""
        return self.dp if b % self.size(self.dp_axes) == 0 else ()


NULL_CTX = ShardCtx()


# Open ``mesh_scope`` blocks (the outermost one enters DTensor's implicit
# replication).
_SCOPES = 0


@contextlib.contextmanager
def mesh_scope(ctx: ShardCtx):
    """On a mesh, let the model's own plain tensors (positions, masks,
    constants: the same on every rank) meet DTensors as replicated ones
    (DTensor's ``implicit_replication``); off a mesh, nothing.  Blocks
    nest."""
    global _SCOPES
    if ctx.mesh is None or _SCOPES:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _SCOPES += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPES -= 1


def dense_init(gen: torch.Generator, in_dim: int, out_shape, dtype):
    """Fan-in scaled normal init, flattened out dims: (in_dim, *out_shape)."""
    shape = (in_dim,) + tuple(out_shape)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def split_heads(t, n: int, dh: int):
    """(..., n * dh) as (..., n, dh).  On a mesh whose shards of the last
    dim would cut a head (qwen3-14b's 8 KV heads or mamba2-130m's 24 SSD
    heads over a 16-wide "model" axis), that dim is gathered first:
    DTensor cannot split a sharded dim unevenly, where the reference's
    GSPMD regathers it."""
    if is_dtensor(t):
        last = t.ndim - 1
        cuts = math.prod(t.device_mesh.size(i)
                         for i, pl in enumerate(t.placements)
                         if pl.is_shard(last))
        if n % cuts:
            from torch.distributed.tensor import Replicate

            t = t.redistribute(t.device_mesh, [
                Replicate() if pl.is_shard(last) else pl
                for pl in t.placements])
    return t.reshape(*t.shape[:-1], n, dh)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) rotated pairwise; positions: broadcastable to
    (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * inv  # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_chunk: int = 1024, scale: Optional[float] = None,
              plain: bool = False, ctx: ShardCtx = NULL_CTX):
    """Grouped attention, causal or sliding-window (the reference's
    query-chunked ``attention``).

    q, k: (B, S, H or KH, Dh); v: (B, S, KH, Dv), Dv <= Dh, H % KH == 0
    -> (B, S, H, Dv).
    On CUDA tensors this launches the flash-attention kernel; on CPU
    tensors, or with ``plain=True``, it runs the plain version in query
    blocks of ``q_chunk``.  Both mask as the reference's kernel does.  For
    every config of the repo that is what the reference's layer computes:
    the causal ones with or without a window, and hubert-xlarge's
    bidirectional attention over all keys (``causal=False``, no window).
    Only ``causal=False`` with a window and ``S > q_chunk``, which no
    config selects, differs: the reference's windowed query blocks force
    causality there.

    V may be narrower than Q and K (MLA: 128 against 192), as the
    reference's layer allows; the plain version and the flash kernel's
    wrapper both take it at its own width.

    On a mesh (``ctx.mesh``) q, k and v are DTensors and each rank runs the
    same call on its local shard (``_attention_on_mesh``).

    Raises:
        ValueError: ``S > q_chunk`` and ``S % q_chunk != 0`` (the reference
            asserts the same).
    """
    s = q.shape[1]
    if s > q_chunk and s % q_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"attention query chunk {q_chunk}")
    if ctx.mesh is not None:
        return _attention_on_mesh(q, k, v, ctx, causal=causal, window=window,
                                  q_chunk=q_chunk, scale=scale, plain=plain)
    if plain:
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_chunk=q_chunk)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


def _attention_on_mesh(q, k, v, ctx: ShardCtx, **kw):
    """``attention`` through ``local_map``: the batch over the DP axes (when
    it divides), the query heads over ``"model"`` (when they divide), and
    each rank's kernel call on its local heads.  KV heads shard with the
    query heads when they divide the axis too; otherwise KV stays
    replicated and each rank takes the KV heads of its own query-head
    range (global head // group), not the first ones."""
    b, _, h, _ = q.shape
    kh = k.shape[2]
    tp, g = ctx.tp_axis, h // kh
    tp_n = ctx.size(tp)
    bax = ctx.batch_axes(b)
    heads = h % tp_n == 0
    kv_heads = heads and kh % tp_n == 0
    q_pl = ctx.mesh_placements({bax: 0, **({tp: 2} if heads else {})})
    kv_pl = q_pl if kv_heads else ctx.mesh_placements({bax: 0})
    # replicated KV used by a rank's heads alone: its gradient is partial
    kv_grad = q_pl if kv_heads else ctx.mesh_placements(
        {bax: 0}, partial=(tp,) if heads else ())
    rank = ctx.mesh.get_local_rank(tp) if heads and not kv_heads else 0

    def body(ql, kl, vl):
        if heads and not kv_heads:
            hl = ql.shape[2]
            first = rank * hl
            if hl % g == 0:  # whole groups: a contiguous KV range
                sl = slice(first // g, first // g + hl // g)
                kl, vl = kl[:, :, sl], vl[:, :, sl]
            else:  # one KV head per local query head
                idx = torch.arange(first, first + hl, device=kl.device) // g
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        return attention(ql, kl, vl, **kw)

    return mesh_map(ctx.mesh, body, (q, k, v), (q_pl, kv_pl, kv_pl), (q_pl,),
                    (q_pl, kv_grad, kv_grad))


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None):
    """One-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KH, Dh); ``pos``: tokens written
    so far, the current one (at index pos - 1) included, an int or a 0-d
    tensor on the caches' device.  A DTensor cache (sequence-sharded on a
    mesh, ``pos`` an int) goes through ``seq_sharded_attention``.
    """
    b, _, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)

    def scores(ql, kl):
        qg = ql.reshape(ql.shape[0], 1, kh, g, dh)
        return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                            kl.float()) * scale

    def values(p, vl):
        return torch.einsum("bhgqk,bkhd->bqhgd", p.to(vl.dtype), vl)

    if is_dtensor(k_cache):
        o = seq_sharded_attention((q,), (k_cache, v_cache), pos, window,
                                  lambda qs, cs: scores(qs[0], cs[0]),
                                  lambda p, cs: values(p, cs[1]))
        return o.reshape(b, 1, h, dh)
    s = scores(q, k_cache)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos < pos
    if window > 0:
        valid &= kpos >= pos - window
    s = s.masked_fill(~valid, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return values(p, v_cache).reshape(b, 1, h, dh)


def seq_sharded_attention(qs, caches, pos: int, window: int, scores,
                          values):
    """One-token attention over DTensor caches sequence-sharded on their
    mesh (``cache_specs``: dim 1 over ``"model"``), flash-decoding style,
    through ``local_map``: each rank scores the keys its shard holds
    (``scores(local qs, local caches)`` -> f32 (..., S_local), masked here
    to the positions below ``pos`` and within ``window``), the softmax's
    max and sum are all-reduced over the sequence axes, and each rank's
    ``values(p, local caches)`` (its share of the output) is summed over
    them.  The queries are taken whole (every head) with the caches' batch
    placement; the output has that batch placement.  No gradient: decode
    runs under ``no_grad``."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    cache = caches[0]
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    seq_dims = [i for i, x in enumerate(pl) if x == Shard(1)]
    q_pl = tuple(Shard(0) if x == Shard(0) else Replicate() for x in pl)
    lo, hi = shard_span(cache, 1)

    def body(*local):
        ql, cl = local[:len(qs)], local[len(qs):]
        s = scores(ql, cl)
        kpos = torch.arange(lo, hi, device=s.device)
        valid = kpos < pos
        if window > 0:
            valid &= kpos >= pos - window
        s = s.masked_fill(~valid, -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        p = torch.exp(s - m)
        total = p.sum(dim=-1, keepdim=True)
        for i in seq_dims:
            total = funcol.all_reduce(total, "sum", (mesh, i))
        o = values(p / total, cl)
        for i in seq_dims:
            o = funcol.all_reduce(o, "sum", (mesh, i))
        return o

    return mesh_map(mesh, body, (*qs, *caches),
                    (q_pl,) * len(qs) + (pl,) * len(caches), (q_pl,))


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype):
    return {"gate": dense_init(gen, d, (ff,), dtype),
            "up": dense_init(gen, d, (ff,), dtype),
            "down": dense_init(gen, ff, (d,), dtype)}


def mlp_apply(p, x, ctx: ShardCtx = NULL_CTX, *, shared: int = 0,
              act: str = "silu", adapter=None):
    """Gated MLP: ``(act(x gate) * (x up)) down``, ``act`` SiLU or exact
    GELU.  ``adapter`` (A (D, r), B (r, 2 F)) adds ``x A B`` to the gate
    and up projections, gate first (Zamba2's per-use adapters).  On a mesh
    the hidden is pinned to (dp, None, tp), as the reference pins it.
    ``shared`` (1 for an MoE layer's shared experts) labels its
    ``model.ffn`` span."""
    with region("model.ffn", shared=shared):
        gate, up = x @ p["gate"], x @ p["up"]
        if adapter is not None:
            extra = (x @ adapter[0]) @ adapter[1]
            gate = gate + extra[..., :gate.shape[-1]]
            up = up + extra[..., gate.shape[-1]:]
        fn = {"silu": F.silu, "gelu": F.gelu}[act]
        h = fn(grad_as_forward(gate)) * grad_as_forward(up)
        if ctx.mesh is not None and h.ndim == 3:
            h = ctx.constrain(h, ctx.dp, None, ctx.tp_axis)
        return h @ p["down"]


# ------------------------------------------------------------------------ MoE


@dataclasses.dataclass
class Routing:
    """One ``moe_local`` call's routing, detached.

    ``probs`` (T, E) f32 router probabilities; ``top_idx`` (T, k) each
    token's experts, in selection order; ``combine`` (T, E) f32 the
    renormalised weights of the chosen experts (0 elsewhere);
    ``expert_idx`` (E, C) each expert's gathered tokens, in selection order;
    ``slot`` (T, k) each token's chosen experts in increasing index as flat
    (expert * C + slot) positions, -1 where the expert's capacity dropped
    the token.
    """

    probs: torch.Tensor
    top_idx: torch.Tensor
    combine: torch.Tensor
    expert_idx: torch.Tensor
    slot: torch.Tensor

    @property
    def dropped(self) -> torch.Tensor:
        """Routed (token, expert) slots the capacity dropped (a tensor)."""
        return (self.slot < 0).sum()


class RoutingLog:
    """The routing of every ``moe_local`` call made while it is recorded
    (``recording``), in call order, in ``calls``.

    ``force``: another log whose calls give this run's selections, call by
    call (their ``top_idx`` and ``expert_idx``); each call still takes its
    weights from its own probabilities.  That evaluates one path at another
    path's routing, as the change-point contract evaluates the plain
    pipeline at the kernel's cut.  A forced call whose shapes differ from
    its counterpart's raises ``ValueError``.
    """

    def __init__(self, force: Optional["RoutingLog"] = None):
        self.calls: List[Routing] = []
        self._force = None if force is None else list(force.calls)

    def to(self, device) -> "RoutingLog":
        """A copy of the recorded calls on ``device`` (no forced routing)."""
        out = RoutingLog()
        out.calls = [Routing(*(getattr(c, f.name).to(device)
                               for f in dataclasses.fields(Routing)))
                     for c in self.calls]
        return out

    @property
    def forcing(self) -> bool:
        """Whether the log forces its calls' routing (made with ``force=``)."""
        return self._force is not None

    def forced(self) -> Optional[Routing]:
        """The forced routing of the next call, or ``None``."""
        if self._force is None:
            return None
        i = len(self.calls)
        if i >= len(self._force):
            raise ValueError(f"forced routing has {len(self._force)} calls; "
                             f"call {i} has none")
        return self._force[i]


# The log ``moe_local`` records into (``recording``); None: not recording.
ROUTING: Optional[RoutingLog] = None


@contextlib.contextmanager
def recording(log: RoutingLog):
    """Record (or force) the routing of the ``moe_local`` calls made inside
    the block into ``log``."""
    global ROUTING
    prev, ROUTING = ROUTING, log
    try:
        yield log
    finally:
        ROUTING = prev


def _members(idx, n: int):
    """(rows, n) bool: which of n columns each row of ``idx`` selects."""
    return torch.zeros(idx.shape[0], n, dtype=torch.bool,
                       device=idx.device).scatter_(1, idx, True)


def same_routing(a: RoutingLog, b: RoutingLog) -> bool:
    """Whether two logs made the same selections, call by call (each
    token's experts and each expert's gathered tokens, as sets)."""
    if len(a.calls) != len(b.calls):
        return False
    for x, y in zip(a.calls, b.calls):
        e, t = x.expert_idx.shape[0], x.top_idx.shape[0]
        if x.top_idx.shape != y.top_idx.shape \
                or x.expert_idx.shape != y.expert_idx.shape:
            return False
        if not (torch.equal(_members(x.top_idx, e), _members(y.top_idx, e))
                and torch.equal(_members(x.expert_idx, t),
                                _members(y.expert_idx, t))):
            return False
    return True


def routing_flips(values: RoutingLog, chosen: RoutingLog) -> dict:
    """How far ``chosen``'s selections lie from the ones ``values``' own
    probabilities and weights make, call by call (the near-tie test of a
    routing flip between two paths).

    For each call, each token's experts are compared, as sets, with the
    top k of ``values``' probabilities, and each expert's gathered tokens
    with the top C of ``values``' combine weights.  A token or expert whose
    sets differ is a flip; its gap is the largest relative distance, under
    ``values``' numbers, between a candidate in one set and not the other
    and the selection's edge (the k-th probability, the C-th weight).
    ``values`` is the reference side: the plain path, or the plain path
    forced to the other path's routing (``RoutingLog(force=...)``), whose
    combine weights then follow the forced token choice.

    Returns {"calls", "token_flips", "capacity_flips", "worst_gap"}
    (``worst_gap`` 0.0 without a flip; ``inf`` where an edge weight of 0
    separates a weighted token).
    """
    if len(values.calls) != len(chosen.calls):
        raise ValueError(f"{len(values.calls)} calls against "
                         f"{len(chosen.calls)}")
    flips = {"token_flips": 0, "capacity_flips": 0}
    worst = 0.0
    for r, g in zip(values.calls, chosen.calls):
        for key, vals, pick in (("token_flips", r.probs, g.top_idx),
                                ("capacity_flips", r.combine.T,
                                 g.expert_idx)):
            top_v, top_i = _top(vals, pick.shape[1], None)
            n = vals.shape[1]
            diff = _members(top_i, n) != _members(pick, n)
            rows = int(diff.any(1).sum())
            if not rows:
                continue
            edge = top_v[:, -1:]
            dist = (vals - edge).abs()
            rel = torch.where(edge > 0, dist / edge.clamp(min=1e-30),
                              torch.where(dist > 0, torch.inf, 0.0))
            worst = max(worst, float(rel[diff].max()))
            flips[key] += rows
    return {"calls": len(values.calls), **flips, "worst_gap": worst}


def moe_init(gen: torch.Generator, cfg, dtype):
    """Stacked routed experts (E, D, F) / (E, F, D), the fused shared expert
    and the router, which stays f32 whatever ``dtype`` (as the
    reference's)."""
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
    dev = gen.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * scale).to(dtype)

    p = {"router": dense_init(gen, d, (e,), torch.float32),
         "wg": normal((e, d, f), 1.0 / math.sqrt(d)),
         "wu": normal((e, d, f), 1.0 / math.sqrt(d)),
         "wd": normal((e, f, d), 1.0 / math.sqrt(f))}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * f, dtype)
    return p


def _top(values, k: int, forced: Optional[torch.Tensor]):
    """``lax.top_k`` over the last dim (the larger value first, the lower
    index first among equal values), or ``values`` at ``forced``."""
    if forced is not None:
        if forced.shape != values.shape[:-1] + (k,):
            raise ValueError(f"forced selection of shape {tuple(forced.shape)}"
                             f" for top {k} of {tuple(values.shape)}")
        return values.gather(-1, forced), forced
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _slots(expert_idx, top_idx, t: int, first: int = 0):
    """(T, k) flat slots of each token's chosen experts in increasing expert
    index, -1 where the token is not among the expert's gathered ones or
    the expert is not among the local ones, ``expert_idx``'s rows (global
    experts ``first``, ``first + 1``, ...)."""
    e, c = expert_idx.shape
    pos = torch.full((e, t), -1, dtype=torch.long, device=expert_idx.device)
    pos.scatter_(1, expert_idx, torch.arange(c, device=pos.device).repeat(e, 1))
    chosen = torch.sort(top_idx, dim=1).values - first
    local = (chosen >= 0) & (chosen < e)
    at = pos[chosen.clamp(0, e - 1),
             torch.arange(t, device=pos.device)[:, None]]
    return torch.where(local & (at >= 0), chosen * c + at, -1)


def moe_capacity(cfg, tokens: int) -> int:
    """Tokens each expert gathers from a call over ``tokens`` tokens: the
    reference's integer arithmetic."""
    cap = max(1, int(tokens * cfg.moe_top_k * cfg.capacity_factor)
              // cfg.n_routed_experts)
    return min(cap, tokens)


def moe_local(p, x2d, *, top_k: int, capacity: int, first: int = 0):
    """Token-choice MoE over the experts of one device.

    x2d: (T, D); ``p["wg"]``/``"wu"``/``"wd"`` hold the local experts
    (global experts ``first`` to ``first + E_loc - 1``: all of them off a
    mesh), ``p["router"]`` (D, E) every expert's column.  Each token takes
    its ``top_k`` experts by router
    probability, their weights renormalised to sum to 1; each expert
    gathers the ``capacity`` tokens of largest weight (tokens that did not
    choose it have weight 0), runs its gated MLP on them and scales by the
    weight; each token sums its contributions in f32, in increasing expert
    index, and the sum is cast to x2d's dtype.  A token the expert's
    capacity left out gets nothing from it; a token's expert on another
    rank adds its part there.

    Returns (y (T, D), aux): the Switch-style load-balance loss
    ``E * sum(mean(combine > 0) * mean(probs))`` over the experts (this
    call's tokens; ``moe_apply`` averages the fractions over a mesh).
    """
    y, frac_tokens, frac_probs = _moe_local(p, x2d, top_k=top_k,
                                            capacity=capacity, first=first)
    return y, frac_probs.shape[0] * torch.sum(frac_tokens * frac_probs)


def _moe_local(p, x2d, *, top_k: int, capacity: int, first: int):
    """``moe_local``'s output and its load fractions (mean(combine > 0),
    mean(probs)), each (E,)."""
    t, d = x2d.shape
    e = p["router"].shape[1]
    e_loc = p["wg"].shape[0]
    log = ROUTING
    with region("model.moe.route", tokens=t, capacity=capacity):
        forced = None if log is None else log.forced()
        probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
        top_vals, top_idx = _top(probs, top_k,
                                 None if forced is None else forced.top_idx)
        top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
        combine = torch.zeros((t, e), dtype=torch.float32,
                              device=x2d.device).scatter(1, top_idx, top_vals)
        vals, idx = _top(combine.T[first:first + e_loc], capacity,
                         None if forced is None else forced.expert_idx)
        slot = _slots(idx, top_idx, t, first)
        if log is not None:
            log.calls.append(Routing(probs.detach(), top_idx,
                                     combine.detach(), idx, slot))
    with region("model.moe.experts"):
        xs = x2d[idx]  # (E_loc, C, D)
        h = F.silu(torch.bmm(xs, p["wg"])) * torch.bmm(xs, p["wu"])
        ys = torch.bmm(h, p["wd"]).float() * vals[..., None]
    with region("model.moe.combine"):
        flat = ys.reshape(-1, d)
        out = torch.zeros((t, d), dtype=torch.float32, device=x2d.device)
        for j in range(top_k):
            s = slot[:, j]
            out = out + torch.where((s >= 0)[:, None], flat[s.clamp(min=0)],
                                    0.0)
        out = out.to(x2d.dtype)
    return (out, torch.mean((combine > 0).float(), dim=0),
            torch.mean(probs, dim=0))


def moe_apply(p, x, cfg, ctx: ShardCtx = NULL_CTX):
    """x: (B, S, D) -> (y, aux): the routed experts over the call's B * S
    tokens at the reference's capacity (``moe_capacity``), plus the shared
    expert.

    On a mesh, the reference's expert-parallel ``shard_map`` through
    ``local_map``: tokens stay sharded over the DP axes and experts over
    ``"model"``; each rank routes its ``tokens // dp_size`` tokens at that
    count's capacity over every expert and runs its own experts (from
    global expert ``rank * E_loc``) on them; the output is all-reduced over
    ``"model"``; the load fractions are averaged over every mesh axis
    before the aux product.  Under ``recording`` each rank logs its own
    shard's routing.

    Raises:
        ValueError: on a mesh, a batch the DP axes or experts the model
            axis do not divide (``shard_map`` refuses them too).
    """
    b, s, d = x.shape
    if ctx.mesh is not None:
        return _moe_on_mesh(p, x, cfg, ctx)
    y, aux = moe_local(p, x.reshape(-1, d), top_k=cfg.moe_top_k,
                       capacity=moe_capacity(cfg, b * s))
    y = y.reshape(x.shape)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, shared=1)
    return y, aux


def _moe_on_mesh(p, x, cfg, ctx: ShardCtx):
    b, s, d = x.shape
    tp, dp = ctx.tp_axis, ctx.dp
    dp_n, tp_n = ctx.size(ctx.dp_axes), ctx.size(tp)
    e = cfg.n_routed_experts
    if b % dp_n or e % tp_n:
        raise ValueError(f"the expert-parallel MoE needs the batch {b} over "
                         f"{dp_n} DP ranks and {e} experts over {tp_n} model "
                         f"ranks to divide")
    t_local = b * s // dp_n
    cap = moe_capacity(cfg, t_local)
    first = ctx.mesh.get_local_rank(tp) * (e // tp_n)
    every = tuple(ctx.mesh.mesh_dim_names)

    def body(xl, router, wg, wu, wd):
        y, ft, fp = _moe_local({"router": router, "wg": wg, "wu": wu,
                                "wd": wd}, xl.reshape(-1, d),
                               top_k=cfg.moe_top_k, capacity=cap,
                               first=first)
        # one row of fractions per rank: (ranks, E) over the whole mesh
        return y.reshape(xl.shape), ft[None], fp[None]

    x_pl = ctx.mesh_placements({dp: 0})
    w_pl = ctx.mesh_placements({tp: 0})
    rows = ctx.mesh_placements({every: 0})
    y, ft, fp = mesh_map(
        ctx.mesh, body, (x, p["router"], p["wg"], p["wu"], p["wd"]),
        (x_pl, ctx.mesh_placements(), w_pl, w_pl, w_pl),
        (ctx.mesh_placements({dp: 0}, partial=(tp,)), rows, rows),
        (ctx.mesh_placements({dp: 0}, partial=(tp,)),
         ctx.mesh_placements(partial=every),
         *[ctx.mesh_placements({tp: 0}, partial=ctx.dp_axes)] * 3))
    y = y.redistribute(ctx.mesh, x_pl)  # the all-reduce over "model"
    frac_tokens, frac_probs = ft.mean(dim=0), fp.mean(dim=0)
    aux = e * torch.sum(frac_tokens.redistribute(ctx.mesh,
                                                 ctx.mesh_placements())
                        * frac_probs.redistribute(ctx.mesh,
                                                  ctx.mesh_placements()))
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, ctx, shared=1)
    return y, aux


def mamba_init(gen: torch.Generator, cfg, dtype):
    """One Mamba2 mixer's parameters, in the reference's layout: the fused
    ``in_proj`` and ``conv_w``/``conv_b``, or under ``cfg.ssm_split_proj``
    the split projections ``wz``, ``wx``, ``wb``, ``wc``, ``wdt`` and the
    convolutions of x (``conv_wx``, ``conv_bx``) and of B and C
    (``conv_wbc``, ``conv_bbc``), whose inner and head dims shard over
    ``"model"``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_bc_width, cfg.ssm_heads
    dev = gen.device

    def conv(width):
        w = torch.randn((cfg.ssm_conv, width), generator=gen,
                        dtype=torch.float32, device=dev)
        return (w * (1.0 / math.sqrt(cfg.ssm_conv))).to(dtype)

    common = {
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm": torch.ones(di, dtype=dtype, device=dev),
    }
    if getattr(cfg, "ssm_split_proj", False):
        return {
            "wz": dense_init(gen, d, (di,), dtype),
            "wx": dense_init(gen, d, (di,), dtype),
            "wb": dense_init(gen, d, (n,), dtype),
            "wc": dense_init(gen, d, (n,), dtype),
            "wdt": dense_init(gen, d, (h,), dtype),
            "conv_wx": conv(di),
            "conv_bx": torch.zeros(di, dtype=dtype, device=dev),
            "conv_wbc": conv(2 * n),
            "conv_bbc": torch.zeros(2 * n, dtype=dtype, device=dev),
            **common,
            "out_proj": dense_init(gen, di, (d,), dtype),
        }
    conv_w = conv(di + 2 * n)
    return {
        **common,
        "out_proj": dense_init(gen, di, (d,), dtype),
        "in_proj": dense_init(gen, d, (2 * di + 2 * n + h,), dtype),
        "conv_w": conv_w,
        "conv_b": torch.zeros(di + 2 * n, dtype=dtype, device=dev),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B,T,C), w: (K,C), b: (C,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):  # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


class _GradAsForward(torch.autograd.Function):
    """The identity, whose backward hands the gradient on in the forward
    value's placements (a DTensor's; a partial one's replicated)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate

        # a partial value's gradient is replicated, as DTensor's own
        # backward hands it on
        ctx.where = (t.device_mesh, tuple(
            Replicate() if pl.is_partial() else pl for pl in t.placements))
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.where
        if all(a == b or mesh.size(i) == 1
               for i, (a, b) in enumerate(zip(g.placements, pl))):
            return g  # no layout a mesh dim of one rank could tell apart
        return g.redistribute(mesh, pl)


def grad_as_forward(t):
    """``t``, its gradient taken to ``t``'s own placements on the way back
    (on a mesh).  A product's output gradient may arrive sharded over the
    sequence (the residual's sequence-parallel layout), which DTensor
    flattens into a strided shard its matrix product cannot take; pinned
    here, the product's backward sees the forward's layout, where the
    reference's GSPMD gathers it."""
    return _GradAsForward.apply(t) if is_dtensor(t) else t


def _project(p, x, cfg):
    """(z, xin, b_in, c_in, dt) of the mixer's input projection, from the
    fused ``in_proj`` or the split projections; B and C hold every group's
    ``ssm_state`` columns, group by group."""
    if "wz" in p:
        return tuple(grad_as_forward(x @ p[k])
                     for k in ("wz", "wx", "wb", "wc", "wdt"))
    di, n = cfg.d_inner, cfg.ssm_bc_width
    return torch.split(grad_as_forward(x @ p["in_proj"]),
                       [di, di, n, n, cfg.ssm_heads], dim=-1)


def _conv_weights(p):
    """The depthwise conv over (x, B, C) as one (K, conv_dim) weight and
    its bias: the split layout's concatenated in the fused order."""
    if "wz" in p:
        return (torch.cat([p["conv_wx"], p["conv_wbc"]], dim=-1),
                torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1))
    return p["conv_w"], p["conv_b"]


def gated_norm(y, z, weight, groups: int = 1, eps: float = 1e-5):
    """Mamba2's gated RMSNorm: ``y * silu(z)`` normalised over each of
    ``groups`` equal groups of its channels, then scaled by ``weight``."""
    g = y * F.silu(z)
    if groups == 1:
        return rms_norm(g, weight, eps)
    gf = g.float().reshape(*g.shape[:-1], groups, g.shape[-1] // groups)
    gf = gf * torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + eps)
    return (gf.reshape(g.shape) * weight.float()).to(g.dtype)


def mamba_apply(p, x, cfg, *, plain: bool = False,
                ctx: ShardCtx = NULL_CTX, final_state: bool = False):
    """Full-sequence Mamba2 mixer.  x: (B,T,D) -> (B,T,D); with
    ``final_state`` (y, the decode state after the last step: ``"h"``
    (B,H,P,N) f32 from the scan, ``"conv"`` the last ``ssm_conv - 1`` conv
    inputs, zeros before the first).

    The split layout convolves x and (B, C) apart (each channel is its
    own), so x's channels stay sharded over ``"model"``; on a mesh the
    conv runs through ``local_map`` on each rank's batch (and channels),
    the SSD on each rank's heads.  With ``ssm_ngroups`` G > 1, B and C go
    to the scan as (B,T,G,N) and the gated norm is per group.

    Raises:
        ValueError: ``T % cfg.ssm_chunk != 0`` (the SSD scan's chunking).
    """
    bsz, t, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_bc_width, cfg.ssm_heads, \
        cfg.ssm_headdim
    groups = cfg.ssm_ngroups
    z, xin, b_in, c_in, dt = _project(p, x, cfg)
    conv = causal_conv1d if ctx.mesh is None else functools.partial(
        _conv_on_mesh, ctx=ctx)
    if final_state:
        k = cfg.ssm_conv - 1
        pre = torch.cat([xin, b_in, c_in], dim=-1)
        conv_state = F.pad(pre, (0, 0, max(0, k - t), 0))[:, -k:]
    if "wz" in p:
        xin = conv(xin, p["conv_wx"], p["conv_bx"])
        bc = conv(torch.cat([b_in, c_in], dim=-1), p["conv_wbc"],
                  p["conv_bbc"])
        b_in, c_in = torch.split(bc, [n, n], dim=-1)
    else:
        xbc = conv(torch.cat([xin, b_in, c_in], dim=-1), p["conv_w"],
                   p["conv_b"])
        xin, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    if groups > 1:
        b_in = b_in.reshape(bsz, t, groups, n // groups)
        c_in = c_in.reshape(bsz, t, groups, n // groups)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = split_heads(xin, h, hp)
    args = (xh, dt, p["A_log"], b_in, c_in, p["D"])
    if ctx.mesh is not None:
        if final_state:
            raise NotImplementedError("the final SSD state on a mesh")
        y = _ssd_on_mesh(args, cfg, ctx, plain)
    else:
        y = _ssd(*args, cfg.ssm_chunk, plain, final_state)
    if final_state:
        y, h_last = y
    y = gated_norm(grad_as_forward(y.reshape(bsz, t, di)), z, p["norm"],
                   groups)
    out = y @ p["out_proj"]
    return (out, {"h": h_last, "conv": conv_state}) if final_state else out


def _conv_on_mesh(x, w, b, *, ctx: ShardCtx):
    """``causal_conv1d`` through ``local_map``: batch over the DP axes (when
    it divides), the channels over ``"model"`` where the weight shards them
    (the split layout's x), the weight's gradient partial over the DP axes.
    The card's torch 2.11 cannot plan DTensor's own padding of the
    production mesh's sequence."""
    tp = ctx.tp_axis
    bax = ctx.batch_axes(x.shape[0])
    tp_ch = any(pl.is_shard(1) for pl in w.placements)
    x_pl = ctx.mesh_placements({bax: 0, **({tp: 2} if tp_ch else {})})
    w_dims, b_dims = ({tp: 1}, {tp: 0}) if tp_ch else ({}, {})
    part = ctx.dp_axes if bax else ()
    return mesh_map(
        ctx.mesh, causal_conv1d, (x, w, b),
        (x_pl, ctx.mesh_placements(w_dims), ctx.mesh_placements(b_dims)),
        (x_pl,), (x_pl, ctx.mesh_placements(w_dims, partial=part),
                  ctx.mesh_placements(b_dims, partial=part)))


def _ssd(xh, dt, a_log, b_in, c_in, d_skip, chunk: int, plain: bool,
         final_state: bool = False):
    if plain:
        return ssd_scan_plain(xh, dt, -torch.exp(a_log.float()), b_in, c_in,
                              d_skip, chunk=chunk, final_state=final_state)
    return ssd(xh, dt, a_log, b_in, c_in, d_skip, chunk=chunk,
               final_state=final_state)


def _ssd_on_mesh(args, cfg, ctx: ShardCtx, plain: bool):
    """The SSD through ``local_map``: batch over the DP axes (when it
    divides), heads over ``"model"`` (when they divide), B and C whole on
    every rank of the model axis."""
    xh = args[0]
    tp = ctx.tp_axis
    bax = ctx.batch_axes(xh.shape[0])
    heads = {tp: 2} if cfg.ssm_heads % ctx.size(tp) == 0 else {}
    x_pl = ctx.mesh_placements({bax: 0, **heads})
    bc_pl = ctx.mesh_placements({bax: 0})
    hv_pl = ctx.mesh_placements({tp: 0} if heads else {})
    # a gradient is partial over the axes its tensor is whole on while the
    # ranks there compute on their own part of the batch or heads
    bc_grad = ctx.mesh_placements({bax: 0}, partial=(tp,) if heads else ())
    hv_grad = ctx.mesh_placements({tp: 0} if heads else {},
                                  partial=ctx.dp_axes if bax else ())
    return mesh_map(
        ctx.mesh, lambda *a: _ssd(*a, cfg.ssm_chunk, plain), args,
        (x_pl, x_pl, hv_pl, bc_pl, bc_pl, hv_pl), (x_pl,),
        (x_pl, x_pl, hv_grad, bc_grad, bc_grad, hv_grad))


def mamba_decode_step(p, x, cfg, state):
    """Single-token Mamba2 step.

    x: (B,1,D); state: {"h": (B,H,P,N) f32, "conv": (B,K-1,conv_dim)}.
    Returns (y (B,1,D), new_state).
    """
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_bc_width, cfg.ssm_heads, \
        cfg.ssm_headdim
    groups = cfg.ssm_ngroups
    z, xin, b_in, c_in, dt = _project(p, x[:, 0], cfg)
    conv_w, conv_b = _conv_weights(p)
    xbc = torch.cat([xin, b_in, c_in], dim=-1)  # (B, conv_dim)
    conv_hist = torch.cat([state["conv"], xbc[:, None]], dim=1)  # (B,K,cd)
    acc = torch.einsum("bkc,kc->bc", conv_hist.float(), conv_w.float()) \
        + conv_b.float()
    xin, b_in, c_in = torch.split(acc.to(x.dtype), [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)

    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt * a)  # (B,H)
    xh = xin.reshape(bsz, h, hp).float()
    if groups > 1:  # each head its group's B and C
        bh = b_in.float().reshape(bsz, groups, -1).repeat_interleave(
            h // groups, dim=1)
        ch = c_in.float().reshape(bsz, groups, -1).repeat_interleave(
            h // groups, dim=1)
        hnew = state["h"] * dec[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt, xh, bh)
        y = torch.einsum("bhn,bhpn->bhp", ch, hnew)
    else:
        hnew = state["h"] * dec[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt, xh, b_in.float())
        y = torch.einsum("bn,bhpn->bhp", c_in.float(), hnew)
    y = y + p["D"][None, :, None] * xh
    y = gated_norm(y.reshape(bsz, di).to(x.dtype), z, p["norm"], groups)
    out = (y @ p["out_proj"])[:, None]
    return out, {"h": hnew, "conv": conv_hist[:, 1:]}
