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
reference's token-choice routing with per-expert capacity, on one device:
the experts are batched products over the stacked weights, as in the
reference, and no kernel is involved.  Both of its selections take the
reference's ``lax.top_k`` order (the larger value first, the lower index
first among equal values) through a stable descending sort, and each
token sums its experts' contributions in increasing expert index, the
order of the reference's scatter-add, so a call gives the same bits on
every run.  ``recording(RoutingLog())`` keeps each call's routing (off by
default), a log made with ``force=`` replays another run's routing
(``RoutingLog``), and ``same_routing`` and ``routing_flips`` compare two
logs (a flip between two f32 orders must be a near-tie).

The reference's split-projection layout (``ssm_split_proj``) is a TPU
sharding layout; the port does not shard yet (ROADMAP A.13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_plain
from ..kernels.ssd.ops import ssd
from ..kernels.ssd.ref import ssd_scan_plain

__all__ = ["Routing", "RoutingLog", "apply_rope", "attention",
           "causal_conv1d", "decode_attention", "dense_init", "embed_init",
           "mamba_apply", "mamba_decode_step", "mamba_init", "mlp_apply",
           "mlp_init", "moe_apply", "moe_capacity", "moe_init", "moe_local",
           "recording", "rms_norm", "rope_freqs", "routing_flips",
           "same_routing"]


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
              plain: bool = False):
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

    Raises:
        ValueError: ``S > q_chunk`` and ``S % q_chunk != 0`` (the reference
            asserts the same).
    """
    s = q.shape[1]
    if s > q_chunk and s % q_chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"attention query chunk {q_chunk}")
    if plain:
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_chunk=q_chunk)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None):
    """One-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, S_max, KH, Dh); ``pos``: tokens written
    so far, the current one (at index pos - 1) included.
    """
    b, _, h, dh = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, 1, kh, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float())
    s = s * scale
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    valid = kpos < pos
    if window > 0:
        valid &= kpos >= pos - window
    s = s.masked_fill(~valid, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, h, dh)


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype):
    return {"gate": dense_init(gen, d, (ff,), dtype),
            "up": dense_init(gen, d, (ff,), dtype),
            "down": dense_init(gen, ff, (d,), dtype)}


def mlp_apply(p, x):
    """Gated MLP: ``(silu(x gate) * (x up)) down``."""
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


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


def _slots(expert_idx, top_idx, t: int):
    """(T, k) flat slots of each token's chosen experts in increasing expert
    index, -1 where the token is not among the expert's gathered ones."""
    e, c = expert_idx.shape
    pos = torch.full((e, t), -1, dtype=torch.long, device=expert_idx.device)
    pos.scatter_(1, expert_idx, torch.arange(c, device=pos.device).repeat(e, 1))
    chosen = torch.sort(top_idx, dim=1).values
    at = pos[chosen, torch.arange(t, device=pos.device)[:, None]]
    return torch.where(at >= 0, chosen * c + at, -1)


def moe_capacity(cfg, tokens: int) -> int:
    """Tokens each expert gathers from a call over ``tokens`` tokens: the
    reference's integer arithmetic."""
    cap = max(1, int(tokens * cfg.moe_top_k * cfg.capacity_factor)
              // cfg.n_routed_experts)
    return min(cap, tokens)


def moe_local(p, x2d, *, top_k: int, capacity: int):
    """Token-choice MoE over all experts of one device.

    x2d: (T, D).  Each token takes its ``top_k`` experts by router
    probability, their weights renormalised to sum to 1; each expert
    gathers the ``capacity`` tokens of largest weight (tokens that did not
    choose it have weight 0), runs its gated MLP on them and scales by the
    weight; each token sums its contributions in f32, in increasing expert
    index, and the sum is cast to x2d's dtype.  A token the expert's
    capacity left out gets nothing from it.

    Returns (y (T, D), aux): the Switch-style load-balance loss
    ``E * sum(mean(combine > 0) * mean(probs))`` over the experts.
    """
    t, d = x2d.shape
    e = p["router"].shape[1]
    log = ROUTING
    forced = None if log is None else log.forced()
    probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
    top_vals, top_idx = _top(probs, top_k,
                             None if forced is None else forced.top_idx)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    combine = torch.zeros((t, e), dtype=torch.float32,
                          device=x2d.device).scatter(1, top_idx, top_vals)
    vals, idx = _top(combine.T, capacity,
                     None if forced is None else forced.expert_idx)  # (E, C)
    xs = x2d[idx]  # (E, C, D)
    h = F.silu(torch.bmm(xs, p["wg"])) * torch.bmm(xs, p["wu"])
    ys = torch.bmm(h, p["wd"]).float() * vals[..., None]
    slot = _slots(idx, top_idx, t)
    flat = ys.reshape(-1, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=x2d.device)
    for j in range(top_k):
        s = slot[:, j]
        out = out + torch.where((s >= 0)[:, None], flat[s.clamp(min=0)], 0.0)
    frac_tokens = torch.mean((combine > 0).float(), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    if log is not None:
        log.calls.append(Routing(probs.detach(), top_idx, combine.detach(),
                                 idx, slot))
    return out.to(x2d.dtype), aux


def moe_apply(p, x, cfg, *, mesh=None):
    """x: (B, S, D) -> (y, aux): the routed experts over the call's B * S
    tokens at the reference's capacity (``moe_capacity``), plus the shared
    expert.

    Raises:
        NotImplementedError: ``mesh`` is not ``None``: the reference's
            expert-parallel ``shard_map`` branch waits for ROADMAP A.13.
    """
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh is not ported yet (ROADMAP "
            "A.13)")
    b, s, d = x.shape
    y, aux = moe_local(p, x.reshape(-1, d), top_k=cfg.moe_top_k,
                       capacity=moe_capacity(cfg, b * s))
    y = y.reshape(x.shape)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x)
    return y, aux


def _require_fused(cfg) -> None:
    if getattr(cfg, "ssm_split_proj", False):
        raise NotImplementedError(
            "ssm_split_proj is a TPU sharding layout; the port keeps the "
            "fused in_proj until it shards (ROADMAP A.13)")


def mamba_init(gen: torch.Generator, cfg, dtype):
    """One Mamba2 mixer's parameters, in the reference's layout."""
    _require_fused(cfg)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, (d,), dtype),
        "in_proj": dense_init(gen, d, (2 * di + 2 * n + h,), dtype),
        "conv_w": (conv_w * (1.0 / math.sqrt(cfg.ssm_conv))).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B,T,C), w: (K,C), b: (C,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):  # K is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _split(t, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(t, [di, di, n, n, cfg.ssm_heads], dim=-1)


def mamba_apply(p, x, cfg, *, plain: bool = False):
    """Full-sequence Mamba2 mixer.  x: (B,T,D) -> (B,T,D).

    Raises:
        ValueError: ``T % cfg.ssm_chunk != 0`` (the SSD scan's chunking).
    """
    _require_fused(cfg)
    bsz, t, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xin, b_in, c_in, dt = _split(x @ p["in_proj"], cfg)
    xbc = causal_conv1d(torch.cat([xin, b_in, c_in], dim=-1), p["conv_w"],
                        p["conv_b"])
    xin, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xin.reshape(bsz, t, h, hp)
    if plain:
        y = ssd_scan_plain(xh, dt, -torch.exp(p["A_log"].float()), b_in, c_in,
                           p["D"], chunk=cfg.ssm_chunk)
    else:
        y = ssd(xh, dt, p["A_log"], b_in, c_in, p["D"], chunk=cfg.ssm_chunk)
    y = rms_norm(y.reshape(bsz, t, di) * F.silu(z), p["norm"])
    return y @ p["out_proj"]


def mamba_decode_step(p, x, cfg, state):
    """Single-token Mamba2 step.

    x: (B,1,D); state: {"h": (B,H,P,N) f32, "conv": (B,K-1,conv_dim)}.
    Returns (y (B,1,D), new_state).
    """
    _require_fused(cfg)
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    z, xin, b_in, c_in, dt = _split(x[:, 0] @ p["in_proj"], cfg)
    xbc = torch.cat([xin, b_in, c_in], dim=-1)  # (B, conv_dim)
    conv_hist = torch.cat([state["conv"], xbc[:, None]], dim=1)  # (B,K,cd)
    acc = torch.einsum("bkc,kc->bc", conv_hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xin, b_in, c_in = torch.split(acc.to(x.dtype), [di, n, n], dim=-1)
    xin = F.silu(xin)
    b_in, c_in = F.silu(b_in), F.silu(c_in)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,H)

    a = -torch.exp(p["A_log"])
    dec = torch.exp(dt * a)  # (B,H)
    xh = xin.reshape(bsz, h, hp).float()
    hnew = state["h"] * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, b_in.float())
    y = torch.einsum("bn,bhpn->bhp", c_in.float(), hnew)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(bsz, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = (y @ p["out_proj"])[:, None]
    return out, {"h": hnew, "conv": conv_hist[:, 1:]}
