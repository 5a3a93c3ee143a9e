"""Plain forward pass of the DeepSeek MoE models (deepseek-moe-16b's MHA,
DeepSeek-V2-Lite's MLA), written from their published description.

Written for the benchmark's correctness check, in plain PyTorch and f32
(no kernel, no cache, no batching across requests): a whole sequence
(prompt and served tokens) runs through every layer at once, causal
attention materialised head by head.  ``Arch`` reads the configuration
file as it is run: the published keys, and the port's rules where they
depart from them (``runs``):

- the MoE layer has the token-choice capacity rule the file states
  (``capacity_factor``): each call of the MoE layer over ``T`` tokens lets
  each expert take ``min(T, max(1, int(T * top_k * factor) // E))``
  tokens, those of largest routing weight (tokens that did not choose it
  have weight 0; ties go to the lower token index); a token an expert's
  capacity leaves out gets nothing from it.  A served request makes one
  call over its prompt (batch rows times prompt positions, row-major) and
  one per decode step (one token a row), so ``forward`` takes the calls as
  ``groups`` of positions;
- ``runs.norm_topk_prob``: the chosen experts' probabilities renormalised
  to sum to one;
- RoPE rotates the two halves of each head (pairs ``i`` and ``i + d/2``);
  with random weights that equals the published interleaved pairing up to
  a permutation of weight columns; ``runs.rope_scaling`` null: no YaRN
  (the reference has none, and refuses a file that asks for it).

Precision: ``precision="f32"`` computes every product in f32 (the caller
keeps TF32 off); ``"tf32"`` rounds both operands of every product to TF32
(10 mantissa bits, round to nearest even) and accumulates in f32, which is
what the tensor cores' TF32 mode does.  That is the check's control.

Routing.  ``forward`` may be handed a routing (``route``: per MoE layer
and group, each token's experts and each expert's tokens) that another
path chose.  It then follows that routing, weights from its own
probabilities, and reports how far each choice lies from its own: for
every token (expert) whose set differs from its own top-k (top-C), the
largest relative distance of a differing candidate from the selection's
edge under its own numbers (``gap``).  That is how the check judges the
program's routing, as it judges a served token by its logit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Arch", "Routed", "capacity", "forward", "logits_at", "tf32"]


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes and rules of one configuration file, as the reference
    reads them."""

    layers: int
    d_model: int
    heads: int
    head_dim: int
    d_ff: int
    moe_d_ff: int
    experts: int
    shared: int
    top_k: int
    dense_layers: int
    vocab: int
    eps: float
    rope_theta: float
    kv_lora_rank: int
    qk_nope: int
    qk_rope: int
    v_dim: int
    norm_topk: bool
    tied: bool
    capacity_factor: float

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @classmethod
    def from_file(cls, c: dict) -> "Arch":
        """From a configuration file's keys (the published ``config.json``
        names, the port's rules under ``runs``)."""
        runs = c["runs"]
        if runs.get("rope_scaling") is not None:
            raise ValueError("the reference runs plain RoPE; "
                             f"rope_scaling {runs['rope_scaling']!r}")
        heads = c["num_attention_heads"]
        lora = c.get("kv_lora_rank") or 0
        return cls(
            layers=c["num_hidden_layers"], d_model=c["hidden_size"],
            heads=heads, head_dim=c.get("head_dim") or c["hidden_size"] // heads,
            d_ff=c["intermediate_size"], moe_d_ff=c["moe_intermediate_size"],
            experts=c["n_routed_experts"], shared=c["n_shared_experts"],
            top_k=c["num_experts_per_tok"],
            dense_layers=c["first_k_dense_replace"], vocab=c["vocab_size"],
            eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
            kv_lora_rank=lora, qk_nope=c.get("qk_nope_head_dim") or 0,
            qk_rope=c.get("qk_rope_head_dim") or 0,
            v_dim=c.get("v_head_dim") or 0,
            norm_topk=bool(runs["norm_topk_prob"]),
            tied=bool(c["tie_word_embeddings"]),
            capacity_factor=float(runs["capacity_factor"]))


def capacity(arch: Arch, tokens: int) -> int:
    """Tokens one expert takes from a call over ``tokens`` tokens."""
    cap = max(1, int(tokens * arch.top_k * arch.capacity_factor)
              // arch.experts)
    return min(cap, tokens)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to TF32: 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).view(t.shape)


class _Ops:
    """Products at the check's precision."""

    def __init__(self, precision: str):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision is 'f32' or 'tf32', got {precision!r}")
        self.round = tf32 if precision == "tf32" else (lambda t: t)

    def mm(self, a, b):
        return torch.matmul(self.round(a), self.round(b))

    def bmm(self, a, b):
        return torch.bmm(self.round(a), self.round(b))


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """x (B, N, H, d): the halves rotated by angle position * theta^(-2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = positions[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _causal(ops, q, k, v, scale, heads_per_block: int = 4):
    """Causal softmax attention of one row: q, k (N, H, d), v (N, H, dv)
    -> (N, H, dv), a few heads at a time."""
    n, h, _ = q.shape
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    out = []
    for lo in range(0, h, heads_per_block):
        hs = slice(lo, lo + heads_per_block)
        s = ops.bmm(q[:, hs].transpose(0, 1),
                    k[:, hs].permute(1, 2, 0)) * scale
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        out.append(ops.bmm(p, v[:, hs].transpose(0, 1)).transpose(0, 1))
    return torch.cat(out, dim=1)


def _attention(ops, p, x, arch: Arch):
    """Full causal self-attention of x (B, N, D), MHA or MLA."""
    b, n, d = x.shape
    h = arch.heads
    pos = torch.arange(n, device=x.device)
    if not arch.mla:
        dh = arch.head_dim
        q = ops.mm(x, p["wq"]).view(b, n, h, dh)
        k = ops.mm(x, p["wk"]).view(b, n, h, dh)
        v = ops.mm(x, p["wv"]).view(b, n, h, dh)
        q, k = _rope(q, pos, arch.rope_theta), _rope(k, pos, arch.rope_theta)
        scale, dv = 1.0 / math.sqrt(dh), dh
    else:
        nope, rope, lora, dv = (arch.qk_nope, arch.qk_rope, arch.kv_lora_rank,
                                arch.v_dim)
        q = ops.mm(x, p["wq"]).view(b, n, h, nope + rope)
        q = torch.cat([q[..., :nope],
                       _rope(q[..., nope:], pos, arch.rope_theta)], dim=-1)
        kv_a = ops.mm(x, p["wkv_a"])
        ckv = _rms(kv_a[..., :lora], p["kv_norm"], arch.eps)
        k_rope = _rope(kv_a[..., None, lora:], pos, arch.rope_theta)
        kv = ops.mm(ckv, p["wkv_b"]).view(b, n, h, nope + dv)
        k = torch.cat([kv[..., :nope], k_rope.expand(b, n, h, rope)], dim=-1)
        v = kv[..., nope:]
        scale = 1.0 / math.sqrt(nope + rope)
    o = torch.stack([_causal(ops, q[i], k[i], v[i], scale) for i in range(b)])
    return ops.mm(o.reshape(b, n, h * dv), p["wo"])


def _mlp(ops, p, x):
    return ops.mm(F.silu(ops.mm(x, p["gate"])) * ops.mm(x, p["up"]),
                  p["down"])


@dataclasses.dataclass
class Routed:
    """One MoE call's routing: each token's experts (T, k) and each
    expert's gathered tokens (E, C), as token indices of the call."""

    experts: torch.Tensor
    tokens: torch.Tensor


def _top(values, k: int):
    """Top ``k`` along the last dim: larger first, lower index first among
    equals."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _members(idx, n: int):
    return torch.zeros(idx.shape[0], n, dtype=torch.bool,
                       device=idx.device).scatter_(1, idx, True)


def _gap(values, pick) -> Tuple[float, int]:
    """(the largest relative distance from the edge of this side's top-k
    of a candidate in one selection and not the other, rows that differ);
    (0.0, 0) when ``pick`` is this side's own top-k row for row."""
    top_v, top_i = _top(values, pick.shape[1])
    n = values.shape[1]
    diff = _members(top_i, n) != _members(pick, n)
    rows = int(diff.any(1).sum())
    if not rows:
        return 0.0, 0
    edge = top_v[:, -1:]
    dist = (values - edge).abs()
    rel = torch.where(edge > 0, dist / edge.clamp(min=1e-30),
                      torch.where(dist > 0, torch.inf, 0.0))
    return float(rel[diff].max()), rows


def _moe_routed(ops, p, z, arch: Arch, forced: Optional[Routed],
                judged: dict, ws) -> Tuple[torch.Tensor, Routed]:
    """The routed experts over one call's tokens z (T, D)."""
    t = z.shape[0]
    probs = torch.softmax(ops.mm(z, p["router"]), dim=-1)
    if forced is None:
        experts = _top(probs, arch.top_k)[1]
    else:
        experts = forced.experts
        gap, rows = _gap(probs, experts)
        judged["token_flips"] += rows
        judged["gap"] = max(judged["gap"], gap)
    vals = probs.gather(1, experts)
    if arch.norm_topk:
        vals = vals / vals.sum(dim=-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(1, experts, vals)
    cap = capacity(arch, t)
    if forced is None:
        tokens = _top(combine.T, cap)[1]
    else:
        tokens = forced.tokens
        gap, rows = _gap(combine.T, tokens)
        judged["capacity_flips"] += rows
        judged["gap"] = max(judged["gap"], gap)
    weight = combine.T.gather(1, tokens)  # (E, C)
    xs = z[tokens]  # (E, C, D)
    wg, wu, wd = ws
    h = F.silu(ops.bmm(xs, wg)) * ops.bmm(xs, wu)
    ys = ops.bmm(h, wd) * weight[..., None]
    out = torch.zeros_like(z).index_add_(0, tokens.reshape(-1),
                                         ys.reshape(-1, z.shape[1]))
    return out, Routed(experts, tokens)


def _layer_params(weights, arch: Arch, li: int):
    """(layer li's parameters, whether it is an MoE layer), from the
    benchmark's stacked tree."""
    if li < arch.dense_layers:
        seg, i, moe = weights["seg0"], li, False
    else:
        seg = weights["seg1" if arch.dense_layers else "seg0"]
        i, moe = li - arch.dense_layers, True

    def pick(tree):
        return ({k: pick(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    return pick(seg), moe


def forward(arch: Arch, weights, tokens: torch.Tensor,
            groups: Sequence[Tuple[int, int]], *,
            route: Optional[List[List[Routed]]] = None,
            precision: str = "f32"):
    """The final-normed hidden states (B, N, D) of ``tokens`` (B, N).

    ``groups``: the MoE calls, each a range [lo, hi) of positions over all
    rows (they cover 0..N in order).  ``route[m][g]``, if given, is the
    routing that MoE layer ``m``'s call on group ``g`` follows (judged as
    the module docstring says).

    Returns (hidden, own routing like ``route``, judged) where ``judged``
    is {"gap", "token_flips", "capacity_flips"} (zeros without ``route``).
    """
    ops = _Ops(precision)
    b, n = tokens.shape
    x = weights["embed"][tokens].float()
    judged = {"gap": 0.0, "token_flips": 0, "capacity_flips": 0}
    own: List[List[Routed]] = []
    for li in range(arch.layers):
        p, moe = _layer_params(weights, arch, li)
        x = x + _attention(ops, p["attn"], _rms(x, p["ln1"], arch.eps), arch)
        z = _rms(x, p["ln2"], arch.eps)
        if not moe:
            x = x + _mlp(ops, p["mlp"], z)
            continue
        m = p["moe"]
        ws = (ops.round(m["wg"]), ops.round(m["wu"]), ops.round(m["wd"]))
        calls = []
        y = torch.empty_like(z)
        for g, (lo, hi) in enumerate(groups):
            forced = None if route is None else route[len(own)][g]
            zg = z[:, lo:hi].reshape(-1, z.shape[-1])
            yg, r = _moe_routed(ops, m, zg, arch, forced, judged, ws)
            y[:, lo:hi] = yg.view(b, hi - lo, -1)
            calls.append(r)
        del ws
        own.append(calls)
        x = x + y + _mlp(ops, m["shared"], z)
    return _rms(x, weights["final_norm"], arch.eps), own, judged


def logits_at(arch: Arch, weights, hidden: torch.Tensor,
              precision: str = "f32") -> torch.Tensor:
    """Logits (..., vocab) of final-normed hidden states (..., D)."""
    ops = _Ops(precision)
    head = weights["embed"].T if arch.tied else weights["head"]
    return ops.mm(hidden, head)[..., :arch.vocab]


def judge_logits(got: torch.Tensor, ref: torch.Tensor,
                 served: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Rows of logits (R, V) against the reference's: the largest gap
    ``max |got - ref|`` over the row's ``max |ref|``, and, for ``served``
    tokens (R,), the largest amount by which a served token's reference
    logit lies below the row's best, over the same scale."""
    got, ref = got.double(), ref.double()
    scale = ref.abs().amax(dim=-1).clamp(min=1e-30)
    out = {"logit_err": float(((got - ref).abs().amax(dim=-1) / scale).max())}
    if served is not None:
        below = ref.amax(dim=-1) - ref.gather(1, served[:, None].long())[:, 0]
        out["token_gap"] = float((below / scale).max())
    return out
