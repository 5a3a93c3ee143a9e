"""The DeepSeek MoE family: deepseek-moe-16b (MHA) and DeepSeek-V2-Lite
(MLA), a dense first ``first_k_dense_replace`` layers and then MoE layers
of routed and shared experts.  Its plain reference is
``reference/model.py``.

Its check (``judge``), for each sampled request: the reference runs once
over the prompt and the served tokens (the last one excepted), with the
MoE calls grouped as the program made them (the prompt, then each decode
step), and follows the program's routing, judging each choice.  Numbers:

- ``route_gap``: the largest relative distance of a routing choice of the
  program (a token's experts, an expert's tokens) from the reference's
  own choice's edge, under the reference's numbers; 0 when every choice
  is the reference's;
- ``logit_err``: the largest ``max |program - reference|`` of a served
  position's logits over the row's ``max |reference|``;
- ``token_gap``: the largest amount by which a served token's reference
  logit lies below the row's best, over the same scale.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model as R
from portbench.weights import Leaf, vocab_padded
from portbench.yardstick import live_pairs

NUMBERS = ("route_gap", "logit_err", "token_gap")

# the port's ``ArchConfig.reduced`` widths, under the published names
_TINY = dict(hidden_size=128, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=4, intermediate_size=256, vocab_size=512,
             n_routed_experts=8, num_experts_per_tok=2,
             moe_intermediate_size=64, n_shared_experts=1)
_TINY_MLA = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16)


def TINY(c: dict) -> dict:
    """Configuration file ``c`` at the CPU tests' size."""
    c = dict(c, **_TINY)
    if c.get("kv_lora_rank"):
        c.update(_TINY_MLA)
    return c


def port_config(c: dict):
    """The port's ``ArchConfig`` for configuration file ``c``: its
    registry entry (family, attention kind) with every size and rule taken
    from the file."""
    from repro_torch.configs import get_config

    if not c["runs"]["norm_topk_prob"] or c["runs"]["rope_scaling"]:
        raise ValueError("the port renormalises the chosen experts' "
                         "probabilities and runs plain RoPE")
    h = c["num_attention_heads"]
    fields = dict(
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=h, num_kv_heads=c.get("num_key_value_heads") or h,
        head_dim=c.get("head_dim") or c["hidden_size"] // h,
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        moe_top_k=c["num_experts_per_tok"],
        moe_d_ff=c["moe_intermediate_size"],
        first_dense_layers=c["first_k_dense_replace"],
        rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["runs"]["norm_eps"]),
        tie_embeddings=bool(c["runs"]["tie_embeddings"]),
        capacity_factor=float(c["runs"]["capacity_factor"]))
    if c.get("kv_lora_rank"):
        fields.update(kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_dim=c["qk_nope_head_dim"],
                      qk_rope_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"])
    return dataclasses.replace(get_config(c["runs"]["registry"]), **fields)


def layout(c: dict) -> List[Leaf]:
    """Every leaf of configuration file ``c`` in the port's tree: (path,
    shape, scale), scale 0 meaning a norm's ones."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    kh = c.get("num_key_value_heads") or h
    vp = vocab_padded(c["vocab_size"])
    leaves: List[Leaf] = [(("embed",), (vp, d), 0.02)]

    def dense(path, n, fan_in, out):
        leaves.append((path, (n, fan_in) + tuple(out), fan_in ** -0.5))

    def block(seg: str, n: int, moe: bool):
        leaves.append(((seg, "ln1"), (n, d), 0.0))
        a = (seg, "attn")
        if c.get("kv_lora_rank"):
            nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
            lora, dv = c["kv_lora_rank"], c["v_head_dim"]
            dense(a + ("wq",), n, d, (h * (nope + rope),))
            dense(a + ("wkv_a",), n, d, (lora + rope,))
            leaves.append((a + ("kv_norm",), (n, lora), 0.0))
            dense(a + ("wkv_b",), n, lora, (h * (nope + dv),))
            dense(a + ("wo",), n, h * dv, (d,))
        else:
            dh = c.get("head_dim") or d // h
            dense(a + ("wq",), n, d, (h * dh,))
            dense(a + ("wk",), n, d, (kh * dh,))
            dense(a + ("wv",), n, d, (kh * dh,))
            dense(a + ("wo",), n, h * dh, (d,))
        leaves.append(((seg, "ln2"), (n, d), 0.0))
        if moe:
            e, f = c["n_routed_experts"], c["moe_intermediate_size"]
            m = (seg, "moe")
            dense(m + ("router",), n, d, (e,))
            leaves.append((m + ("wg",), (n, e, d, f), d ** -0.5))
            leaves.append((m + ("wu",), (n, e, d, f), d ** -0.5))
            leaves.append((m + ("wd",), (n, e, f, d), f ** -0.5))
            fs = c["n_shared_experts"] * f
            dense(m + ("shared", "gate"), n, d, (fs,))
            dense(m + ("shared", "up"), n, d, (fs,))
            dense(m + ("shared", "down"), n, fs, (d,))
        else:
            ff = c["intermediate_size"]
            dense((seg, "mlp", "gate"), n, d, (ff,))
            dense((seg, "mlp", "up"), n, d, (ff,))
            dense((seg, "mlp", "down"), n, ff, (d,))

    n_dense = c["first_k_dense_replace"]
    segs = [("dense", n_dense)] if n_dense else []
    segs.append(("moe", c["num_hidden_layers"] - n_dense))
    for i, (kind, n) in enumerate(segs):
        block(f"seg{i}", n, kind == "moe")
    leaves.append((("final_norm",), (d,), 0.0))
    if not c["tie_word_embeddings"]:
        leaves.append((("head",), (d, vp), d ** -0.5))
    return leaves


def reference_inputs(arch: R.Arch, served, device):
    """(tokens (B, N), groups, route, logit positions) of one served
    request for the reference: the prompt and the served tokens but the
    last, the prompt as one MoE call and each decode step as one, the
    program's routing per MoE layer and call."""
    req = served.request
    s, gen = req.prompt_len, req.gen_tokens
    ids = np.concatenate([req.tokens, served.tokens[:, :gen - 1]], axis=1)
    groups = [(0, s)] + [(s + j, s + j + 1) for j in range(gen - 1)]
    n_moe = arch.layers - arch.dense_layers
    calls = served.routing
    if calls is None or len(calls) != n_moe * len(groups):
        raise ValueError(f"{len(calls or ())} MoE calls recorded, expected "
                         f"{n_moe} layers x {len(groups)} calls")
    b = req.tokens.shape[0]
    for g, (lo, hi) in enumerate(groups):
        t = b * (hi - lo)
        want = ((t, arch.top_k), (arch.experts, R.capacity(arch, t)))
        for m in range(n_moe):
            got = tuple(tuple(x.shape) for x in calls[g * n_moe + m])
            if got != want:
                raise ValueError(f"MoE call {g * n_moe + m} routed shapes "
                                 f"{got}, expected {want}")
    route = [[R.Routed(calls[g * n_moe + m][0].to(device),
                       calls[g * n_moe + m][1].to(device))
              for g in range(len(groups))] for m in range(n_moe)]
    positions = [s - 1 + j for j in range(gen)]
    return (torch.from_numpy(ids).to(device), groups, route, positions)


def judge(c: dict, weights, samples, precision: str = "f32"
          ) -> Dict[str, float]:
    """``route_gap``, ``logit_err`` and ``token_gap`` over ``samples``
    (``harness.Served`` with logits and routing)."""
    if not samples:
        return {}
    arch = R.Arch.from_file(c)
    device = weights["embed"].device
    out = dict.fromkeys(NUMBERS, 0.0)
    for got in samples:
        try:
            ids, groups, route, positions = reference_inputs(arch, got,
                                                             device)
        except ValueError:  # the program's routing is malformed
            return {k: float("inf") for k in out}
        with torch.no_grad():
            hidden, _, judged = R.forward(arch, weights, ids, groups,
                                          route=route, precision=precision)
            ref = R.logits_at(arch, weights, hidden[:, positions],
                              precision)  # (B, gen, V)
        b = ref.shape[0]
        ref = ref.reshape(-1, ref.shape[-1]).cpu()
        prog = got.logits.transpose(0, 1).reshape(ref.shape[0], -1)
        prog = prog[:, :arch.vocab]
        served = torch.from_numpy(got.tokens).reshape(b * len(positions))
        nums = R.judge_logits(prog, ref, served)
        out["route_gap"] = max(out["route_gap"], judged["gap"])
        for k in ("logit_err", "token_gap"):
            out[k] = max(out[k], nums[k])
        del hidden, ref
    return out


def flash_launches(c: dict, b: int, s: int) -> list:
    """One prefill's flash launches, one a layer: (b, s, h, kh, d, dv,
    causal); MLA's at its query/key width (nope + rope) and V width, over
    as many key heads as query heads."""
    h = c["num_attention_heads"]
    kh = c.get("num_key_value_heads") or h
    if c.get("kv_lora_rank"):
        d = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
        dv, kh = c["v_head_dim"], h
    else:
        d = dv = c.get("head_dim") or c["hidden_size"] // h
    return [(b, s, h, kh, d, dv, True)] * c["num_hidden_layers"]


def prefill_flops(c: dict, b: int, s: int) -> float:
    """Operations of the published model's prefill of ``b`` prompts of
    ``s`` tokens: every layer's projections, causal attention over the live
    pairs, the dense MLP or the shared and the ``num_experts_per_tok``
    active routed experts and the router, and the LM head on each prompt's
    last position (what ``prefill`` returns).  Norms and softmaxes are not
    counted; nor is the work the program pads or drops."""
    dm, h = c["hidden_size"], c["num_attention_heads"]
    kh = c.get("num_key_value_heads") or h
    if c.get("kv_lora_rank"):
        nope, rope, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"])
        lora = c["kv_lora_rank"]
        proj = dm * h * (nope + rope) + dm * (lora + rope) \
            + lora * h * (nope + dv) + h * dv * dm
        attn_dims = nope + rope + dv
    else:
        dh = c.get("head_dim") or dm // h
        proj = dm * h * dh + 2 * dm * kh * dh + h * dh * dm
        attn_dims = 2 * dh
    tokens = b * s
    per_layer_attn = 2.0 * proj * tokens \
        + 2.0 * attn_dims * live_pairs(s) * b * h
    dense = 2.0 * 3 * dm * c["intermediate_size"] * tokens
    f = c["moe_intermediate_size"]
    active = c["num_experts_per_tok"] + c["n_shared_experts"]
    moe = (2.0 * 3 * dm * f * active + 2.0 * dm * c["n_routed_experts"]) \
        * tokens
    n_dense = c["first_k_dense_replace"]
    n_moe = c["num_hidden_layers"] - n_dense
    head = 2.0 * dm * c["vocab_size"] * b
    return c["num_hidden_layers"] * per_layer_attn + n_dense * dense \
        + n_moe * moe + head
