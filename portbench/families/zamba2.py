"""The Zamba2 family: Zamba2-7B-Instruct, Mamba2 layers with two
weight-shared transformer blocks at the published ``hybrid_layer_ids``
(each use with its own adapter and ``linear``), run through the port's
``zamba2-7b-instruct``.  Its plain reference is ``reference/zamba2.py``.

Its check (``judge``), for each sampled request: the reference runs once
over the prompt and the served tokens (the last one excepted); numbers:

- ``logit_err``: the largest ``max |program - reference|`` of a served
  position's logits over the row's ``max |reference|``;
- ``token_gap``: the largest amount by which a served token's reference
  logit lies below the row's best, over the same scale.

A prefill hands each mixer's SSM and conv state to decode, so a served
token after the first is judged against the reference's full forward
over everything before it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import model as R
from portbench.reference import zamba2 as Z
from portbench.weights import Leaf, vocab_padded
from portbench.yardstick import live_pairs

NUMBERS = ("logit_err", "token_gap")

# the published structure at the CPU tests' size: 6 layers with four uses
# over both blocks, 2 groups, an adapter of rank 8 below the width 64
_TINY = dict(hidden_size=64, num_hidden_layers=6, num_attention_heads=4,
             num_key_value_heads=4, num_query_groups=4,
             attention_hidden_size=128, attention_head_dim=32, kv_channels=16,
             intermediate_size=128, ffn_hidden_size=128, vocab_size=300,
             mamba_d_state=16, n_mamba_heads=8, mamba_headdim=16,
             adapter_rank=8, chunk_size=16, hybrid_layer_ids=[1, 2, 4, 5],
             layers_block_type=["mamba", "hybrid", "hybrid", "mamba",
                                "hybrid", "hybrid"])


def TINY(c: dict) -> dict:
    """Configuration file ``c`` at the CPU tests' size (the port's SSD
    chunk 8)."""
    return dict(c, **_TINY, runs=dict(c["runs"], ssd_chunk=8))


def port_config(c: dict):
    """The port's ``Zamba2Config`` for configuration file ``c``: its
    registry entry with every size taken from the file, the SSD at the
    chunk ``runs.ssd_chunk``."""
    from repro_torch.configs import get_config

    Z.Arch.from_file(c)  # refuses what neither the reference nor port runs
    d, h = c["hidden_size"], c["num_attention_heads"]
    if c["mamba_expand"] * d != c["n_mamba_heads"] * c["mamba_headdim"]:
        raise ValueError("n_mamba_heads * mamba_headdim must be "
                         "mamba_expand * hidden_size")
    return dataclasses.replace(
        get_config(c["runs"]["registry"]),
        num_layers=c["num_hidden_layers"], d_model=d, num_heads=h,
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["attention_head_dim"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], ssm_state=c["mamba_d_state"],
        ssm_expand=c["mamba_expand"], ssm_headdim=c["mamba_headdim"],
        ssm_conv=c["mamba_d_conv"], ssm_ngroups=c["mamba_ngroups"],
        ssm_chunk=c["runs"]["ssd_chunk"],
        hybrid_layer_ids=tuple(c["hybrid_layer_ids"]),
        n_shared_attn_blocks=c["num_mem_blocks"],
        hybrid_concat_embed=True, adapter_rank=c["adapter_rank"],
        mlp_act="gelu", attn_scale=(c["attention_head_dim"] / 2) ** -0.5,
        norm_eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c["runs"]["tie_embeddings"]),
        prefill_ssm_state=True)


def layout(c: dict) -> List[Leaf]:
    """Every leaf of configuration file ``c`` in the port's tree: (path,
    shape, scale), scale 0 meaning a norm's ones.  ``A_log`` and
    ``dt_bias`` are standard normals (A = -exp(A_log) spread over some
    e-folds, dt = softplus(. + dt_bias) from ~0.05 to ~3), ``D`` ones."""
    d, h, dh = (c["hidden_size"], c["num_attention_heads"],
                c["attention_head_dim"])
    kh, f, r = c["num_key_value_heads"], c["intermediate_size"], \
        c["adapter_rank"]
    n, hs, k = c["mamba_ngroups"] * c["mamba_d_state"], c["n_mamba_heads"], \
        c["mamba_d_conv"]
    di, nl = c["mamba_expand"] * d, c["num_hidden_layers"]
    nb, uses = c["num_mem_blocks"], len(c["hybrid_layer_ids"])
    leaves: List[Leaf] = [(("embed",), (vocab_padded(c["vocab_size"]), d),
                           0.02)]

    def dense(path, m, fan_in, out):
        leaves.append((path, (m, fan_in) + tuple(out), fan_in ** -0.5))

    m = ("seg0", "mixer")
    leaves.append((("seg0", "ln"), (nl, d), 0.0))
    leaves += [(m + ("A_log",), (nl, hs), 1.0), (m + ("D",), (nl, hs), 0.0),
               (m + ("dt_bias",), (nl, hs), 1.0),
               (m + ("norm",), (nl, di), 0.0)]
    dense(m + ("out_proj",), nl, di, (d,))
    dense(m + ("in_proj",), nl, d, (2 * di + 2 * n + hs,))
    leaves += [(m + ("conv_w",), (nl, k, di + 2 * n), k ** -0.5),
               (m + ("conv_b",), (nl, di + 2 * n), k ** -0.5)]
    s = ("shared_attn",)
    leaves.append((s + ("ln1",), (nb, 2 * d), 0.0))
    dense(s + ("attn", "wq"), nb, 2 * d, (h * dh,))
    dense(s + ("attn", "wk"), nb, 2 * d, (kh * dh,))
    dense(s + ("attn", "wv"), nb, 2 * d, (kh * dh,))
    dense(s + ("attn", "wo"), nb, h * dh, (d,))
    leaves.append((s + ("ln2",), (nb, d), 0.0))
    dense(s + ("mlp", "gate"), nb, d, (f,))
    dense(s + ("mlp", "up"), nb, d, (f,))
    dense(s + ("mlp", "down"), nb, f, (d,))
    dense(("hybrid", "linear"), uses, d, (d,))
    dense(("hybrid", "adapter_a"), uses, d, (r,))
    dense(("hybrid", "adapter_b"), uses, r, (2 * f,))
    leaves.append((("final_norm",), (d,), 0.0))
    return leaves


def judge(c: dict, weights, samples, precision: str = "f32"
          ) -> Dict[str, float]:
    """``logit_err`` and ``token_gap`` over ``samples`` (``harness.Served``
    with logits), from the f32 reference."""
    if precision != "f32":
        raise ValueError(f"the Zamba2 reference runs f32, not {precision!r}")
    if not samples:
        return {}
    arch = Z.Arch.from_file(c)
    device = weights["embed"].device
    out = dict.fromkeys(NUMBERS, 0.0)
    for got in samples:
        req = got.request
        s, gen = req.prompt_len, req.gen_tokens
        ids = np.concatenate([req.tokens, got.tokens[:, :gen - 1]], axis=1)
        positions = [s - 1 + j for j in range(gen)]
        with torch.no_grad():
            hidden = Z.forward(arch, weights,
                               torch.from_numpy(ids).to(device))
            ref = Z.logits_at(arch, weights, hidden[:, positions])
        b = ref.shape[0]
        ref = ref.reshape(-1, ref.shape[-1]).cpu()
        prog = got.logits.transpose(0, 1).reshape(ref.shape[0], -1)
        served = torch.from_numpy(got.tokens).reshape(b * gen)
        nums = R.judge_logits(prog[:, :arch.vocab], ref, served)
        for k in out:
            out[k] = max(out[k], nums[k])
        del hidden, ref
    return out


def flash_launches(c: dict, b: int, s: int) -> list:
    """One prefill's flash launches, one a use of a shared block: (b, s, h,
    kh, d, dv, causal)."""
    h, dh = c["num_attention_heads"], c["attention_head_dim"]
    return [(b, s, h, c["num_key_value_heads"], dh, dh, True)] * \
        len(c["hybrid_layer_ids"])


def ssd_launches(c: dict, b: int, s: int) -> list:
    """One prefill's SSD scans, one a Mamba layer: (b, s, heads, headdim,
    state, groups)."""
    return [(b, s, c["n_mamba_heads"], c["mamba_headdim"],
             c["mamba_d_state"], c["mamba_ngroups"])] * c["num_hidden_layers"]


def _ssd_ops(c: dict, b: int, s: int, h: int, p: int, n: int,
             g: int) -> float:
    """Operations of one chunked SSD at the published ``chunk_size`` Q:
    C B^T once per (batch, chunk, group), and per (batch, head, chunk) the
    intra-chunk scores over the lower triangle against x, C h^T and the
    state update."""
    q = c["chunk_size"]
    nc = -(-s // q)
    return 2.0 * q * q * n * b * nc * g \
        + (q * (q + 1) * p + 4.0 * q * p * n) * b * h * nc


def ssd_cost(c: dict, b: int, s: int, h: int, p: int, n: int,
             g: int) -> tuple:
    """(operations, bytes) of one SSD launch: the operations at the
    published chunk, whatever chunk the program runs; x, dt, B and C read
    once and y written once, in f32."""
    nbytes = 4.0 * b * s * (2 * h * p + h + 2 * g * n)
    return _ssd_ops(c, b, s, h, p, n, g), nbytes


def prefill_flops(c: dict, b: int, s: int) -> float:
    """Operations of the published model's prefill of ``b`` prompts of
    ``s`` tokens: each Mamba layer's in and out projections and its SSD
    (at the published chunk), each shared-block use's q, k, v and o
    projections, causal attention over the live pairs, its adapter, MLP
    and ``linear``, and the tied head on each prompt's last position.
    Norms, softmaxes, the depthwise conv and gates are not counted."""
    d, h, dh = (c["hidden_size"], c["num_attention_heads"],
                c["attention_head_dim"])
    kh, f, r = c["num_key_value_heads"], c["intermediate_size"], \
        c["adapter_rank"]
    di = c["mamba_expand"] * d
    hs, gn = c["n_mamba_heads"], c["mamba_ngroups"] * c["mamba_d_state"]
    tokens = b * s
    mamba = 2.0 * (d * (2 * di + 2 * gn + hs) + di * d) * tokens
    ssd = sum(_ssd_ops(c, *x) for x in ssd_launches(c, b, s))
    proj = 2 * d * (h + 2 * kh) * dh + h * dh * d
    use = 2.0 * (proj + d * 2 * f + r * (d + 2 * f) + f * d + d * d) \
        * tokens + 2.0 * 2 * dh * live_pairs(s) * b * h
    head = 2.0 * d * c["vocab_size"] * b
    return c["num_hidden_layers"] * mamba + ssd \
        + len(c["hybrid_layer_ids"]) * use + head
