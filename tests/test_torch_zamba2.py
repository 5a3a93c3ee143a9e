"""The port's published Zamba2 path (``zamba2-7b-instruct``) on the CPU:
the grouped SSD scan and its final state against the stepwise recurrence,
a prefill that hands its SSM and conv state to decode (prefill and decode
steps against the port's own full forward; with the state left at zero,
as the reference's ``zamba2-7b`` leaves it, the first decode step is far
off), and the spans of a traced prefill and decode step.

Tolerances, f32 on the CPU: the chunked scan to the recurrence 1e-4 (its
suite's, ``tests/test_torch_ssd.py``), its state 1e-4 of the largest;
prefill and decode logits to the forward's 1e-5 of the row's largest.
The reduced config: 6 layers, shared-block uses at layers 1, 2, 4 and 5
(blocks 0, 1, 0, 1), 2 groups of B and C, adapters of rank 8, d_model
128, 4 heads of 64 on the 256-wide concatenated input, SSD chunk 8."""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ssd_ref, ssd_scan_plain
from repro_torch.kernels.ssd.ops import ssd_flops
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill)
from repro_torch.obs import Tracer, tracing

ARCH = "zamba2-7b-instruct"
BATCH, S, STEPS = 2, 16, 3


def ssd_inputs(b, t, h, p, n, g, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=gen))
    a_log = torch.log(torch.linspace(0.5, 4.0, h))
    bb = torch.randn((b, t, g, n), generator=gen)
    cc = torch.randn((b, t, g, n), generator=gen)
    return x, dt, a_log, bb, cc, torch.randn(h, generator=gen)


@pytest.mark.parametrize("shape", [(2, 32, 4, 8, 16, 2, 8),
                                   (1, 48, 6, 4, 8, 3, 16),
                                   (1, 24, 4, 8, 8, 4, 4)],
                         ids=["g2", "g3", "g4_one_head_each"])
def test_grouped_scan_and_final_state_follow_the_recurrence(shape):
    *dims, chunk = shape
    x, dt, a_log, bb, cc, d = ssd_inputs(*dims)
    want, h_want = ssd_ref(x, dt, a_log, bb, cc, d, final_state=True)
    y, h_t = ssd_scan_plain(x, dt, -torch.exp(a_log), bb, cc, d, chunk=chunk,
                            final_state=True)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    assert h_t.shape == (dims[0], dims[2], dims[3], dims[4])
    assert (h_t - h_want).abs().max() <= 1e-4 * h_want.abs().max()
    # a group's heads read that group's B and C alone
    g = dims[5]
    alone = ssd_ref(x, dt, a_log, bb[:, :, :1].expand_as(bb).contiguous(),
                    cc[:, :, :1].expand_as(cc).contiguous(), d)
    hpg = dims[2] // g
    torch.testing.assert_close(alone[:, :, :hpg], want[:, :, :hpg])
    assert not torch.allclose(alone[:, :, hpg:], want[:, :, hpg:], atol=1e-2)


def test_one_group_is_the_shared_b_and_c():
    x, dt, a_log, bb, cc, d = ssd_inputs(2, 32, 4, 8, 16, 1)
    a_neg = -torch.exp(a_log)
    shared = ssd_scan_plain(x, dt, a_neg, bb[:, :, 0], cc[:, :, 0], d,
                            chunk=8)
    grouped = ssd_scan_plain(x, dt, a_neg, bb, cc, d, chunk=8)
    torch.testing.assert_close(grouped, shared, rtol=1e-6, atol=1e-6)
    assert torch.equal(shared, ssd_scan_plain(x, dt, a_neg, bb[:, :, 0],
                                              cc[:, :, 0], d, chunk=8,
                                              final_state=True)[0])
    assert ssd_flops(1, 64, 4, 8, 16, 8, 2) - ssd_flops(1, 64, 4, 8, 16, 8) \
        == 2.0 * 8 * 8 * 16 * 8  # one more C B^T a chunk


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    # the forward over a whole number of SSD chunks (causal: the positions
    # served are unaffected by the ones after them)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, S + 8),
                           generator=torch.Generator().manual_seed(1))
    full, _ = forward(cfg, params, {"tokens": tokens}, remat="none")
    return cfg, params, tokens, full


def served(cfg, params, tokens):
    """Prefill logits of the first S tokens and one decode step's logits
    for each of the next STEPS tokens."""
    cache = init_cache(cfg, BATCH, S + STEPS)
    out = [prefill(cfg, params, cache, {"tokens": tokens[:, :S]})[0]]
    for j in range(S, S + STEPS):
        out.append(decode_step(cfg, params, cache, tokens[:, j:j + 1], j)[0])
    return out


def test_the_reduced_config_keeps_the_published_structure(tiny):
    cfg, params, _, _ = tiny
    assert cfg.hybrid_layer_ids == (1, 2, 4, 5) and cfg.ssm_ngroups == 2
    assert cfg.adapter_rank < cfg.d_model and cfg.prefill_ssm_state
    assert params["shared_attn"]["attn"]["wq"].shape == (
        2, 2 * cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert params["hybrid"]["linear"].shape == (4, cfg.d_model, cfg.d_model)
    assert params["seg0"]["mixer"]["in_proj"].shape[-1] == \
        2 * cfg.d_inner + 2 * 2 * cfg.ssm_state + cfg.ssm_heads
    assert "hybrid" not in init_params(get_config("zamba2-7b").reduced(),
                                       torch.Generator().manual_seed(0))


def test_prefill_hands_its_state_to_decode(tiny):
    cfg, params, tokens, full = tiny
    for j, got in enumerate(served(cfg, params, tokens), start=S - 1):
        want = full[:, j]
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), j
    zero = dataclasses.replace(cfg, prefill_ssm_state=False)
    first = served(zero, params, tokens)[1]
    assert (first - full[:, S]).abs().max() > 1e-2 * full[:, S].abs().max()


def tree(records):
    """(name, attrs, children) of each root span, children in order."""
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)

    def node(r):
        return (r.name, dict(r.attrs),
                [node(c) for c in sorted(kids.get(r.sid, []),
                                         key=lambda c: c.ts)])

    return [node(r) for r in kids[None]]


@pytest.mark.parametrize("step", ["prefill", "decode_step"])
def test_spans_of_the_published_hybrid_layer(tiny, step):
    cfg, params, tokens, _ = tiny
    cache = init_cache(cfg, BATCH, S + 1)
    tr = Tracer()
    if step == "decode_step":
        prefill(cfg, params, cache, {"tokens": tokens[:, :S]})
    with tracing(tr):
        if step == "prefill":
            prefill(cfg, params, cache, {"tokens": tokens[:, :S]})
        else:
            decode_step(cfg, params, cache, tokens[:, S:S + 1], S)
    (root,) = tree(tr.records)
    assert root[0] == f"model.{step}"
    layers = [c for c in root[2] if c[0] == "model.layer"]
    assert len(layers) == cfg.num_layers
    for li, (_, attrs, inner) in enumerate(layers):
        names = [c[0] for c in inner]
        if li in cfg.hybrid_layer_ids:
            use = cfg.hybrid_layer_ids.index(li)
            assert names == ["model.hybrid", "model.ssm"]
            assert inner[0][1] == {"use": use, "block": use % 2}
            assert [c[0] for c in inner[0][2]] == ["model.attn", "model.ffn"]
        else:
            assert names == ["model.ssm"]
