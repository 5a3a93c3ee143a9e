"""The benchmark's fixed arithmetic against hand counts at small shapes."""

import pytest

from portbench import yardstick as Y

SMALL = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 2, "intermediate_size": 16,
         "moe_intermediate_size": 4, "n_routed_experts": 4,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "first_k_dense_replace": 1, "num_hidden_layers": 2,
         "vocab_size": 32,
         "runs": {"family": "deepseek_moe"}}


@pytest.mark.parametrize("s", [1, 2, 5, 17])
def test_live_pairs_counts_the_causal_triangle(s):
    assert Y.live_pairs(s) == sum(q + 1 for q in range(s))
    assert Y.live_pairs(s, causal=False) == s * s


def test_flash_cost_by_hand():
    # b=1, s=4, h=2, kh=1, d=8, dv=4: 10 live pairs a head
    ops, nbytes = Y.flash_cost(1, 4, 2, 1, 8, 4)
    assert ops == 2 * (8 + 4) * 10 * 2
    assert nbytes == 4 * (4 * 2 * 12 + 4 * 1 * 12)


def test_prefill_flops_mha_by_hand():
    # per layer: q, k, v, o 2 * 4 * 64 a token over 3 tokens, and
    # 2 * (4 + 4) * 6 pairs * 2 heads of attention
    attn = 2 * 256 * 3 + 2 * 8 * 6 * 2
    dense = 2 * 3 * 8 * 16 * 3
    moe = (2 * 3 * 8 * 4 * 3 + 2 * 8 * 4) * 3  # 2 routed + 1 shared, router
    head = 2 * 8 * 32
    assert Y.prefill_flops(SMALL, 1, 3) == 2 * attn + dense + moe + head


def test_prefill_flops_mla_by_hand():
    c = dict(SMALL, kv_lora_rank=4, qk_nope_head_dim=2, qk_rope_head_dim=2,
             v_head_dim=3)
    proj = 8 * 2 * 4 + 8 * 6 + 4 * 2 * 5 + 2 * 3 * 8
    attn = 2 * proj * 3 + 2 * (2 + 2 + 3) * 6 * 2
    dense = 2 * 3 * 8 * 16 * 3
    moe = (2 * 3 * 8 * 4 * 3 + 2 * 8 * 4) * 3
    assert Y.prefill_flops(c, 1, 3) == 2 * attn + dense + moe + 2 * 8 * 32


def test_flash_bound_takes_the_slower_roof():
    c = dict(SMALL, num_attention_heads=16, num_key_value_heads=16,
             hidden_size=2048, num_hidden_layers=1)
    ops, nbytes = Y.flash_cost(1, 4096, 16, 16, 128, 128)
    assert Y.flash_bound_s(c, 1, 4096) == pytest.approx(
        max(ops / 165e12, nbytes / 3.35e12))
    assert ops / 165e12 > nbytes / 3.35e12  # long prompts: compute-bound


def test_busy_union_and_idle_gaps():
    busy = Y.busy_intervals([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy == [(0, 3), (5, 8)]
    assert Y.idle_gaps(busy, 0, 10) == [(3, 5), (8, 10)]
    assert Y.idle_gaps(busy, 1, 6) == [(3, 5)]
    assert Y.idle_gaps([], 2, 4) == [(2, 4)]
