"""The port's int8 KV cache (``kv_cache_dtype="int8"``:
``repro_torch.models.blocks._kv_quant``/``_kv_dequant`` and the int8
branches of ``attn_prefill``, ``attn_decode`` and ``attn_cache_shape``)
against the reference's.

The quantiser is held bit for bit on equal inputs: half-points (where
``torch.round`` and ``jnp.round`` both round half to even), all-zero heads
(the scale floored at 1e-8) and seeded normal rows.  Through a model the
K and V being quantised differ from the reference's in the last bits (the
projections run in another library), so a payload may differ by one where
``x / scale`` lies within rounding of a half-integer: each such entry is
counted, must differ by exactly one, and must lie within 1e-4 of a
half-integer on the port's own unquantised values; there may be at most
one in 1000.  Scales to 1e-5 relative; logits to 1e-4 over a prefill and
8 greedy decode steps with equal tokens.  Models: the reduced
h2o-danube-3-4b (GQA 4:2, sliding window 16) and zamba2-7b (its two
shared-attention applications each with an int8 cache).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.blocks as ref_blocks
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill)
from repro_torch.models import blocks as B

TOL = 1e-4
BATCH, S, STEPS = 2, 32, 8
FLIP_SHARE = 1e-3  # payload entries allowed to differ by one
HALF_GAP = 1e-4  # |x / scale - (n + 1/2)| of an entry that may differ


def quant_inputs():
    """(rows, 8) f32: half-points at scales 1 and 0.5, an all-zero head,
    a tiny head, and seeded normal rows."""
    halves = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5],
                       [63.5, 1.25, -1.75, 0.25, 0.75, -0.25, 2.25, 3.25],
                       [0.0] * 8,
                       [1e-30, 0.0, -1e-30, 0.0, 0.0, 0.0, 0.0, 0.0]],
                      np.float32)
    rng = np.random.default_rng(0)
    normal = rng.standard_normal((2, 3, 4, 8)).astype(np.float32) * 3
    return np.concatenate([halves, normal.reshape(-1, 8)])


def test_quant_and_dequant_are_the_reference_bit_for_bit():
    """Against the jitted reference, as its models run it: XLA folds the
    division by 127 into a product with f32(1/127) there."""
    x = quant_inputs()
    jq, js = jax.jit(ref_blocks._kv_quant)(jnp.asarray(x))
    q, s = B._kv_quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # half to even at scale 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126
    assert q[0].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert q[1].tolist() == [127, 2, -4, 0, 2, 0, 4, 6]
    assert not q[2].any() and float(s[2]) == np.float32(1e-8)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = ref_blocks._kv_dequant(jq, js.astype(jdtype), jdtype)
        got = B._kv_dequant(q, s.to(dtype), dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_int8_cache_has_the_reference_layout():
    for arch in ("h2o-danube-3-4b", "zamba2-7b", "deepseek-v2-lite-16b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  kv_cache_dtype="int8")
        jcfg = dataclasses.replace(ref_configs.get_config(arch).reduced(),
                                   kv_cache_dtype="int8")
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            want = jax.eval_shape(functools.partial(
                ref_models.init_cache, jcfg, BATCH, S, dtype=jdtype))
            got = init_cache(cfg, BATCH, S, dtype=dtype)
            assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
                jax.tree.map(lambda t: (tuple(t.shape),
                                        str(t.dtype).split(".")[-1]), got)


def int8_models(arch):
    jcfg = dataclasses.replace(ref_configs.get_config(arch).reduced(),
                               kv_cache_dtype="int8")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              kv_cache_dtype="int8")
    jp = jax.jit(functools.partial(ref_models.init_params, jcfg,
                                   dtype=jnp.float32))(jax.random.PRNGKey(0))
    return cfg, jcfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                              jp), "cpu")


def attn_caches(cache):
    """name -> the stacked attention caches of a model's cache tree."""
    return {seg: c for seg, c in cache.items() if "k" in c}


def payload_flips(got, want, unquantised) -> int:
    """Entries where the two int8 payloads differ: each by exactly one; at
    the prompt's positions, where ``unquantised`` holds the port's own K
    and V (the decode steps' hidden states differ between an int8 and a
    float cache), each at a near half-point of ``x / scale``."""
    flips = 0
    for name in ("k", "v"):
        g = got[name].numpy().astype(int)
        w = np.asarray(want[name]).astype(int)
        diff = g != w
        assert np.abs(g - w).max(initial=0) <= 1, name
        ratio = (unquantised[name][:, :, :S].float()
                 / got[f"{name}_scale"][:, :, :S].float()[..., None]).numpy()
        gap = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5)
        assert (gap[diff[:, :, :S]] <= HALF_GAP).all(), name
        flips += int(diff.sum())
        np.testing.assert_allclose(
            got[f"{name}_scale"].numpy(), np.asarray(want[f"{name}_scale"]),
            rtol=1e-5, atol=0, err_msg=f"{name}_scale")
    return flips


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-7b"])
def test_int8_prefill_and_decode_match_the_reference(arch):
    cfg, jcfg, jp, params = int8_models(arch)
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens)})
    cache = init_cache(cfg, BATCH, s_max)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    logits, _ = prefill(cfg, params, cache, batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    # the same prefill into a float cache: the port's unquantised K and V
    dense = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    fcache = init_cache(dense, BATCH, s_max)
    flogits, _ = prefill(dense, params, fcache, batch)
    assert torch.equal(flogits, logits)  # the prefill attends unquantised
    ref_decode = jax.jit(functools.partial(ref_models.decode_step, jcfg))
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_decode(jp, jcache, jtok, jnp.asarray(S + i))
        logits, _ = decode_step(cfg, params, cache, tok, S + i)
        decode_step(dense, params, fcache, tok, S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    segs = attn_caches(cache)
    assert sorted(segs) == (["shared_attn"] if arch == "zamba2-7b"
                            else ["seg0"])
    flips, entries = 0, 0
    for seg, c in segs.items():
        assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == \
            torch.float32
        flips += payload_flips(c, jcache[seg], fcache[seg])
        entries += 2 * c["k"].numel()
        # over the prompt the dequantised cache lies within half a quantum
        # of the port's own unquantised K and V
        for name in ("k", "v"):
            deq = B._kv_dequant(c[name], c[f"{name}_scale"], torch.float32)
            half = c[f"{name}_scale"][..., None] / 2
            assert ((deq - fcache[seg][name])[:, :, :S].abs()
                    <= half[:, :, :S] * (1 + 1e-5)).all(), name
    assert flips <= FLIP_SHARE * entries, (flips, entries)
