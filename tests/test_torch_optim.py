"""The port's data pipeline and optimizer (``repro_torch.data``,
``repro_torch.optim``) against the reference's, on the same numpy inputs.

Tolerances: ``SyntheticTokenPipeline.batch_at`` bit for bit (a copy of the
same numpy draws), for several steps and hosts and all three frontends;
``quantize_int8``, ``dequantize_int8`` and ``compress_with_feedback`` bit
for bit (the same f32 operations, both rounding half to even); ``lr_at``
to one f32 ulp (1.2e-7 relative; the two libraries' f32 cosines differ by
an ulp at some steps, 1.04e-7 relative at step 33 of the trainer's
schedule); ``global_norm`` to 1e-6 relative
and ``adamw_update`` over 3 steps from the same parameters and gradients
to 1e-6 relative in parameters and moments (f32 sums and ``b ** step`` in
each library's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.adamw as ref_adamw
import repro.optim.compression as ref_comp
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               global_norm, init_opt_state, lr_at)
from repro_torch.optim import compression as comp
from repro_torch.tree import leaves

ADAM_RTOL = 1e-6


def tree_np(tree):
    """A numpy copy of a port tree (tensors) or reference tree (arrays)."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    return np.asarray(tree).copy()


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def random_tree(rng, scale=1.0):
    return {
        "w": (rng.standard_normal((7, 33)) * scale).astype(np.float32),
        "b": {"z": (rng.standard_normal(300) * scale).astype(np.float32),
              "a": (rng.standard_normal((2, 3, 4)) * scale).astype(np.float32)},
        "A": np.linspace(-1, 1, 5, dtype=np.float32),
    }


# ------------------------------------------------------------- data pipeline
PIPELINES = {
    "tokens": dict(vocab_size=1000, batch=8, seq_len=32),
    "tokens_hosts": dict(vocab_size=50280, batch=8, seq_len=16, num_hosts=4),
    "vision": dict(vocab_size=500, batch=4, seq_len=24, d_model=16,
                   frontend="vision_patches", frontend_seq=8),
    "audio": dict(vocab_size=300, batch=4, seq_len=12, d_model=8,
                  frontend="audio_frames"),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_batch_at_is_the_reference_bit_for_bit(name):
    kw = PIPELINES[name]
    for host in range(kw.get("num_hosts", 1)):
        for seed in (0, 7):
            port = SyntheticTokenPipeline(**kw, seed=seed, host_id=host)
            ref = RefPipeline(**kw, seed=seed, host_id=host)
            for step in (0, 1, 5, 1000):
                got, want = port.batch_at(step), ref.batch_at(step)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])


def test_iteration_walks_the_steps():
    pipe = SyntheticTokenPipeline(100, 2, 8, seed=3)
    it = iter(pipe)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      pipe.batch_at(step)["tokens"])


# --------------------------------------------------------------- compression
CODEC_SHAPES = [(256,), (1000,), (3, 7), (2, 256, 3), (1,)]


@pytest.mark.parametrize("shape", CODEC_SHAPES, ids=str)
def test_quantize_int8_is_the_reference_bit_for_bit(shape):
    rng = np.random.default_rng(len(shape))
    g = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 3, shape)
         ).astype(np.float32)
    g.reshape(-1)[: min(g.size, 300)] *= 0  # an all-zero block
    got = comp.quantize_int8(torch.from_numpy(g))
    want = ref_comp.quantize_int8(jnp.asarray(g))
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        comp.dequantize_int8(got, shape).numpy(),
        np.asarray(ref_comp.dequantize_int8(want, shape)))


def test_round_half_to_even():
    # 0.5, 1.5, 2.5 and -0.5 of the scale: half to even, as jnp.round does
    g = np.zeros(256, np.float32)
    g[:5] = [127.0, 0.5, 1.5, 2.5, -0.5]
    q = comp.quantize_int8(torch.from_numpy(g)).q.numpy().reshape(-1)
    np.testing.assert_array_equal(q[:5], [127, 0, 2, 2, 0])
    np.testing.assert_array_equal(
        q, np.asarray(ref_comp.quantize_int8(jnp.asarray(g)).q).reshape(-1))


def test_compress_with_feedback_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    errs_p = comp.init_error_feedback(to_torch(random_tree(rng)))
    errs_r = ref_comp.init_error_feedback(to_jax(random_tree(rng)))
    for step in range(3):
        grads = random_tree(rng, scale=10.0 ** -step)
        q_p, errs_p = comp.compress_with_feedback(to_torch(grads), errs_p)
        q_r, errs_r = ref_comp.compress_with_feedback(to_jax(grads), errs_r)
        for a, b in zip(leaves(tree_np(errs_p)),
                        jax.tree.leaves(tree_np(errs_r))):
            np.testing.assert_array_equal(a, b)
        qs_p = leaves(q_p)  # QuantState's fields are leaves here
        qs_r = jax.tree.leaves(q_r)
        assert len(qs_p) == len(qs_r)
        for a, b in zip(qs_p, qs_r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        dq_p = comp.decompress_and_update(q_p, to_torch(grads))
        dq_r = ref_comp.decompress_and_update(q_r, to_jax(grads))
        for a, b in zip(leaves(tree_np(dq_p)), jax.tree.leaves(dq_r)):
            np.testing.assert_array_equal(a, np.asarray(b))


# --------------------------------------------------------------------- AdamW
SCHEDULES = {
    "default": AdamWConfig(),
    "short": AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10),
    "train": AdamWConfig(lr=3e-4, total_steps=96, warmup_steps=20),
    "no_warmup": AdamWConfig(warmup_steps=0, total_steps=1, min_lr_frac=0.0),
}


def ref_cfg(cfg):
    return ref_adamw.AdamWConfig(*cfg[:-1])


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_at_matches_the_reference(name):
    cfg = SCHEDULES[name]
    for step in list(range(0, 40)) + [95, 96, 97, 5000, 9999, 20000]:
        got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        want = ref_adamw.lr_at(ref_cfg(cfg), jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)


def test_init_opt_state_layout_and_moment_dtype():
    params = to_torch(random_tree(np.random.default_rng(0)))
    st = init_opt_state(params)
    assert isinstance(st, OptState) and st.step.dtype == torch.int32
    assert int(st.step) == 0 and st.step.shape == ()
    for p, m, v in zip(leaves(params), leaves(st.mu), leaves(st.nu)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any() and not v.any() and m is not v
    half = init_opt_state(params, moment_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 for m in leaves(half.mu))


def test_global_norm_sums_in_the_reference_leaf_order():
    rng = np.random.default_rng(1)
    tree = random_tree(rng)
    got = float(global_norm(to_torch(tree)))
    want = float(ref_adamw.global_norm(to_jax(tree)))
    np.testing.assert_allclose(got, want, rtol=ADAM_RTOL)


@pytest.mark.parametrize("name", ["short", "default"])
def test_adamw_update_matches_the_reference_over_3_steps(name):
    cfg = SCHEDULES[name]
    rng = np.random.default_rng(2)
    params_np = random_tree(rng)
    p_port, p_ref = to_torch(params_np), to_jax(params_np)
    o_port, o_ref = init_opt_state(p_port), ref_adamw.init_opt_state(p_ref)
    for step in range(3):
        # the first step's gradients are clipped (norm > clip_norm)
        grads = random_tree(rng, scale=3.0 if step == 0 else 0.01)
        before = tree_np(p_port)
        p_port, o_port, m_port = adamw_update(cfg, p_port, to_torch(grads),
                                              o_port)
        p_ref, o_ref, m_ref = ref_adamw.adamw_update(ref_cfg(cfg), p_ref,
                                                     to_jax(grads), o_ref)
        assert int(o_port.step) == int(o_ref.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m_port[k]), float(m_ref[k]),
                                       rtol=ADAM_RTOL)
        for got, want in ((p_port, p_ref), (o_port.mu, o_ref.mu),
                          (o_port.nu, o_ref.nu)):
            for a, b in zip(leaves(tree_np(got)),
                            jax.tree.leaves(tree_np(want))):
                np.testing.assert_allclose(a, b, rtol=ADAM_RTOL, atol=1e-12)
    # functional: the update wrote nothing it was given
    for a, b in zip(leaves(before), leaves(tree_np(p_port))):
        assert not np.array_equal(a, b)
