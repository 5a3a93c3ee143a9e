"""The port's MLA attention (``repro_torch.models.blocks.mla_*``) and the
deepseek-v2-lite-16b model against the reference's, on the reduced config
(4 layers: one dense, then three MoE layers of 8 routed experts, top 2, one
shared; d_model 128, 4 heads, ``kv_lora_rank`` 32, query and key heads of
16 + 8, V heads of 16), with weights from the reference's ``init_params``
handed over as numpy arrays (``params_from_numpy``) and inputs from numpy
seeds.

Tolerances, f32 on the CPU, each library summing in its own order:
``mla_apply``, ``mla_prefill`` (its output and its ``ckv``/``krope``
caches) and ``mla_decode`` to 1e-4; the V-width route of
``layers.attention`` (V handed to the flash wrapper at its own width above
Q's width 128, padded to it below) to 1e-6 of the plain attention and of the first columns of the same call on V
zero-padded to the query width, whose padded columns come out exactly 0;
``loss_fn`` to 1e-5 relative and each gradient leaf to 1e-4 of
its largest under remat none, full and dots; the model's logits and caches
to 1e-4 over a prefill and 8 greedy decode steps whose tokens must be
equal; ``train()``'s losses over 8 steps within rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.train as ref_train
import repro.models as ref_models
import repro.models.blocks as ref_blocks
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import (decode_step, init_cache, init_params,
                                loss_fn, params_from_numpy, prefill,
                                segments_of)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import leaves_with_paths

ARCH = "deepseek-v2-lite-16b"
TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
BATCH, S, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def mla():
    """(cfg, ref cfg, ref params, numpy params)."""
    jcfg = ref_configs.get_config(ARCH).reduced()
    jp = jax.jit(functools.partial(ref_models.init_params, jcfg,
                                   dtype=jnp.float32))(jax.random.PRNGKey(0))
    return get_config(ARCH).reduced(), jcfg, jp, jax.tree.map(np.asarray, jp)


def layer_of(tree, i):
    if isinstance(tree, dict):
        return {k: layer_of(v, i) for k, v in tree.items()}
    return tree[i]


def attn_layer(mla):
    """Layer 0's MLA parameters on both sides."""
    cfg, _, jp, np_params = mla
    return (layer_of(jp["seg0"], 0)["attn"],
            layer_of(params_from_numpy(cfg, np_params, "cpu")["seg0"],
                     0)["attn"])


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("q_chunk", [1024, 16], ids=["one_block", "chunked"])
def test_mla_apply_and_prefill_match_the_reference(mla, q_chunk):
    cfg, jcfg = mla[0], mla[1]
    jl, tl = attn_layer(mla)
    assert sorted(tl) == ["kv_norm", "wkv_a", "wkv_b", "wo", "wq"]
    x = np.random.default_rng(1).standard_normal(
        (BATCH, S, cfg.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(ref_blocks.mla_apply, cfg=jcfg,
                                     q_chunk=q_chunk))(jl, jnp.asarray(x))
    got = B.mla_apply(tl, torch.from_numpy(x), cfg, q_chunk=q_chunk)
    close(got, want)
    plain = B.mla_apply(tl, torch.from_numpy(x), cfg, q_chunk=q_chunk,
                        plain=True)
    close(plain, got, 1e-6)
    jc = ref_blocks.attn_cache_shape(jcfg, BATCH, S + 4, jnp.float32)
    want, jc = jax.jit(functools.partial(ref_blocks.mla_prefill, cfg=jcfg,
                                         q_chunk=q_chunk))(
        jl, jnp.asarray(x), cache=jc)
    tc = B.attn_cache_shape(cfg, BATCH, S + 4, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    got, tc2 = B.mla_prefill(tl, torch.from_numpy(x), cfg, tc,
                             q_chunk=q_chunk)
    assert tc2 is tc  # written in place
    close(got, want)
    for k in ("ckv", "krope"):
        close(tc[k], jc[k], msg=k)
        assert not tc[k][:, S:].any()


def test_mla_decode_matches_the_reference(mla):
    """Four absorbed decode steps after a prefill, caches included."""
    cfg, jcfg = mla[0], mla[1]
    jl, tl = attn_layer(mla)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    jc = ref_blocks.attn_cache_shape(jcfg, BATCH, S + 4, jnp.float32)
    _, jc = ref_blocks.mla_prefill(jl, jnp.asarray(x), jcfg, jc)
    tc = B.attn_cache_shape(cfg, BATCH, S + 4, torch.float32)
    B.mla_prefill(tl, torch.from_numpy(x), cfg, tc)
    ref_decode = jax.jit(functools.partial(ref_blocks.mla_decode, cfg=jcfg))
    for i in range(4):
        x1 = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        want, jc = ref_decode(jl, jnp.asarray(x1), cache=jc,
                              pos=jnp.asarray(S + i))
        got, _ = B.attn_decode(tl, torch.from_numpy(x1), cfg, tc, S + i)
        close(got, want, msg=f"step {i}")
    for k in ("ckv", "krope"):
        close(tc[k], jc[k], msg=k)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(24, 16), (192, 128), (256, 136)],
                         ids=["reduced", "full_width", "two_v_panels"])
def test_v_padding_route_equals_the_unpadded_plain_attention(dims, causal):
    """``layers.attention`` off the plain path hands V to the flash
    wrapper at its own width ``dv`` (the wrapper pads it to the width its
    entry takes on the card): the result has V's width, is the plain
    attention over that V, and equals the first ``dv`` columns of the
    wrapper on V zero-padded to the query width, whose padded columns are
    exactly 0."""
    d, dv = dims
    rng = np.random.default_rng(d)
    q, k = (torch.from_numpy(rng.standard_normal((2, 64, 4, d))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, 64, 4, dv))
                         .astype(np.float32))
    scale = 1.0 / np.sqrt(d)
    got = L.attention(q, k, v, causal=causal, scale=scale, q_chunk=32)
    want = attention_plain(q, k, v, causal=causal, scale=scale, q_chunk=32)
    assert got.shape == want.shape == (2, 64, 4, dv)
    close(got, want, 1e-6)
    padded = fa.flash_attention(q, k, torch.nn.functional.pad(v, (0, d - dv)),
                                causal=causal, scale=scale)
    assert not padded[..., dv:].any()
    close(padded[..., :dv], want, 1e-6)
    close(got, padded[..., :dv], 1e-6)


def test_init_params_and_cache_have_the_reference_layout(mla):
    cfg, jcfg, jp, np_params = mla
    assert segments_of(cfg) == (("dense", 1), ("moe", 3))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert shapes(init_params(cfg, torch.Generator().manual_seed(0))) == want
    assert shapes(params_from_numpy(cfg, np_params)) == want
    jcache = jax.eval_shape(functools.partial(
        ref_models.init_cache, jcfg, BATCH, S, dtype=jnp.float32))
    assert shapes(init_cache(cfg, BATCH, S)) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jcache)


def by_path(jtree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_the_reference(mla, remat):
    cfg, jcfg, jp, np_params = mla
    batch = RefPipeline(cfg.vocab_size, BATCH, S, seed=1).batch_at(0)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_models.loss_fn(jcfg, p,
                                     jax.tree.map(jnp.asarray, batch),
                                     remat=remat),
        has_aux=True))(jp)
    params = params_from_numpy(cfg, np_params, "cpu")
    named = leaves_with_paths(params)
    for _, t in named:
        t.requires_grad_()
    loss, parts = loss_fn(cfg, params,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          remat=remat)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = by_path(jgrads)
    got = {n: g.numpy() for (n, _), g in zip(named, grads)}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name  # every MLA projection and kv_norm reached
        err = float(np.abs(g - want[name]).max())
        assert err <= GRAD_TOL * scale, f"{remat} {name}: {err:.3g}"


def test_prefill_and_greedy_decode_match_the_reference(mla):
    cfg, jcfg, jp, np_params = mla
    params = params_from_numpy(cfg, np_params, "cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens)})
    ref_decode = jax.jit(functools.partial(ref_models.decode_step, jcfg))
    cache = init_cache(cfg, BATCH, s_max)
    logits, _ = prefill(cfg, params, cache,
                        {"tokens": torch.from_numpy(tokens).long()})

    def same_cache():
        for seg in ("seg0", "seg1"):
            for k in ("ckv", "krope"):
                close(cache[seg][k], jcache[seg][k], msg=f"{seg} {k}")

    close(logits, jlogits)
    same_cache()
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_decode(jp, jcache, jtok, jnp.asarray(S + i))
        logits, _ = decode_step(cfg, params, cache, tok, S + i)
        close(logits, jlogits, msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    same_cache()


def test_train_matches_the_reference_from_its_weights(mla):
    cfg, jcfg, _, np_params = mla
    kw = dict(steps=8, batch=BATCH, seq_len=S, verbose=False)
    want = ref_train.train(jcfg, **kw)
    got = train(cfg, device="cpu", params=params_from_numpy(cfg, np_params,
                                                            "cpu"), **kw)
    assert got.final_step == want.final_step == 7
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def test_serve_runs_the_mla_model():
    """``serve`` on the reduced MLA model: its first token is the argmax of
    a fresh prefill on the same weights."""
    from repro_torch.launch.serve import serve_inputs
    cfg = get_config(ARCH).reduced()
    res = serve(cfg, batch=2, prompt_len=16, gen_len=6, device="cpu",
                verbose=False)
    assert res.tokens.shape == (2, 6)
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=16, seed=0,
                                   dtype=torch.float32, device="cpu")
    logits, _ = prefill(cfg, params, init_cache(cfg, 2, 22),
                        {"tokens": prompts})
    np.testing.assert_array_equal(res.tokens[:, 0],
                                  torch.argmax(logits, -1).numpy())
