"""The port's model substrate (``repro_torch.configs``, ``models``) against
the reference's, at the reduced mamba2-130m (4 layers, d_model 128, state
16, headdim 16, chunk 8) and the reduced dense models h2o-danube-3-4b
(sliding window 16, GQA 4:2) and qwen3-14b (full causal attention, qk_norm,
untied head): 4 layers, d_model 128, 4 heads of 32.

Weights are the reference's own ``init_params``, handed to the port as
numpy arrays through ``params_from_numpy``; prompts are numpy integers from
a seed.  Tolerance: logits within 1e-4 (rtol and atol) in f32, at every
step of an 8-step greedy decode whose tokens must be equal; the SSM decode
state, and the filled KV cache of the dense models, within 1e-4 after the
loop; the dense attention and transformer blocks without a cache within
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
import repro.models.blocks as ref_blocks
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_numpy, prefill)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

TOL = 1e-4
BATCH, PROMPT, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("mamba2-130m").reduced()
    jcfg = ref_configs.get_config("mamba2-130m").reduced()
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return cfg, jcfg, params, jparams, tokens


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_equal_the_reference(name):
    port, ref = get_config(name), ref_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for prop in ("vocab_padded", "d_inner", "ssm_heads"):
        assert getattr(port, prop) == getattr(ref, prop)
    assert port.param_count() == ref.param_count()


def test_init_params_has_the_reference_layout(setup):
    cfg, jcfg, _, jparams, _ = setup
    params = init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_leaves_with_path(jparams)
    flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v

    walk(params)
    got = {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for path, t in flat.items()}
    ref = {tuple(p.key for p in path): (tuple(a.shape), str(a.dtype))
           for path, a in want}
    assert got == ref


def test_prefill_and_greedy_decode_match_reference(setup):
    cfg, jcfg, params, jparams, tokens = setup
    jcache = ref_models.init_cache(jcfg, BATCH, PROMPT + STEPS,
                                   dtype=jnp.float32)
    jlogits, jcache = ref_models.prefill(jcfg, jparams, jcache,
                                         {"tokens": jnp.asarray(tokens)})
    cache = init_cache(cfg, BATCH, PROMPT + STEPS)
    logits, cache_after = prefill(cfg, params, cache,
                                  {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    # prefill leaves the Mamba caches untouched, as the reference's does
    for k in ("h", "conv"):
        assert cache_after["seg0"][k] is cache["seg0"][k]
        np.testing.assert_array_equal(cache_after["seg0"][k].numpy(),
                                      np.asarray(jcache["seg0"][k]))
        assert not cache["seg0"][k].any()

    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_models.decode_step(jcfg, jparams, jcache, jtok,
                                                 jnp.asarray(PROMPT + i))
        logits, cache_after = decode_step(cfg, params, cache_after, tok,
                                          PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    for k in ("h", "conv"):  # written in place: the same tensors come back
        assert cache_after["seg0"][k] is cache["seg0"][k]
        np.testing.assert_allclose(cache["seg0"][k].numpy(),
                                   np.asarray(jcache["seg0"][k]),
                                   rtol=TOL, atol=TOL)
    assert cache["seg0"]["h"].any()


def test_prompt_not_a_multiple_of_the_chunk_is_refused(setup):
    cfg, jcfg, params, jparams, tokens = setup
    ragged = tokens[:, :PROMPT - 3]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        prefill(cfg, params, init_cache(cfg, BATCH, PROMPT),
                {"tokens": torch.from_numpy(ragged).long()})
    with pytest.raises(AssertionError):  # the reference asserts the same
        ref_models.prefill(jcfg, jparams,
                           ref_models.init_cache(jcfg, BATCH, PROMPT,
                                                 dtype=jnp.float32),
                           {"tokens": jnp.asarray(ragged)})


DENSE = ("h2o-danube-3-4b", "qwen3-14b")


def dense_setup(name):
    cfg = get_config(name).reduced()
    jcfg = ref_configs.get_config(name).reduced()
    jparams = ref_models.init_params(jcfg, jax.random.PRNGKey(1),
                                     dtype=jnp.float32)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return cfg, jcfg, params, jparams, tokens


@pytest.mark.parametrize("name", DENSE)
def test_dense_init_params_has_the_reference_layout(name):
    cfg, _, converted, jparams, _ = dense_setup(name)
    drawn = init_params(cfg, torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert shapes(drawn) == want
    assert shapes(converted) == want


@pytest.mark.parametrize("q_chunk", [1024, 16], ids=["one_block", "chunked"])
@pytest.mark.parametrize("name", DENSE)
def test_dense_prefill_and_greedy_decode_match_reference(name, q_chunk):
    """Prefill through the port's attention path (the plain version on the
    CPU; at ``q_chunk`` 16 the query-chunked branches), then 8 greedy steps
    against the cache the prefill filled in place."""
    cfg, jcfg, params, jparams, tokens = dense_setup(name)
    s_max = PROMPT + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = ref_models.prefill(jcfg, jparams, jcache,
                                         {"tokens": jnp.asarray(tokens)},
                                         q_chunk=q_chunk)
    cache = init_cache(cfg, BATCH, s_max)
    assert cache["seg0"]["k"].shape == (cfg.num_layers, BATCH, s_max,
                                        cfg.num_kv_heads, cfg.head_dim)
    logits, out = prefill(cfg, params, cache,
                          {"tokens": torch.from_numpy(tokens).long()},
                          q_chunk=q_chunk)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for k in ("k", "v"):  # filled in place: the same tensors come back
        assert out["seg0"][k] is cache["seg0"][k]
        np.testing.assert_allclose(cache["seg0"][k].numpy(),
                                   np.asarray(jcache["seg0"][k]),
                                   rtol=TOL, atol=TOL)

    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_models.decode_step(jcfg, jparams, jcache, jtok,
                                                 jnp.asarray(PROMPT + i))
        logits, out = decode_step(cfg, params, cache, tok, PROMPT + i)
        assert out["seg0"]["k"] is cache["seg0"]["k"]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["seg0"][k].numpy(),
                                   np.asarray(jcache["seg0"][k]),
                                   rtol=TOL, atol=TOL)
    assert cache["seg0"]["k"][:, :, :s_max - 1].abs().amax(-1).gt(0).all()


@pytest.mark.parametrize("q_chunk", [1024, 16], ids=["one_block", "chunked"])
@pytest.mark.parametrize("name", DENSE)
def test_dense_block_apply_matches_reference(name, q_chunk):
    """The full-sequence attention block and transformer block (no cache)
    of layer 0 against the reference's ``attn_apply`` and ``block_apply``
    on the same numpy input."""
    cfg, jcfg, params, jparams, _ = dense_setup(name)
    jlayer = jax.tree.map(lambda a: a[0], jparams["seg0"])
    layer = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict)
                 else v[0]) for k, v in params["seg0"].items()}
    x = np.random.default_rng(2).standard_normal(
        (BATCH, PROMPT, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    got = B.attn_apply(layer["attn"], tx, cfg, q_chunk=q_chunk)
    want = ref_blocks.attn_apply(jlayer["attn"], jnp.asarray(x), jcfg,
                                 q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    got, aux = B.block_apply(layer, tx, cfg, q_chunk=q_chunk)
    want, jaux = ref_blocks.block_apply(jlayer, jnp.asarray(x), jcfg,
                                        q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    assert float(aux) == float(jaux) == 0.0


def test_dense_prompt_off_the_query_chunk_is_refused():
    cfg, jcfg, params, jparams, tokens = dense_setup("h2o-danube-3-4b")
    ragged = tokens[:, :PROMPT - 8]
    with pytest.raises(ValueError, match="multiple of the attention query"):
        prefill(cfg, params, init_cache(cfg, BATCH, PROMPT),
                {"tokens": torch.from_numpy(ragged).long()}, q_chunk=16)
    with pytest.raises(AssertionError):  # the reference asserts the same
        ref_models.prefill(jcfg, jparams,
                           ref_models.init_cache(jcfg, BATCH, PROMPT,
                                                 dtype=jnp.float32),
                           {"tokens": jnp.asarray(ragged)}, q_chunk=16)


def test_params_from_numpy_refuses_a_tree_that_lacks_an_entry():
    cfg, _, _, jparams, _ = dense_setup("qwen3-14b")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["head"]  # qwen3-14b unties its head
    with pytest.raises(KeyError, match="'head'"):
        params_from_numpy(cfg, tree)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_config_runs_reduced_on_the_cpu(name):
    """``init_params``, ``init_cache``, ``forward``, ``loss_fn``,
    ``prefill`` and ``decode_step`` on each config's ``reduced()`` form
    (the decoder ones, with the int8 KV cache too): finite values of the
    expected shapes."""
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import forward, loss_fn
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    fs = max(cfg.frontend_seq, 0)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenPipeline(
        cfg.vocab_size, 2, 16, d_model=cfg.d_model, frontend=cfg.frontend,
        frontend_seq=fs).batch_at(0).items()}
    logits, _ = forward(cfg, params, batch, remat="none")
    assert logits.shape[-1] == cfg.vocab_padded
    loss, _ = loss_fn(cfg, params, batch)
    assert bool(torch.isfinite(loss))
    if not cfg.supports_decode or cfg.frontend == "audio_frames":
        return
    for kv in ("bf16", "int8"):
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        cache = init_cache(c, 2, fs + 16 + 2)
        out, cache = prefill(c, params, cache, batch)
        tok = torch.argmax(out, -1)[:, None]
        out, _ = decode_step(c, params, cache, tok, fs + 16)
        assert out.shape == (2, cfg.vocab_padded)
        assert bool(torch.isfinite(out[:, :cfg.vocab_size]).all())


def test_the_split_projection_layout_raises():
    # (named when the port refused ssm_split_proj; it now runs) the split
    # layout from the reference's weights matches the reference's
    # split-projection forward and decode, computes what the fused layout
    # computes on the mapped weights, and still refuses a prompt off the
    # SSD chunk, as the reference does
    from repro_torch.models import forward, split_to_fused

    split = dataclasses.replace(get_config("mamba2-130m").reduced(),
                                ssm_split_proj=True)
    jsplit = dataclasses.replace(
        ref_configs.get_config("mamba2-130m").reduced(), ssm_split_proj=True)
    jparams = ref_models.init_params(jsplit, jax.random.PRNGKey(3),
                                     dtype=jnp.float32)
    assert "wz" in jparams["seg0"]["mixer"]
    params = params_from_numpy(split, jax.tree.map(np.asarray, jparams),
                               "cpu")
    own = init_params(split, torch.Generator().manual_seed(0))
    assert sorted(own["seg0"]["mixer"]) == sorted(jparams["seg0"]["mixer"])
    tokens = np.random.default_rng(5).integers(
        0, split.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    want, _ = ref_models.forward(jsplit, jparams,
                                 {"tokens": jnp.asarray(tokens)},
                                 remat="none")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    got, _ = forward(split, params, batch, remat="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    fused_cfg = dataclasses.replace(split, ssm_split_proj=False)
    fused = split_to_fused(split, params)
    same, _ = forward(fused_cfg, fused, batch, remat="none")
    torch.testing.assert_close(same, got, rtol=1e-6, atol=1e-6)
    jcache = ref_models.init_cache(jsplit, BATCH, PROMPT + 1,
                                   dtype=jnp.float32)
    jl, _ = ref_models.decode_step(jsplit, jparams, jcache,
                                   jnp.asarray(tokens[:, :1]),
                                   jnp.asarray(0))
    cache = init_cache(split, BATCH, PROMPT + 1)
    fcache = init_cache(fused_cfg, BATCH, PROMPT + 1)
    tl, _ = decode_step(split, params, cache, batch["tokens"][:, :1], 0)
    fl, _ = decode_step(fused_cfg, fused, fcache, batch["tokens"][:, :1], 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(fl, tl, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="chunk"):
        forward(split, params, {"tokens": batch["tokens"][:, :12]},
                remat="none")
