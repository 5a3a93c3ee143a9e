"""The port's model substrate (``repro_torch.configs``, ``models``) against
the reference's, at the reduced mamba2-130m (4 layers, d_model 128, state
16, headdim 16, chunk 8).

Weights are the reference's own ``init_params``, handed to the port as
numpy arrays through ``params_from_numpy``; prompts are numpy integers from
a seed.  Tolerance: logits within 1e-4 (rtol and atol) in f32, at every
step of an 8-step greedy decode whose tokens must be equal; the SSM decode
state within 1e-4 after the loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                params_from_numpy, prefill)
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
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache_after["seg0"][k].numpy(),
                                   np.asarray(jcache["seg0"][k]),
                                   rtol=TOL, atol=TOL)
    assert not cache["seg0"]["h"].any()  # decode_step returns a new cache


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


def test_unported_families_and_layouts_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(get_config("h2o-danube-3-4b").reduced(),
                    torch.Generator())
    split = dataclasses.replace(get_config("mamba2-130m").reduced(),
                                ssm_split_proj=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.mamba_init(torch.Generator(), split, torch.float32)
