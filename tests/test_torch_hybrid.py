"""The port's hybrid family (zamba2-7b: a Mamba2 backbone with two shared
transformer blocks applied every ``hybrid_attn_every`` layers) against the
reference's, on the reduced config (4 layers, ``hybrid_attn_every`` 2, so
shared block 0 runs before layer 0 and shared block 1 before layer 2;
d_model 128, 4 MHA heads of 32, SSM state 16, headdim 16, chunk 8), with
weights from the reference's ``init_params`` handed over as numpy arrays
(``params_from_numpy``) and inputs from numpy seeds.

Tolerances, f32 on the CPU, each library summing in its own order: the
forward logits to 1e-4; ``loss_fn`` to 1e-5 relative and each gradient
leaf (the shared blocks', summed over their applications, included) to
1e-4 of its largest under remat none, full and dots; a prefill's logits
and shared-attention caches to 1e-4 with the Mamba states left at zero,
as the reference leaves them; 8 greedy decode steps to 1e-4 with equal
tokens; ``train()``'s losses over 8 steps within rtol 1e-4.
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
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, loss_fn, params_from_numpy,
                                prefill, segments_of)
from repro_torch.tree import leaves_with_paths

ARCH = "zamba2-7b"
TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
BATCH, S, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def hybrid():
    """(cfg, ref cfg, ref params, numpy params)."""
    jcfg = ref_configs.get_config(ARCH).reduced()
    jp = jax.jit(functools.partial(ref_models.init_params, jcfg,
                                   dtype=jnp.float32))(jax.random.PRNGKey(0))
    return get_config(ARCH).reduced(), jcfg, jp, jax.tree.map(np.asarray, jp)


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_the_reduced_config_applies_both_shared_blocks(hybrid):
    cfg = hybrid[0]
    assert (cfg.num_layers, cfg.hybrid_attn_every,
            cfg.n_shared_attn_blocks) == (4, 2, 2)
    assert segments_of(cfg) == (("zamba", 4),)


def test_init_params_and_cache_have_the_reference_layout(hybrid):
    cfg, jcfg, jp, np_params = hybrid
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    got = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(got) == ["embed", "final_norm", "seg0", "shared_attn"]
    assert shapes(got) == want
    assert shapes(params_from_numpy(cfg, np_params)) == want
    jcache = jax.eval_shape(functools.partial(
        ref_models.init_cache, jcfg, BATCH, S, dtype=jnp.float32))
    cache = init_cache(cfg, BATCH, S)
    assert list(cache) == ["seg0", "shared_attn"]
    # one attention cache per application: ceil(4 / 2) = 2
    assert cache["shared_attn"]["k"].shape[0] == 2
    assert shapes(cache) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jcache)


def test_forward_logits_match_the_reference(hybrid):
    cfg, jcfg, jp, np_params = hybrid
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    jlogits, jaux = jax.jit(functools.partial(ref_models.forward, jcfg,
                                              remat="none"))(
        jp, {"tokens": jnp.asarray(tokens)})
    logits, aux = forward(cfg, params_from_numpy(cfg, np_params, "cpu"),
                          {"tokens": torch.from_numpy(tokens).long()},
                          remat="none")
    close(logits.detach(), jlogits)
    assert float(aux) == float(jaux) == 0.0


def by_path(jtree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_the_reference(hybrid, remat):
    cfg, jcfg, jp, np_params = hybrid
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
    np.testing.assert_allclose(float(parts["ce"].detach()),
                               float(jparts["ce"]), rtol=LOSS_RTOL)
    want = by_path(jgrads)
    got = {n: g.numpy() for (n, _), g in zip(named, grads)}
    assert sorted(got) == sorted(want)
    shared = [n for n in got if n.startswith("shared_attn/")]
    assert len(shared) == 9  # ln1, wq, wk, wv, wo, ln2, gate, up, down
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(g - want[name]).max())
        assert err <= GRAD_TOL * scale, f"{remat} {name}: {err:.3g}"
        if name.startswith("shared_attn/"):  # both shared blocks reached
            assert (np.abs(g).reshape(2, -1).max(axis=1) > 0).all(), name


def test_prefill_fills_the_shared_caches_and_leaves_mamba_states(hybrid):
    cfg, jcfg, jp, np_params = hybrid
    params = params_from_numpy(cfg, np_params, "cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens)})
    cache = init_cache(cfg, BATCH, s_max)
    logits, _ = prefill(cfg, params, cache,
                        {"tokens": torch.from_numpy(tokens).long()})
    close(logits, jlogits)
    for k in ("k", "v"):
        close(cache["shared_attn"][k], jcache["shared_attn"][k], msg=k)
        assert cache["shared_attn"][k][:, :, :S].abs().amax(
            dim=(1, 2, 3, 4)).min() > 0  # every application filled
        assert not cache["shared_attn"][k][:, :, S:].any()
    for k, t in cache["seg0"].items():
        assert not t.any(), k
        assert not np.asarray(jcache["seg0"][k]).any(), k


def test_greedy_decode_matches_the_reference(hybrid):
    cfg, jcfg, jp, np_params = hybrid
    params = params_from_numpy(cfg, np_params, "cpu")
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens)})
    ref_decode = jax.jit(functools.partial(ref_models.decode_step, jcfg))
    cache = init_cache(cfg, BATCH, s_max)
    logits, _ = prefill(cfg, params, cache,
                        {"tokens": torch.from_numpy(tokens).long()})
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_decode(jp, jcache, jtok, jnp.asarray(S + i))
        logits, _ = decode_step(cfg, params, cache, tok, S + i)
        close(logits, jlogits, msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    for seg in ("seg0", "shared_attn"):
        for k, t in cache[seg].items():
            close(t, jcache[seg][k], msg=f"{seg} {k}")


def test_train_matches_the_reference_from_its_weights(hybrid):
    cfg, jcfg, _, np_params = hybrid
    kw = dict(steps=8, batch=BATCH, seq_len=S, verbose=False)
    want = ref_train.train(jcfg, **kw)
    got = train(cfg, device="cpu", params=params_from_numpy(cfg, np_params,
                                                            "cpu"), **kw)
    assert got.final_step == want.final_step == 7
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def test_serve_runs_the_hybrid_model():
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


@pytest.mark.parametrize("prompt_len", [12, 1032])
def test_serve_refuses_a_hybrid_prompt_before_drawing_weights(monkeypatch,
                                                              prompt_len):
    """A prompt that is not a multiple of the SSD chunk (12 at chunk 8), or
    above the attention's query chunk of 1024 and not a multiple of it
    (1032, a multiple of 8), is refused before any weight is drawn."""
    import repro_torch.launch.serve as serve_mod

    def drawn(*a, **k):
        raise AssertionError("weights drawn before the prompt was checked")

    monkeypatch.setattr(serve_mod, "init_params", drawn)
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="multiple of the"):
        serve(cfg, batch=1, prompt_len=prompt_len, gen_len=2, device="cpu",
              verbose=False)
    full = get_config(ARCH)
    with pytest.raises(ValueError, match="SSD chunk 64"):
        serve(full, batch=1, prompt_len=2000, gen_len=2, device="cpu",
              verbose=False)
