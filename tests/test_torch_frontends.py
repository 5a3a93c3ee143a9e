"""The port's two frontend stubs on the dense backbone against the
reference's: the reduced internvl2-26b (``vision_patches``: 8 patch
embeddings before the text tokens, an untied head, GQA 4:2) and the reduced
hubert-xlarge (``audio_frames``: the whole sequence is frame embeddings,
bidirectional attention, no decode), 4 layers of d_model 128 each, with
weights from the reference's ``init_params`` handed over as numpy arrays
(``params_from_numpy``) and batches from the same seeded pipeline, frontend
embeddings included.

Tolerances (f32 on the CPU, each library summing in its own order): the
embedded inputs exactly; logits and KV caches to 1e-4; ``loss_fn`` to 1e-5
relative (a VLM's over its text tail) and each gradient leaf to 1e-4 of
that leaf's largest, with ``remat`` none and full; hubert's ``embed``
gradient exactly zero on both sides (its model never reads ``embed``);
``train()``'s losses over 8 steps within rtol 1e-4 of the reference's
``train()``.  ``serve`` refuses both configs before it draws a weight.
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
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import (decode_step, embed_inputs, init_cache,
                                loss_fn, params_from_numpy, prefill)
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.tree import leaves_with_paths

VLM, AUDIO = "internvl2-26b", "hubert-xlarge"
TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
BATCH, S, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, ref cfg, ref params, numpy params, numpy batch)."""
    out = {}
    for arch in (VLM, AUDIO):
        jcfg = ref_configs.get_config(arch).reduced()
        jp = jax.jit(functools.partial(ref_models.init_params, jcfg,
                                       dtype=jnp.float32))(
            jax.random.PRNGKey(0))
        batch = RefPipeline(jcfg.vocab_size, BATCH, S, seed=1,
                            d_model=jcfg.d_model, frontend=jcfg.frontend,
                            frontend_seq=max(jcfg.frontend_seq, 0)
                            ).batch_at(0)
        out[arch] = (get_config(arch).reduced(), jcfg, jp,
                     jax.tree.map(np.asarray, jp), batch)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def by_path(jtree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


def test_batches_carry_the_frontend(models):
    cfg = models[VLM][0]
    b = models[VLM][4]
    assert b["embeddings"].shape == (BATCH, cfg.frontend_seq, cfg.d_model)
    assert b["tokens"].shape == b["labels"].shape == (BATCH,
                                                      S - cfg.frontend_seq)
    b = models[AUDIO][4]
    assert sorted(b) == ["embeddings", "labels"]
    assert b["embeddings"].shape == (BATCH, S, models[AUDIO][0].d_model)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_embed_inputs_and_logits_match_the_reference(models, arch):
    cfg, jcfg, jp, np_params, batch = models[arch]
    params = params_from_numpy(cfg, np_params, "cpu")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    want = ref_models.embed_inputs(jcfg, jp, jax.tree.map(jnp.asarray, inputs))
    got = embed_inputs(cfg, params, torch_batch(inputs))
    assert got.shape == (BATCH, S, cfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlogits, _ = ref_models.forward(jcfg, jp, jax.tree.map(jnp.asarray,
                                                           inputs),
                                    remat="none")
    from repro_torch.models import forward
    logits, aux = forward(cfg, params, torch_batch(inputs), remat="none")
    assert logits.shape == jlogits.shape == (BATCH, S, cfg.vocab_padded)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_gradients_match_the_reference(models, arch, remat):
    cfg, jcfg, jp, np_params, batch = models[arch]
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_models.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch),
                                     remat=remat),
        has_aux=True))(jp)
    params = params_from_numpy(cfg, np_params, "cpu")
    named = leaves_with_paths(params)
    for _, t in named:
        t.requires_grad_()
    loss, parts = loss_fn(cfg, params, torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, [t for _, t in named],
                                allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"].detach()), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    want = by_path(jgrads)
    got = dict(zip([n for n, _ in named], grads))
    assert sorted(got) == sorted(want)
    if arch == AUDIO:  # the frame embeddings replace the token table
        assert got.pop("embed") is None
        assert not want.pop("embed").any()
    for name, g in got.items():
        scale = float(np.abs(want[name]).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - want[name]).max())
        assert err <= GRAD_TOL * scale, f"{name}: {err:.3g} of {scale:.3g}"


def test_audio_train_step_gives_embed_a_zero_gradient(models):
    """``make_train_step`` differentiates every leaf: one the loss never
    reads gets zeros (the reference's ``jax.grad``), so AdamW's first
    moment of ``embed`` stays zero."""
    cfg, _, _, np_params, batch = models[AUDIO]
    params = params_from_numpy(cfg, np_params, "cpu")
    step = steps.make_train_step(cfg, opt_cfg=AdamWConfig(lr=1e-3))
    _, opt, m = step(params, init_opt_state(params), torch_batch(batch))
    assert np.isfinite(float(m["loss"]))
    assert not opt.mu["embed"].any() and opt.mu["head"].abs().max() > 0


def test_vlm_prefill_and_greedy_decode_match_the_reference(models):
    """Prefill over the patch embeddings and the text tokens, then 8 greedy
    steps from position ``frontend_seq`` plus the text tokens."""
    cfg, jcfg, jp, np_params, batch = models[VLM]
    params = params_from_numpy(cfg, np_params, "cpu")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, jax.tree.map(jnp.asarray, inputs))
    ref_decode = jax.jit(functools.partial(ref_models.decode_step, jcfg))
    cache = init_cache(cfg, BATCH, s_max)
    logits, _ = prefill(cfg, params, cache, torch_batch(inputs))

    def same_cache():
        for k in ("k", "v"):
            np.testing.assert_allclose(cache["seg0"][k].numpy(),
                                       np.asarray(jcache["seg0"][k]),
                                       rtol=TOL, atol=TOL)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    same_cache()
    pos0 = cfg.frontend_seq + inputs["tokens"].shape[1]
    assert pos0 == S
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_decode(jp, jcache, jtok, jnp.asarray(pos0 + i))
        logits, _ = decode_step(cfg, params, cache, tok, pos0 + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    same_cache()


def test_audio_prefill_matches_the_reference(models):
    """hubert's prefill (bidirectional, no decode step): last-frame logits
    and the caches it fills."""
    cfg, jcfg, jp, np_params, batch = models[AUDIO]
    assert not cfg.causal and not cfg.supports_decode
    emb = {"embeddings": batch["embeddings"]}
    jcache = ref_models.init_cache(jcfg, BATCH, S, dtype=jnp.float32)
    jlogits, jcache = ref_models.prefill(jcfg, jp, jcache,
                                         jax.tree.map(jnp.asarray, emb))
    cache = init_cache(cfg, BATCH, S)
    logits, _ = prefill(cfg, params_from_numpy(cfg, np_params, "cpu"), cache,
                        torch_batch(emb))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["seg0"][k].numpy(),
                                   np.asarray(jcache["seg0"][k]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_train_matches_the_reference_from_its_weights(models, arch):
    cfg, jcfg, _, np_params, _ = models[arch]
    kw = dict(steps=8, batch=BATCH, seq_len=S, verbose=False)
    want = ref_train.train(jcfg, **kw)
    got = train(cfg, device="cpu", params=params_from_numpy(cfg, np_params,
                                                            "cpu"), **kw)
    assert got.final_step == want.final_step == 7
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


@pytest.mark.parametrize("arch,why", [(VLM, "vision-language"),
                                      (AUDIO, "encoder-only")])
def test_serve_refuses_before_drawing_weights(monkeypatch, arch, why):
    def drawn(*args, **kwargs):
        raise AssertionError("serve drew weights")

    monkeypatch.setattr(serve_mod, "init_params", drawn)
    monkeypatch.setattr(serve_mod, "serve_inputs", drawn)
    for cfg in (get_config(arch), get_config(arch).reduced()):
        with pytest.raises(ValueError, match=why):
            serve_mod.serve(cfg, device="cpu", verbose=False)
