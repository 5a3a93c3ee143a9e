"""The port's training stack (``repro_torch.models.forward``/``loss_fn``,
``launch.steps``, ``launch.train``, ``sched.autotune``) against the
reference's, on the reduced mamba2-130m (4 layers, d_model 128, chunk 8)
and the reduced h2o-danube-3-4b (4 layers, d_model 128, GQA 4:2, window
16), with weights from the reference's ``init_params`` handed over as
numpy arrays (``params_from_numpy``) and batches from the same seeded
pipeline.

Tolerances (f32 on the CPU; each library sums in its own order):
``loss_fn`` to 1e-5 relative and each gradient leaf to 1e-4 of that leaf's
largest |gradient|, with ``remat`` none, full and dots against
``jax.value_and_grad`` of the reference's ``loss_fn`` with the same
``remat``; the forward logits to 1e-4; ``make_train_step`` with
``n_micro=2``: loss and gradient norm to 1e-5 relative, the first moments
(0.1 of the accumulated gradients) to 1e-4 of each leaf's largest;
``train()``'s losses over 8 steps within rtol 1e-4 of the reference's
``train()``; a failed-and-resumed run's losses within rtol 1e-4 of the
uninterrupted run's (the reference's own resume tolerance,
``tests/test_substrates.py``).

The kernels' autograd routes (``_SsdScan``, ``_FlashAttention``) run only
on CUDA tensors; here their backward (``runtime.plain_vjp``) is held to
the plain version's autograd with the launch swapped for the plain
forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.steps as ref_steps
import repro.launch.train as ref_train
import repro.models as ref_models
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.optim.adamw import init_opt_state as ref_init_opt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.ssd import ops as sd
from repro_torch.kernels.ssd.ref import ssd_scan_plain
from repro_torch.launch import steps
from repro_torch.launch.train import SimulatedFailure, parse_args, train
from repro_torch.models import (forward, init_cache, init_params, loss_fn,
                                params_from_numpy)
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.sched import tune
from repro_torch.tree import leaves, leaves_with_paths

ARCHS = ("mamba2-130m", "h2o-danube-3-4b")
REMATS = ("none", "full", "dots")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
B, S = 4, 32


@pytest.fixture(scope="module")
def models():
    """arch -> (cfg, ref cfg, ref params, numpy params, numpy batch)."""
    out = {}
    for arch in ARCHS:
        jcfg = ref_configs.get_config(arch).reduced()
        jp = ref_models.init_params(jcfg, jax.random.PRNGKey(0),
                                    dtype=jnp.float32)
        batch = RefPipeline(jcfg.vocab_size, B, S, seed=1).batch_at(0)
        out[arch] = (get_config(arch).reduced(), jcfg, jp,
                     jax.tree.map(np.asarray, jp), batch)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def by_path(jtree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


def assert_leafwise(got: dict, want: dict, tol: float):
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= tol * scale, f"{name}: {err:.3g} of {scale:.3g}"


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(models, arch, remat):
    cfg, jcfg, jp, np_params, batch = models[arch]
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: ref_models.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, batch),
                                     remat=remat),
        has_aux=True)(jp)
    params = params_from_numpy(cfg, np_params, "cpu")
    named = leaves_with_paths(params)
    for _, t in named:
        t.requires_grad_()
    loss, parts = loss_fn(cfg, params, torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]),
                               rtol=LOSS_RTOL)
    assert float(parts["aux"]) == float(jparts["aux"]) == 0.0
    assert_leafwise({n: g.numpy() for (n, _), g in zip(named, grads)},
                    by_path(jgrads), GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(models, arch):
    cfg, jcfg, jp, np_params, batch = models[arch]
    jlogits, _ = ref_models.forward(jcfg, jp, {"tokens": batch["tokens"]},
                                    remat="none")
    logits, aux = forward(cfg, params_from_numpy(cfg, np_params, "cpu"),
                          torch_batch({"tokens": batch["tokens"]}),
                          remat="none")
    assert logits.shape == jlogits.shape  # the padded vocabulary, unmasked
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def test_ignored_labels_and_padded_vocabulary(models):
    cfg, jcfg, jp, np_params, batch = models["mamba2-130m"]
    # 500 live tokens of the 512 rows the weights hold: a padded tail
    cfg = dataclasses.replace(cfg, vocab_size=500)
    jcfg = dataclasses.replace(jcfg, vocab_size=500)
    assert cfg.vocab_padded == jcfg.vocab_padded == 512
    labels = np.minimum(batch["labels"], 499)
    labels[:, ::3] = -1
    b = dict(tokens=np.minimum(batch["tokens"], 499), labels=labels)
    jloss, _ = ref_models.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, b))
    loss, _ = loss_fn(cfg, params_from_numpy(cfg, np_params, "cpu"),
                      torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)


def test_plain_path_and_bad_remat(models):
    cfg, _, _, np_params, batch = models["h2o-danube-3-4b"]
    params = params_from_numpy(cfg, np_params, "cpu")
    a, _ = loss_fn(cfg, params, torch_batch(batch), remat="none")
    b, _ = loss_fn(cfg, params, torch_batch(batch), remat="none", plain=True)
    np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(cfg, params, torch_batch(batch), remat="some")


def test_train_step_with_microbatches_matches_the_reference(models):
    cfg, jcfg, jp, np_params, batch = models["mamba2-130m"]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(
        jcfg, opt_cfg=ref_steps.AdamWConfig(*opt_cfg[:-1]), n_micro=2))
    _, jopt, jm = ref_step(jp, ref_init_opt(jp),
                           jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(cfg, np_params, "cpu")
    step = steps.make_train_step(cfg, opt_cfg=opt_cfg, n_micro=2)
    new_params, opt, m = step(params, init_opt_state(params),
                              torch_batch(batch))
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert int(opt.step) == 1
    assert_leafwise(dict(leaves_with_paths(opt.mu)), by_path(jopt.mu),
                    GRAD_TOL)
    # the caller's parameters are untouched (a functional update)
    for (name, a), b in zip(leaves_with_paths(params), leaves(new_params)):
        np.testing.assert_array_equal(a.numpy(), by_path(jp)[name])
        assert not torch.equal(a, b)


def test_prefill_and_decode_steps_match_the_port_model(models):
    cfg, _, _, np_params, batch = models["h2o-danube-3-4b"]
    params = params_from_numpy(cfg, np_params, "cpu")
    tok = torch.from_numpy(batch["tokens"])
    one = steps.make_prefill_step(cfg)
    two = steps.make_prefill_step(cfg, n_micro=2)
    l1, c1 = one(params, init_cache(cfg, B, S + 1), {"tokens": tok})
    l2, c2 = two(params, init_cache(cfg, B, S + 1), {"tokens": tok})
    torch.testing.assert_close(l1, l2, rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        torch.testing.assert_close(c1["seg0"][k], c2["seg0"][k], rtol=1e-5,
                                   atol=1e-5)
    dec = steps.make_decode_step(cfg)
    nxt = torch.argmax(l1, -1)[:, None]
    d1, _ = dec(params, c1, nxt, S)
    d2, _ = dec(params, c2, nxt, S)
    torch.testing.assert_close(d1, d2, rtol=1e-5, atol=1e-5)


def test_meshes_wait_for_a13(tmp_path):
    # (named when meshes were refused; they now run) the three step
    # factories on a one-rank ("data", "model") mesh of this process give
    # the unsharded steps' numbers, and hand back DTensors; one layer of
    # the reduced mamba2-130m (tests/test_torch_mesh.py runs four ranks)
    from repro_torch.launch.mesh import one_rank_mesh

    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              num_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    opt = init_opt_state(params)
    with one_rank_mesh(tmp_path, "cpu") as mesh:
        kw = dict(q_chunk=16, remat="none")
        p1, o1, m1 = steps.make_train_step(cfg, **kw)(params, opt, batch)
        p2, o2, m2 = steps.jit_train_step(cfg, mesh, params, opt, batch,
                                          **kw)(params, opt, batch)
        assert hasattr(p2["embed"], "placements")
        torch.testing.assert_close(m2["loss"], m1["loss"], rtol=0, atol=0)
        for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
            torch.testing.assert_close(b.full_tensor(), a, rtol=1e-6,
                                       atol=1e-6)
        prompt = {"tokens": batch["tokens"]}
        cache = init_cache(cfg, 2, 17)
        l1, c1 = steps.make_prefill_step(cfg, q_chunk=16)(
            params, init_cache(cfg, 2, 17), prompt)
        l2, c2 = steps.jit_prefill_step(cfg, mesh, params, cache, prompt,
                                        q_chunk=16)(params, cache, prompt)
        torch.testing.assert_close(l2.full_tensor(), l1, rtol=1e-6,
                                   atol=1e-6)
        nxt = torch.argmax(l1, -1)[:, None]
        d1, _ = steps.make_decode_step(cfg)(params, c1, nxt, 16)
        d2, _ = steps.jit_decode_step(cfg, mesh, params, cache, 2)(
            params, c2, nxt, 16)
        torch.testing.assert_close(d2.full_tensor(), d1, rtol=1e-6,
                                   atol=1e-6)


def test_train_matches_the_reference_from_its_weights(models):
    cfg, jcfg, _, np_params, _ = models["mamba2-130m"]
    kw = dict(steps=8, batch=4, seq_len=32, verbose=False)
    want = ref_train.train(jcfg, **kw)
    got = train(cfg, device="cpu", params=params_from_numpy(cfg, np_params,
                                                            "cpu"), **kw)
    assert got.final_step == want.final_step == 7
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    assert got.losses[-1] < got.losses[0]
    assert set(got.phase_totals) == {"data", "step"}


def test_fail_and_resume_equals_uninterrupted(tmp_path):
    cfg = get_config("mamba2-130m").reduced()
    kw = dict(steps=10, batch=4, seq_len=32, verbose=False, device="cpu")
    full = train(cfg, **kw)
    d = str(tmp_path)
    with pytest.raises(SimulatedFailure):
        train(cfg, ckpt_dir=d, ckpt_every=3, fail_at_step=7, **kw)
    res = train(cfg, ckpt_dir=d, ckpt_every=3, **kw)
    assert res.resumed_from == 6 and res.final_step == 9
    np.testing.assert_allclose(res.losses, full.losses[7:], rtol=1e-4)


def test_train_reports_vet_and_the_controller():
    cfg = get_config("mamba2-130m").reduced()
    res = train(cfg, steps=80, batch=2, seq_len=8, record_unit=5,
                verbose=False, device="cpu")
    assert len(res.losses) == 80
    assert res.vet is not None and res.vet >= 1.0 - 1e-6
    assert res.controller_decision.reason == "insufficient data"
    assert res.worker_vets is None


def test_cli_mirrors_the_reference():
    args = parse_args(["--arch", "mamba2-130m", "--reduced", "--steps", "3",
                       "--n-micro", "2", "--seq-len", "16"])
    assert (args.arch, args.reduced, args.steps, args.n_micro,
            args.seq_len, args.batch, args.lr, args.ckpt_dir) == \
        ("mamba2-130m", True, 3, 2, 16, 8, 3e-4, None)


def test_tune_gives_one_candidate_per_knob_pair_sorted():
    cfg = get_config("mamba2-130m").reduced()
    cands = tune(cfg, batch=4, seq_len=16, steps_per_candidate=6,
                 n_micro_options=(1, 2, 3), q_chunk_options=(8, 16),
                 verbose=False, device="cpu")
    assert sorted((c.knobs["n_micro"], c.knobs["q_chunk"]) for c in cands) \
        == [(1, 8), (1, 16), (2, 8), (2, 16)]  # 3 does not divide 4
    steps_s = [c.mean_step_s for c in cands]
    assert steps_s == sorted(steps_s)
    assert all(np.isfinite(c.vet) and c.vet >= 1.0 - 1e-6 for c in cands)


# ------------------------------------------------- the kernels' autograd routes
def route_grads(fn, inputs):
    """Input gradients of sum(fn(*inputs) * w) for a fixed random w."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    return torch.autograd.grad((out * w).sum(), ins)


def test_ssd_route_backward_is_the_plain_gradient(monkeypatch):
    g = torch.Generator().manual_seed(0)
    bsz, t, h, p, n = 2, 16, 3, 4, 8
    inputs = (torch.randn(bsz, t, h, p, generator=g),
              torch.rand(bsz, t, h, generator=g) * 0.5,
              -torch.linspace(1.0, 4.0, h),
              torch.randn(bsz, t, n, generator=g),
              torch.randn(bsz, t, n, generator=g),
              torch.ones(h))
    launches = []

    def launch(*args):
        launches.append(1)
        return ssd_scan_plain(*args[:6], chunk=args[6])

    monkeypatch.setattr(sd, "_launch", launch)
    got = route_grads(lambda *x: sd._SsdScan.apply(*x, 8), inputs)
    want = route_grads(lambda *x: ssd_scan_plain(*x, chunk=8), inputs)
    assert launches == [1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_route_backward_is_the_plain_gradient(monkeypatch):
    g = torch.Generator().manual_seed(1)
    inputs = (torch.randn(2, 40, 4, 8, generator=g),
              torch.randn(2, 40, 2, 8, generator=g),
              torch.randn(2, 40, 2, 8, generator=g))
    monkeypatch.setattr(fa, "_launch",
                        lambda q, k, v, causal, window, scale: attention_plain(
                            q, k, v, causal=causal, window=window,
                            scale=scale))
    got = route_grads(lambda *x: fa._FlashAttention.apply(*x, True, 16, None),
                      inputs)
    want = route_grads(lambda *x: attention_plain(*x, causal=True, window=16),
                       inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
