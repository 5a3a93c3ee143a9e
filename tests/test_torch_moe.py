"""The port's MoE family (``repro_torch.models.layers.moe_*``, the MoE
transformer block, the deepseek-moe-16b model) against the reference's, on
the reduced deepseek-moe-16b (4 layers: one dense, then three MoE layers of
8 routed experts of width 64, top 2, one shared expert; d_model 128), with
weights from the reference's ``init_params`` handed over as numpy arrays
(``params_from_numpy``) and inputs from numpy seeds.

Routing is held exactly: each token's experts and each expert's gathered
tokens equal the reference's ``lax.top_k`` indices, order included, at
``capacity_factor`` 1.25 (the capacity drops routed tokens, which the test
asserts) and 8.0 (it drops none), and with the router zeroed, where every
probability and every weight of an expert's column ties.  None of the
seeded cases has a near-tie flip, so none is excused.  Values, f32 on the
CPU, each library summing in its own order: the MoE output and aux to
1e-5; the block and the model's logits and caches to 1e-4; ``loss_fn``
to 1e-5 relative and each gradient leaf to 1e-4 of that leaf's largest,
with ``remat`` none, full and dots (the experts' products have a batch
dim, so ``dots`` recomputes them, as the reference's
``checkpoint_dots_with_no_batch_dims`` does; the three modes give the
port the same gradients); ``train()``'s losses over 8 steps within rtol
1e-4 of the reference's ``train()``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.configs as ref_configs
import repro.launch.train as ref_train
import repro.models as ref_models
import repro.models.blocks as ref_blocks
import repro.models.layers as ref_layers
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
from repro_torch.models import (decode_step, init_cache, init_params,
                                loss_fn, params_from_numpy, prefill,
                                segments_of)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import leaves_with_paths

ARCH = "deepseek-moe-16b"
MOE_TOL, TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4, 1e-5, 1e-4
BATCH, S, STEPS = 2, 32, 8


@pytest.fixture(scope="module")
def moe():
    """(cfg, ref cfg, ref params, numpy params)."""
    jcfg = ref_configs.get_config(ARCH).reduced()
    jp = jax.jit(functools.partial(ref_models.init_params, jcfg,
                                   dtype=jnp.float32))(jax.random.PRNGKey(0))
    return get_config(ARCH).reduced(), jcfg, jp, jax.tree.map(np.asarray, jp)


def layer_of(tree, i):
    if isinstance(tree, dict):
        return {k: layer_of(v, i) for k, v in tree.items()}
    return tree[i]


def ref_routing(jp_moe, x2d, top_k, capacity):
    """The reference's two ``lax.top_k`` selections (``_moe_local``):
    each token's experts, each expert's gathered tokens."""
    probs = jax.nn.softmax(jnp.asarray(x2d, jnp.float32) @ jp_moe["router"],
                           axis=-1)
    top_vals, top_idx = lax.top_k(probs, top_k)
    top_vals = top_vals / jnp.sum(top_vals, axis=-1, keepdims=True)
    t, e = probs.shape
    combine = jnp.zeros((t, e), jnp.float32).at[
        jnp.arange(t)[:, None], top_idx].set(top_vals)
    _, idx = jax.vmap(lambda w: lax.top_k(w, capacity))(combine.T)
    return top_idx, idx


def moe_layer(moe, zero_router=False):
    cfg, _, jp, np_params = moe
    jl = layer_of(jp["seg1"], 0)["moe"]
    tl = layer_of(params_from_numpy(cfg, np_params, "cpu")["seg1"], 0)["moe"]
    if zero_router:
        jl = {**jl, "router": jnp.zeros_like(jl["router"])}
        tl = {**tl, "router": torch.zeros_like(tl["router"])}
    return jl, tl


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["seeded", "zero_router"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_local_matches_the_reference(moe, capacity_factor, zero_router):
    cfg, jcfg = moe[0], moe[1]
    jl, tl = moe_layer(moe, zero_router)
    x = np.random.default_rng(3).standard_normal(
        (BATCH * S, cfg.d_model)).astype(np.float32)
    cap = min(max(1, int(BATCH * S * cfg.moe_top_k * capacity_factor)
                  // cfg.n_routed_experts), BATCH * S)
    want, jaux = jax.jit(functools.partial(
        ref_layers._moe_local, top_k=cfg.moe_top_k, capacity=cap,
        tp_axis=None))(jl, jnp.asarray(x))
    with L.recording(L.RoutingLog()) as log:
        got, aux = L.moe_local(tl, torch.from_numpy(x), top_k=cfg.moe_top_k,
                               capacity=cap)
    r = log.calls[0]
    top_idx, idx = (np.asarray(a) for a in jax.jit(functools.partial(
        ref_routing, top_k=cfg.moe_top_k, capacity=cap))(jl, x))
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    if zero_router:  # every value tied: the lowest indices, in order
        assert (top_idx == np.arange(cfg.moe_top_k)).all()
        assert (idx == np.arange(cap)).all()
    dropped = int(r.dropped)
    assert (dropped > 0) == (capacity_factor == 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=MOE_TOL)
    # a deterministic combine: the same call gives the same bits
    again, _ = L.moe_local(tl, torch.from_numpy(x), top_k=cfg.moe_top_k,
                           capacity=cap)
    assert torch.equal(again, got)
    # the same call forced to its own routing gives the same bits
    with L.recording(L.RoutingLog(force=log)) as replay:
        forced, _ = L.moe_local(tl, torch.from_numpy(x), top_k=cfg.moe_top_k,
                                capacity=cap)
    assert torch.equal(forced, got)
    assert torch.equal(replay.calls[0].slot, r.slot)


def test_capacity_is_the_reference_arithmetic(moe):
    cfg = moe[0]  # 8 experts, top 2, capacity factor 1.25
    assert [L.moe_capacity(cfg, t) for t in (1, 2, 3, 4, 64, 4096)] == \
        [1, 1, 1, 1, 20, 1280]
    full = get_config(ARCH)  # 64 experts, top 6: a decode step's B = 2
    assert L.moe_capacity(full, 2) == 1 and L.moe_capacity(full, 4096) == 480


def test_moe_apply_with_the_shared_expert_matches_the_reference(moe):
    cfg, jcfg = moe[0], moe[1]
    jl, tl = moe_layer(moe)
    assert "shared" in tl
    x = np.random.default_rng(4).standard_normal(
        (BATCH, S, cfg.d_model)).astype(np.float32)
    want, jaux = ref_layers.moe_apply(jl, jnp.asarray(x), jcfg,
                                      ref_layers.NULL_CTX)
    got, aux = L.moe_apply(tl, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=MOE_TOL)
    # the context off a mesh is the one-device path (the expert-parallel
    # branch on a mesh: tests/test_torch_mesh.py)
    again, aux2 = L.moe_apply(tl, torch.from_numpy(x), cfg, L.NULL_CTX)
    assert torch.equal(again, got) and torch.equal(aux2, aux)


def test_forced_routing_of_another_shape_is_refused(moe):
    cfg = moe[0]
    _, tl = moe_layer(moe)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, cfg.d_model)).astype(np.float32))
    with L.recording(L.RoutingLog()) as log:
        L.moe_local(tl, x, top_k=2, capacity=4)
    with pytest.raises(ValueError, match="forced selection"):
        with L.recording(L.RoutingLog(force=log)):
            L.moe_local(tl, x[:8], top_k=2, capacity=4)
    with pytest.raises(ValueError, match="has 1 calls"):
        with L.recording(L.RoutingLog(force=log)):
            L.moe_local(tl, x, top_k=2, capacity=4)
            L.moe_local(tl, x, top_k=2, capacity=4)
    assert L.ROUTING is None  # recording is off again


def test_moe_block_matches_the_reference(moe):
    """Layer 0 of the MoE segment: ``block_apply`` (with its aux),
    ``block_prefill`` into a cache and one ``block_decode`` step."""
    cfg, jcfg, jp, np_params = moe
    jl = layer_of(jp["seg1"], 0)
    tl = layer_of(params_from_numpy(cfg, np_params, "cpu")["seg1"], 0)
    x = np.random.default_rng(6).standard_normal(
        (BATCH, S, cfg.d_model)).astype(np.float32)
    jit = lambda f: jax.jit(functools.partial(f, cfg=jcfg))  # noqa: E731
    want, jaux = jit(ref_blocks.block_apply)(jl, jnp.asarray(x))
    got, aux = B.block_apply(tl, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=MOE_TOL)
    assert float(aux) > 0
    jc = ref_blocks.attn_cache_shape(jcfg, BATCH, S + 1, jnp.float32)
    want, jc = jit(ref_blocks.block_prefill)(jl, jnp.asarray(x), cache=jc)
    tc = B.attn_cache_shape(cfg, BATCH, S + 1, torch.float32)
    got, tc = B.block_prefill(tl, torch.from_numpy(x), cfg, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    x1 = x[:, :1] * 0.5
    want, jc = jit(ref_blocks.block_decode)(jl, jnp.asarray(x1), cache=jc,
                                            pos=jnp.asarray(S))
    got, tc = B.block_decode(tl, torch.from_numpy(x1), cfg, tc, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=TOL, atol=TOL)


def test_init_params_has_the_reference_layout(moe):
    cfg, _, jp, np_params = moe
    assert segments_of(cfg) == (("dense", 1), ("moe", 3))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert shapes(init_params(cfg, torch.Generator().manual_seed(0))) == want
    assert shapes(params_from_numpy(cfg, np_params)) == want
    # a bf16 model keeps the router in f32, as the reference does
    jb = jax.eval_shape(functools.partial(ref_models.init_params, moe[1],
                                          dtype=jnp.bfloat16),
                        jax.random.PRNGKey(0))
    bf = params_from_numpy(cfg, jax.tree.map(
        lambda a, sd: np.asarray(jnp.asarray(a, sd.dtype)), np_params, jb),
        dtype=torch.bfloat16)
    assert shapes(bf) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jb)
    assert bf["seg1"]["moe"]["router"].dtype == torch.float32
    assert bf["seg1"]["moe"]["wg"].dtype == torch.bfloat16
    drawn = init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert drawn["seg1"]["moe"]["router"].dtype == torch.float32


def by_path(jtree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jtree)}


def batch_of(cfg, seq=S):
    return RefPipeline(cfg.vocab_size, BATCH, seq, seed=1).batch_at(0)


def test_loss_and_gradients_match_the_reference(moe):
    """``loss_fn`` and every leaf's gradient under remat none, full and
    dots against ``jax.value_and_grad`` with the same remat; the port's
    three modes give the same gradients."""
    cfg, jcfg, jp, np_params = moe
    batch = batch_of(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for remat in ("none", "full", "dots"):
        (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
            lambda p: ref_models.loss_fn(jcfg, p,
                                         jax.tree.map(jnp.asarray, batch),
                                         remat=remat),
            has_aux=True))(jp)
        params = params_from_numpy(cfg, np_params, "cpu")
        named = leaves_with_paths(params)
        for _, t in named:
            t.requires_grad_()
        loss, parts = loss_fn(cfg, params, tb, remat=remat)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        parts = {k: v.detach() for k, v in parts.items()}
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        for k in ("ce", "aux"):
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
        assert float(parts["aux"]) > 0
        want = by_path(jgrads)
        got[remat] = {n: g.numpy() for (n, _), g in zip(named, grads)}
        assert sorted(got[remat]) == sorted(want)
        for name, g in got[remat].items():
            scale = float(np.abs(want[name]).max())
            assert scale > 0, name  # router, experts and shared all reached
            err = float(np.abs(g - want[name]).max())
            assert err <= GRAD_TOL * scale, f"{remat} {name}: {err:.3g}"
    for remat in ("full", "dots"):
        for name, g in got[remat].items():
            np.testing.assert_allclose(g, got["none"][name], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{remat} {name}")


def test_prefill_and_greedy_decode_match_the_reference(moe):
    """Prefill (capacity over the prompt's B * S tokens) and 8 greedy
    decode steps (capacity 1: each expert takes one of the 2 tokens)."""
    cfg, jcfg, jp, np_params = moe
    params = params_from_numpy(cfg, np_params, "cpu")
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    s_max = S + STEPS
    jcache = ref_models.init_cache(jcfg, BATCH, s_max, dtype=jnp.float32)
    jlogits, jcache = jax.jit(functools.partial(ref_models.prefill, jcfg))(
        jp, jcache, {"tokens": jnp.asarray(tokens)})
    ref_decode = jax.jit(functools.partial(ref_models.decode_step, jcfg))
    cache = init_cache(cfg, BATCH, s_max)
    assert sorted(cache) == ["seg0", "seg1"]
    logits, _ = prefill(cfg, params, cache,
                        {"tokens": torch.from_numpy(tokens).long()})

    def same_cache():
        for seg in ("seg0", "seg1"):
            for k in ("k", "v"):
                np.testing.assert_allclose(cache[seg][k].numpy(),
                                           np.asarray(jcache[seg][k]),
                                           rtol=TOL, atol=TOL)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    same_cache()
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = ref_decode(jp, jcache, jtok, jnp.asarray(S + i))
        logits, _ = decode_step(cfg, params, cache, tok, S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    same_cache()


def test_train_matches_the_reference_from_its_weights(moe):
    cfg, jcfg, _, np_params = moe
    kw = dict(steps=8, batch=BATCH, seq_len=S, verbose=False)
    want = ref_train.train(jcfg, **kw)
    got = train(cfg, device="cpu", params=params_from_numpy(cfg, np_params,
                                                            "cpu"), **kw)
    assert got.final_step == want.final_step == 7
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def test_serve_runs_the_moe_model():
    """``serve`` on the reduced MoE model: its first token is the argmax of
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


def routed(probs, k, cap, top_idx=None):
    """A ``Routing`` from probabilities, as ``moe_local`` makes it (its
    token choice forced to ``top_idx`` when given)."""
    top_v, top_i = L._top(probs, k, top_idx)
    top_v = top_v / top_v.sum(-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(1, top_i, top_v)
    _, idx = L._top(combine.T, cap, None)
    return L.Routing(probs, top_i, combine, idx, L._slots(idx, top_i,
                                                          probs.shape[0]))


def test_routing_flips_measure_each_flip_at_its_edge():
    """Token 0's 2nd and 3rd probabilities lie 1e-6 apart (relative): a
    path that takes the 3rd is one token flip at gap ~1e-6 under the
    reference side's values, forced to that choice; capacity 1 of 3
    tokens keeps 2 of the 6 routed slots."""
    probs = torch.tensor([[0.5, 0.25, 0.25 * (1 - 1e-6), 0.0],
                          [0.6, 0.3, 0.1, 0.0],
                          [0.7, 0.2, 0.05, 0.05]])
    ref, got = L.RoutingLog(), L.RoutingLog()
    ref.calls.append(routed(probs, 2, 1))
    assert ref.calls[0].top_idx[0].tolist() == [0, 1]
    assert ref.calls[0].expert_idx[0].tolist() == [2]  # 0.7/0.9 the heaviest
    assert int(ref.calls[0].dropped) == 4  # 6 routed slots, 2 kept
    flipped = torch.tensor([[0, 2], [0, 1], [0, 1]])
    got.calls.append(routed(probs, 2, 1, flipped))
    assert L.same_routing(ref, ref) and not L.same_routing(ref, got)
    none = L.routing_flips(ref, ref)
    assert none == {"calls": 1, "token_flips": 0, "capacity_flips": 0,
                    "worst_gap": 0.0}
    forced = L.RoutingLog()  # the reference side at the other routing
    forced.calls.append(routed(probs, 2, 1, flipped))
    res = L.routing_flips(forced, got)
    assert res["token_flips"] == 1 and res["capacity_flips"] == 0
    assert 0 < res["worst_gap"] <= 1.1e-6
    far = L.RoutingLog()  # a choice far from the edge is no near-tie
    far.calls.append(routed(probs, 2, 1, torch.tensor([[0, 3], [0, 1],
                                                       [0, 1]])))
    assert L.routing_flips(forced, far)["worst_gap"] == 1.0
    # as many tokens as experts: each flip is still counted as its kind
    square = torch.cat([probs, torch.tensor([[0.1, 0.2, 0.3, 0.4]])])
    forced, got = L.RoutingLog(), L.RoutingLog()
    pick = torch.tensor([[0, 2], [0, 1], [0, 1], [3, 2]])
    forced.calls.append(routed(square, 2, 1, pick))
    got.calls.append(routed(square, 2, 1, pick))
    res = L.routing_flips(forced, got)
    assert (res["token_flips"], res["capacity_flips"]) == (1, 0)
    with pytest.raises(ValueError, match="calls"):
        L.routing_flips(ref, L.RoutingLog())
    moved = got.to("cpu")
    assert L.same_routing(moved, got) and moved.calls[0] is not got.calls[0]
