"""The decode step's CUDA graph (``models.graph``) and the tensor position
it needs.

On the CPU: ``decode_step`` at a 0-d int64 tensor position gives the int
position's logits and caches bit for bit on the reduced configs of every
decode family (GQA, windowed GQA, the int8 KV cache, MLA, MoE, the
hybrid); steps on the CPU, on a mesh or under forced routing run eager,
and ``graph.COUNTS`` names why.

On the card (marked ``gpu``; each skips in the ``cuda`` fixture without
one; ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_decode_graph.py``): on a reduced MoE and a reduced MLA
config, six decode steps replayed from the graph equal the eager step bit
for bit (logits, caches, the routing the caller's log records), each
step's logits survive the later replays, a new cache is a new key, and a
capture that raises leaves its key eager and the stream usable.
"""

import contextlib
import dataclasses

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import (NULL_CTX, decode_step, init_cache,
                                init_params, prefill)
from repro_torch.models import graph as G
from repro_torch.models import model as M
from repro_torch.models.layers import Routing, RoutingLog, recording
from repro_torch.obs import Tracer, tracing

BATCH, S = 2, 16

FAMILIES = {  # case: (registry name, config changes)
    "gqa": ("qwen3-14b", {}),
    "windowed_gqa": ("h2o-danube-3-4b", {}),  # window 16 < the positions
    "int8_kv": ("h2o-danube-3-4b", {"kv_cache_dtype": "int8"}),
    "mla": ("deepseek-v2-lite-16b", {}),
    "moe": ("deepseek-moe-16b", {}),
    "hybrid": ("zamba2-7b", {}),
}


def small(name, **changes):
    """(cfg, params) of a reduced config, drawn on the CPU."""
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


@pytest.fixture
def counts(monkeypatch):
    """A fresh ``graph.COUNTS`` and decode runner for the test."""
    monkeypatch.setattr(G, "COUNTS", G.GraphCounts())
    monkeypatch.setattr(M, "DECODE", G.DecodeGraphs(M._decode_step))
    return G


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_tensor_position_equals_int(case):
    name, changes = FAMILIES[case]
    cfg, params = small(name, **changes)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, S),
                           generator=torch.Generator().manual_seed(1))
    caches = [init_cache(cfg, BATCH, S + 8) for _ in range(2)]
    first = [prefill(cfg, params, c, {"tokens": prompt})[0] for c in caches]
    tok = torch.argmax(first[0], -1)[:, None]
    for i in range(6):
        a, _ = decode_step(cfg, params, caches[0], tok, S + i)
        b, _ = decode_step(cfg, params, caches[1], tok,
                           torch.tensor(S + i, dtype=torch.int64))
        assert torch.equal(a, b), f"step {i}"
        tok = torch.argmax(a, -1)[:, None]
    for x, y in zip(tree.leaves(caches[0]), tree.leaves(caches[1])):
        assert torch.equal(x, y)


def run_reason(reason, tmp_path):
    """A decode step that runs eager for ``reason``, after the CPU steps it
    needs; the ``graph`` attribute of its ``model.decode_step`` span."""
    tr = Tracer()
    tok = torch.zeros((BATCH, 1), dtype=torch.int64)
    if reason == "mesh":
        from repro_torch.launch.mesh import one_rank_mesh

        cfg, params = small("qwen3-14b", num_layers=1)
        cache = init_cache(cfg, BATCH, S)
        with one_rank_mesh(tmp_path, "cpu") as mesh:
            step = steps.jit_decode_step(cfg, mesh, params, cache, BATCH)
            with tracing(tr):
                step(params, cache, tok, 0)
    else:
        cfg, params = small("deepseek-moe-16b")
        log = RoutingLog()
        with recording(log):
            decode_step(cfg, params, init_cache(cfg, BATCH, S), tok, 0)
        with recording(RoutingLog(force=log) if reason == "forced"
                       else RoutingLog()), tracing(tr):
            decode_step(cfg, params, init_cache(cfg, BATCH, S), tok, 0)
    return [dict(r.attrs)["graph"] for r in tr.records
            if r.name == "model.decode_step"]


@pytest.mark.parametrize("reason, eager", [
    ("cpu", {"cpu": 2}), ("forced", {"cpu": 1, "forced": 1}),
    ("mesh", {"mesh": 1})])
def test_ineligible_steps_run_eager_and_say_why(counts, reason, eager,
                                                tmp_path):
    assert run_reason(reason, tmp_path) == ["eager"]
    assert dict(counts.COUNTS.eager) == eager
    assert counts.COUNTS.captures == counts.COUNTS.replays == 0


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(dev, name):
    cfg, params = small(name)
    return cfg, tree.tree_map(lambda t: t.to(dev), params)


def routing_equal(a, b):
    return len(a.calls) == len(b.calls) and all(
        torch.equal(getattr(x, f.name), getattr(y, f.name))
        for x, y in zip(a.calls, b.calls)
        for f in dataclasses.fields(Routing))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_replay_equals_eager(cuda, counts, name):
    cfg, params = on(cuda, name)
    ce, cg = (init_cache(cfg, BATCH, S, device=cuda) for _ in range(2))
    tok = torch.randint(0, cfg.vocab_size, (BATCH, 1), device=cuda)
    log_e, log_g = RoutingLog(), RoutingLog()
    got, kept = [], []
    for pos in range(6):
        with recording(log_e):
            want = M._decode_step(cfg, params, ce, tok, pos, NULL_CTX)
        with recording(log_g):
            logits, _ = decode_step(cfg, params, cg, tok, pos)
        assert torch.equal(logits, want), f"step {pos}"
        got.append(logits)
        kept.append(logits.clone())
        tok = torch.argmax(want, -1)[:, None]
    for a, b in zip(got, kept):  # no later replay wrote into a step's logits
        assert torch.equal(a, b)
    for x, y in zip(tree.leaves(ce), tree.leaves(cg)):
        assert torch.equal(x, y)
    assert log_e.calls and routing_equal(log_e, log_g)
    c = counts.COUNTS
    assert (c.eager["first"], c.captures, c.replays) == (1, 1, 4)


@pytest.mark.gpu
def test_a_new_cache_is_a_new_key(cuda, counts):
    cfg, params = on(cuda, "deepseek-moe-16b")
    tok = torch.zeros((BATCH, 1), dtype=torch.int64, device=cuda)
    a, b = (init_cache(cfg, BATCH, S, device=cuda) for _ in range(2))
    for cache in (a, a, a, b, b, a, b):
        decode_step(cfg, params, cache, tok, 0)
    c = counts.COUNTS
    assert (c.eager["first"], c.captures, c.replays) == (2, 2, 3)


@pytest.mark.gpu
def test_a_failed_capture_stays_eager(cuda, counts, monkeypatch):
    cfg, params = on(cuda, "deepseek-moe-16b")
    tok = torch.zeros((BATCH, 1), dtype=torch.int64, device=cuda)
    head = M._head

    def syncing_head(*args):  # a host sync: refused while capturing
        out = head(*args)
        out.sum().item()
        return out

    monkeypatch.setattr(M, "_head", syncing_head)
    bad, ref = (init_cache(cfg, BATCH, S, device=cuda) for _ in range(2))
    for pos in range(4):
        with (pytest.warns(RuntimeWarning) if pos == 1
              else contextlib.nullcontext()):
            logits, _ = decode_step(cfg, params, bad, tok, pos)
        want = M._decode_step(cfg, params, ref, tok, pos, NULL_CTX)
        assert torch.equal(logits, want), f"step {pos}"
    c = counts.COUNTS
    assert (c.eager["first"], c.eager["capture_failed"], c.captures) \
        == (1, 3, 0)
    assert c.error
    monkeypatch.setattr(M, "_head", head)
    decode_step(cfg, params, bad, tok, 4)  # that key stays eager
    assert c.eager["capture_failed"] == 4
    fresh, ref = (init_cache(cfg, BATCH, S, device=cuda) for _ in range(2))
    for pos in range(3):  # the stream captures and replays a new key
        logits, _ = decode_step(cfg, params, fresh, tok, pos)
        want = M._decode_step(cfg, params, ref, tok, pos, NULL_CTX)
        assert torch.equal(logits, want), f"step {pos}"
    assert (c.captures, c.replays) == (1, 1)
