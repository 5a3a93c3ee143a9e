"""The port's tracing seam inside the model step: the ambient tracer
(``obs.trace.tracing`` / ``region``), the model's spans (``model.prefill``,
``model.decode_step``, ``model.layer``, ``model.attn``, ``model.moe.route``
/ ``experts`` / ``combine``, ``model.ffn``, ``model.ssm``, ``model.head``)
on the reduced configs, and the ``repro_torch.*`` ranges every span opens
while ``torch.profiler`` records.

Span trees run on a counting clock, so every timestamp is an exact small
float and containment is checked exactly.  Outputs are held bit for bit
with and without a tracer, and under the profiler."""

import dataclasses
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                prefill, segments_of)
from repro_torch.models.layers import moe_capacity, moe_local
from repro_torch.obs import Tracer, region, span, tracing
from repro_torch.obs.trace import _NULL

BATCH, S = 2, 16


def counting_clock():
    """0.0, 1.0, 2.0, ... : one tick per clock read."""
    state = {"t": -1.0}

    def clock():
        state["t"] += 1.0
        return state["t"]

    return clock


@pytest.fixture(scope="module", params=["deepseek-moe-16b",
                                        "deepseek-v2-lite-16b", "zamba2-7b",
                                        "mamba2-130m"])
def model(request):
    """(cfg, params, prompt tokens) of a reduced config."""
    cfg = get_config(request.param).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, S),
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


def run_steps(cfg, params, tokens):
    """A prefill and one greedy decode step on a cache of their own:
    (prefill logits, decode logits, cache)."""
    cache = init_cache(cfg, BATCH, S + 1)
    first, cache = prefill(cfg, params, cache, {"tokens": tokens})
    nxt = torch.argmax(first, dim=-1)[:, None]
    second, cache = decode_step(cfg, params, cache, nxt, S)
    return first, second, cache


def expected_layer(cfg, kind: str, li: int):
    """(name, attrs) of the spans one layer's span holds, in order."""
    attn_ffn = [("model.attn", {}), ("model.ffn", {"shared": 0})]
    if kind == "dense":
        return attn_ffn
    if kind == "moe":
        out = [("model.attn", {}), ("model.moe.route", None),
               ("model.moe.experts", {}), ("model.moe.combine", {})]
        return out + ([("model.ffn", {"shared": 1})]
                      if cfg.n_shared_experts else [])
    if kind == "zamba" and li % cfg.hybrid_attn_every == 0:
        return attn_ffn + [("model.ssm", {})]
    return [("model.ssm", {})]


def children(records, parent):
    return sorted((r for r in records if r.parent == parent),
                  key=lambda r: r.ts)


def check_step_tree(cfg, records, root_name, root_attrs, tokens):
    """One step's span tree: the root, a ``model.layer`` per layer with its
    kind's spans inside, then ``model.head``; every child inside its
    parent."""
    by_sid = {r.sid: r for r in records}
    for r in records:
        if r.parent is not None:
            p = by_sid[r.parent]
            assert p.ts < r.ts and r.ts + r.dur < p.ts + p.dur, (r, p)
    (root,) = [r for r in records if r.parent is None]
    assert (root.name, dict(root.attrs)) == (root_name, root_attrs)
    kids = children(records, root.sid)
    layers = [(k, li) for k, n in segments_of(cfg) for li in range(n)]
    assert [r.name for r in kids] == ["model.layer"] * len(layers) + [
        "model.head"]
    for layer, (rec, (kind, li)) in enumerate(zip(kids, layers)):
        assert dict(rec.attrs) == {"layer": layer, "kind": kind}
        want = expected_layer(cfg, kind, li)
        got = children(records, rec.sid)
        assert [r.name for r in got] == [n for n, _ in want]
        for r, (name, attrs) in zip(got, want):
            if name == "model.moe.route":
                attrs = {"tokens": tokens,
                         "capacity": moe_capacity(cfg, tokens)}
            assert dict(r.attrs) == attrs
            assert not children(records, r.sid)  # the leaves of the tree
    assert not children(records, kids[-1].sid)


@pytest.mark.parametrize("step", ["prefill", "decode_step"])
def test_span_tree_of_a_model_step(model, step):
    cfg, params, tokens = model
    cache = init_cache(cfg, BATCH, S + 1)
    tr = Tracer(clock=counting_clock())
    if step == "prefill":
        with tracing(tr):
            prefill(cfg, params, cache, {"tokens": tokens})
        check_step_tree(cfg, tr.records, "model.prefill",
                        {"batch": BATCH, "tokens": S}, BATCH * S)
    else:
        prefill(cfg, params, cache, {"tokens": tokens})
        with tracing(tr):
            decode_step(cfg, params, cache, tokens[:, :1], S)
        check_step_tree(cfg, tr.records, "model.decode_step",
                        {"batch": BATCH, "pos": S, "graph": "eager"}, BATCH)
    # the counting clock reads twice a span: the root spans them all
    root = max(tr.records, key=lambda r: r.dur)
    assert root.dur == 2 * len(tr.records) - 1


def test_outputs_are_identical_with_and_without_a_tracer(model):
    cfg, params, tokens = model
    plain = run_steps(cfg, params, tokens)
    tr = Tracer()
    with tracing(tr):
        traced = run_steps(cfg, params, tokens)
    with profile(activities=[ProfilerActivity.CPU]), tracing(Tracer()):
        profiled = run_steps(cfg, params, tokens)
    assert tr.records
    for got in (traced, profiled):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        assert got[2].keys() == plain[2].keys()
        for seg in plain[2]:
            for name, t in plain[2][seg].items():
                assert torch.equal(got[2][seg][name], t), (seg, name)


def test_region_without_a_tracer_is_the_shared_null():
    assert region("model.layer", layer=0, kind="moe") is _NULL
    with tracing(None):
        assert region("model.attn") is _NULL
    with tracing(Tracer()):
        assert region("model.attn") is not _NULL
        with tracing(None):
            assert region("model.attn") is _NULL


def test_no_tracer_opens_no_range_under_the_profiler():
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(cfg, params, init_cache(cfg, 1, 8), {"tokens": tokens})
    assert ranges(prof) == []


def test_tracing_restores_the_previous_tracer_after_an_exception():
    outer, inner = Tracer(), Tracer()
    with tracing(outer):
        with pytest.raises(RuntimeError, match="boom"):
            with tracing(inner):
                with region("model.layer"):
                    raise RuntimeError("boom")
        with region("model.head"):
            pass
    assert region("model.head") is _NULL
    assert [r.name for r in inner.records] == ["model.layer"]
    assert [r.name for r in outer.records] == ["model.head"]


def test_a_new_thread_starts_without_the_ambient_tracer():
    seen = []
    with tracing(Tracer()):
        th = threading.Thread(target=lambda: seen.append(region("x")))
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen == [_NULL]


def test_moe_spans_split_the_moe_call():
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    p = params["seg1"]
    p = {k: v[0] for k, v in p["moe"].items() if k != "shared"}
    x2d = torch.randn(12, cfg.d_model, generator=torch.Generator()
                      .manual_seed(2))
    cap = moe_capacity(cfg, 12)
    want = moe_local(p, x2d, top_k=cfg.moe_top_k, capacity=cap)
    tr = Tracer(clock=counting_clock())
    with tracing(tr):
        got = moe_local(p, x2d, top_k=cfg.moe_top_k, capacity=cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert [(r.name, dict(r.attrs), r.parent) for r in tr.records] == [
        ("model.moe.route", {"tokens": 12, "capacity": cap}, None),
        ("model.moe.experts", {}, None), ("model.moe.combine", {}, None)]
    assert [r.ts for r in tr.records] == [0.0, 2.0, 4.0]


def ranges(prof):
    """The profiler's ``repro_torch.*`` CPU ranges: (name, start, end)."""
    return [(e.name()[len("repro_torch."):], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro_torch.")
            and e.device_type() == DeviceType.CPU]


def test_profiler_ranges_mirror_the_records():
    cfg = get_config("deepseek-moe-16b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, S),
                           generator=torch.Generator().manual_seed(1))
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing(tr):
            run_steps(cfg, params, tokens)
    got = ranges(prof)
    assert sorted(n for n, _, _ in got) == sorted(r.name for r in tr.records)
    # match each record to its range: the i-th of a name by start on both
    # clocks
    rng = {}
    for name in {r.name for r in tr.records}:
        recs = sorted((r for r in tr.records if r.name == name),
                      key=lambda r: r.ts)
        marks = sorted((g for g in got if g[0] == name), key=lambda g: g[1])
        rng.update({r.sid: m for r, m in zip(recs, marks)})
    for r in tr.records:
        if r.parent is not None:
            _, s, e = rng[r.sid]
            _, ps, pe = rng[r.parent]
            assert ps <= s and e <= pe, (r, tr.records)
    tops = [rng[r.sid] for r in tr.records if r.parent is None]
    assert [n for n, _, _ in sorted(tops, key=lambda g: g[1])] == [
        "model.prefill", "model.decode_step"]


def test_fleet_spans_open_ranges_and_only_spans_do():
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(tr, "mux.tick", tid=1):
            with span(tr, "engine.dispatch", tid=1, rows=3):
                pass
        with span(None, "mux.tick"):
            pass
        with region("model.layer"):
            pass
    names = [(n, s) for n, s, _ in ranges(prof)]
    assert sorted(n for n, _ in names) == ["engine.dispatch", "mux.tick"]
    # outside the profiler a span opens no range and records the same
    with span(tr, "mux.tick"):
        pass
    assert [r.name for r in tr.records] == ["engine.dispatch", "mux.tick",
                                            "mux.tick"]


def test_mesh_moe_records_the_local_spans(tmp_path):
    """On a one-rank ("data", "model") mesh the MoE runs through
    ``local_map``; its spans are the local path's."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import one_rank_mesh

    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, S),
                                      generator=torch.Generator()
                                      .manual_seed(1))}
    local, mesh_tr = Tracer(), Tracer()
    with tracing(local):
        steps.make_prefill_step(cfg, q_chunk=S)(
            params, init_cache(cfg, BATCH, S), prompt)
    with one_rank_mesh(tmp_path, "cpu") as mesh:
        cache = init_cache(cfg, BATCH, S)
        fn = steps.jit_prefill_step(cfg, mesh, params, cache, prompt,
                                    q_chunk=S)
        with tracing(mesh_tr):
            fn(params, cache, prompt)

    def tree(tr):
        by_sid = {r.sid: r for r in tr.records}
        return sorted((r.name, dict(r.attrs).get("tokens"),
                       None if r.parent is None else by_sid[r.parent].name)
                      for r in tr.records)

    assert tree(mesh_tr) == tree(local)
    assert "model.moe.combine" in {r.name for r in mesh_tr.records}
