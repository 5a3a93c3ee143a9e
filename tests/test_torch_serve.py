"""The port's serve entry point (``repro_torch.launch.serve``) on the CPU,
reduced mamba2-130m and reduced h2o-danube-3-4b, with enough decode steps
for two 32-unit dashboard windows (331 tokens at ``record_unit=5``: 330
records, 66 units).

The dashboard is held to the port's own estimator over the same profile:
``vet``/``ei``/``pr`` equal ``VetEngine.vet_one`` over the run's unit
times, and the window snapshots equal ``vet_sliding`` over them: the same
cuts and counts, and values to 1e-12 (the fused path takes each window's PR
from f64 prefix sums over its arena, whose offsets differ between the
stream's ring and ``vet_sliding``'s gather).  Timings are whatever this CPU
gives; nothing here is a device number.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.engine import VetEngine
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import parse_args, serve, serve_inputs

GEN = 331


@pytest.fixture(scope="module")
def result():
    cfg = get_config("mamba2-130m").reduced()
    return cfg, serve(cfg, batch=2, prompt_len=32, gen_len=GEN, device="cpu",
                      verbose=False)


def test_serve_runs_two_windows_and_generates(result):
    cfg, res = result
    assert res.tokens.shape == (2, GEN) and res.tokens.dtype == np.int32
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert res.unit_times.shape == ((GEN - 1) // 5,)
    assert res.windows is not None and res.windows.workers == 2
    assert res.mux.streams == 1 and res.mux.ticks == (GEN - 1) // 5 + 1
    assert res.tokens_per_s > 0 and res.prefill_s > 0


def test_dashboard_equals_the_ports_estimator(result):
    _, res = result
    times = res.unit_times
    r = VetEngine("cuda", buckets=min(64, times.size // 4),
                  device="cpu").vet_one(times)
    assert (res.vet, res.ei, res.pr) == (float(r.vet), float(r.ei),
                                         float(r.pr))
    win = VetEngine("cuda", buckets=64, device="cpu").vet_sliding(
        times, window=32, stride=32)
    for name in ("t", "n"):
        np.testing.assert_array_equal(getattr(res.windows, name),
                                      getattr(win, name))
    for name in ("vet", "ei", "oc", "pr"):  # f64 PR sums over other offsets
        np.testing.assert_allclose(getattr(res.windows, name),
                                   getattr(win, name), rtol=1e-12, atol=0)


def test_first_token_is_the_prefill_argmax(result):
    from repro_torch.models import init_cache, prefill
    cfg, res = result
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=32, seed=0,
                                   dtype=torch.float32, device="cpu")
    logits, _ = prefill(cfg, params, init_cache(cfg, 2, 32),
                        {"tokens": prompts})
    np.testing.assert_array_equal(res.tokens[:, 0],
                                  torch.argmax(logits, -1).numpy())


def test_serve_refuses_a_prompt_off_the_chunk():
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        serve(get_config("mamba2-130m").reduced(), batch=1, prompt_len=12,
              gen_len=4, device="cpu", verbose=False)


@pytest.fixture(scope="module")
def dense_result():
    cfg = get_config("h2o-danube-3-4b").reduced()
    return cfg, serve(cfg, batch=2, prompt_len=48, gen_len=GEN, device="cpu",
                      verbose=False)


def test_dense_serve_runs_two_windows_and_generates(dense_result):
    """Prompt 48 and 331 generated tokens pass the reduced window of 16, so
    prefill and decode both mask by the window."""
    cfg, res = dense_result
    assert res.tokens.shape == (2, GEN) and res.tokens.dtype == np.int32
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert res.windows is not None and res.windows.workers == 2
    assert np.isfinite(res.windows.vet).all() and res.vet >= 1.0 - 1e-6
    assert res.init_s > 0 and res.prefill_s > 0


def test_dense_first_token_is_the_prefill_argmax(dense_result):
    from repro_torch.models import init_cache, prefill
    cfg, res = dense_result
    params, prompts = serve_inputs(cfg, batch=2, prompt_len=48, seed=0,
                                   dtype=torch.float32, device="cpu")
    logits, _ = prefill(cfg, params, init_cache(cfg, 2, 48),
                        {"tokens": prompts})
    np.testing.assert_array_equal(res.tokens[:, 0],
                                  torch.argmax(logits, -1).numpy())


def test_serve_refuses_a_prompt_off_the_attention_chunk():
    """Above 1024 an attention prompt must be a multiple of the reference's
    query chunk; the check runs before any weight is drawn, so even the
    full-width config refuses at once."""
    for cfg in (get_config("h2o-danube-3-4b"),
                get_config("h2o-danube-3-4b").reduced()):
        with pytest.raises(ValueError, match="attention query chunk 1024"):
            serve(cfg, batch=1, prompt_len=1500, gen_len=4, device="cpu",
                  verbose=False)


def test_main_parses_the_reference_flags(monkeypatch):
    args = parse_args(["--arch", "mamba2-130m", "--batch", "3",
                       "--prompt-len", "16", "--gen-len", "9", "--reduced",
                       "--shards", "2", "--trace", "t.json"])
    assert (args.arch, args.batch, args.prompt_len, args.gen_len,
            args.reduced, args.shards, args.trace) == (
        "mamba2-130m", 3, 16, 9, True, 2, "t.json")
    assert (args.transport, args.tune) == (False, False)
    args = parse_args(["--arch", "mamba2-130m", "--transport", "--tune"])
    assert (args.transport, args.tune) == (True, True)
    seen = {}
    monkeypatch.setattr(serve_mod, "serve",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    serve_mod.main(["--arch", "mamba2-130m", "--reduced", "--gen-len", "9"])
    assert seen["cfg"] == get_config("mamba2-130m").reduced()
    assert (seen["batch"], seen["prompt_len"], seen["gen_len"],
            seen["shards"], seen["trace_path"], seen["transport"],
            seen["tune"]) == (4, 32, 9, 1, None, False, False)
    serve_mod.main(["--arch", "mamba2-130m", "--reduced", "--shards", "2",
                    "--transport", "--tune"])
    assert (seen["shards"], seen["transport"], seen["tune"]) == (2, True,
                                                                 True)


def test_traced_serve_writes_a_valid_chrome_trace(tmp_path):
    """The Chrome trace and the ledger hold the dashboard's spans and the
    model's own, each decode step's inside its record; the model's rows
    carry no bytes and get no floor."""
    import json
    from repro_torch.obs import validate_chrome
    path = tmp_path / "serve.json"
    cfg = get_config("mamba2-130m").reduced()
    res = serve(cfg, batch=1, prompt_len=8, gen_len=21, device="cpu",
                verbose=False, trace_path=str(path))
    trace = json.loads(path.read_text())
    assert validate_chrome(trace) == []
    stages = {s.stage: s for s in res.ledger.stages}
    assert "record.decode" in stages and "serve.vet" in stages
    assert stages["model.prefill"].calls == 1
    assert stages["model.decode_step"].calls == 20
    assert stages["model.ssm"].calls == 21 * cfg.num_layers
    assert stages["model.head"].calls == 21
    for name in ("model.prefill", "model.decode_step", "model.layer",
                 "model.ssm", "model.head"):
        assert stages[name].floor_s is None and stages[name].bytes == 0
    names = [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert names.count("model.decode_step") == 20


def test_tokens_per_s_counts_the_dashboard(monkeypatch):
    """The throughput wall runs from the prompt batch to the last token
    with the dashboard's ticks inside it; ``vet_s`` is their sum.  A
    dashboard slowed to 50 ms a tick makes both show it."""
    import time
    from repro_torch.fleet import ShardedVetMux

    tick = ShardedVetMux.tick

    def slow_tick(self, *a, **kw):
        time.sleep(0.05)
        return tick(self, *a, **kw)

    monkeypatch.setattr(ShardedVetMux, "tick", slow_tick)
    res = serve(get_config("mamba2-130m").reduced(), batch=1, prompt_len=8,
                gen_len=21, device="cpu", verbose=False)
    wall = 1 * 21 / res.tokens_per_s
    assert res.vet_s >= 4 * 0.05  # four units of five decode records
    assert wall >= res.prefill_s + res.vet_s


def test_vet_s_is_the_sum_of_the_dashboards_spans():
    from repro_torch.obs import Tracer
    tr = Tracer()
    res = serve(get_config("mamba2-130m").reduced(), batch=1, prompt_len=8,
                gen_len=21, device="cpu", verbose=False, tracer=tr)
    in_loop = [r.dur for r in tr.records
               if r.name == "serve.vet" and "post" not in dict(r.attrs)]
    assert len(in_loop) == 4 and res.vet_s == sum(in_loop)


@pytest.fixture(scope="module")
def transport_result():
    """``--transport --tune`` on two shard workers, the device from
    ``REPRO_TORCH_DEVICE=cpu`` (inherited by the spawned workers)."""
    from repro_torch.kernels import runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(runtime.ENV_VAR, "cpu")
        cfg = get_config("mamba2-130m").reduced()
        return serve(cfg, batch=2, prompt_len=32, gen_len=GEN, shards=2,
                     transport=True, tune=True, verbose=False)


def test_transport_tune_gives_the_tokens_of_plain_serve(result,
                                                        transport_result):
    _, res = result
    np.testing.assert_array_equal(transport_result.tokens, res.tokens)


def test_transport_windows_equal_the_in_process_fleet(result,
                                                      transport_result):
    """The same unit times vetted in a worker give the in-process fleet's
    window count and the port's own estimator's windows."""
    _, res = result
    got = transport_result
    assert got.windows.workers == res.windows.workers == 2
    assert got.mux.respawns == got.mux.retries == 0
    assert got.mux.ticks == (GEN - 1) // 5 + 1 and got.mux.streams == 1
    win = VetEngine("cuda", buckets=64, device="cpu").vet_sliding(
        got.unit_times, window=32, stride=32)
    np.testing.assert_array_equal(got.windows.t, win.t)
    np.testing.assert_allclose(got.windows.vet, win.vet, rtol=1e-12, atol=0)


def test_tune_fills_the_tuner_report(transport_result):
    rep = transport_result.tuner
    assert rep["best"]["tick_budget"] in (8, 16, 32, 64)
    assert rep["current"]["tick_budget"] in (8, 16, 32, 64)
    assert rep["rounds"] >= 1 and rep["samples"] == (GEN - 1) // 5
