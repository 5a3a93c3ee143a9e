"""The port's serve entry point (``repro_torch.launch.serve``) on the CPU,
reduced mamba2-130m, with enough decode steps for two 32-unit dashboard
windows (331 tokens at ``record_unit=5``: 330 records, 66 units).

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


def test_main_parses_the_reference_flags(monkeypatch):
    args = parse_args(["--arch", "mamba2-130m", "--batch", "3",
                       "--prompt-len", "16", "--gen-len", "9", "--reduced",
                       "--shards", "2", "--trace", "t.json"])
    assert (args.arch, args.batch, args.prompt_len, args.gen_len,
            args.reduced, args.shards, args.trace) == (
        "mamba2-130m", 3, 16, 9, True, 2, "t.json")
    for flag in ("--transport", "--tune"):
        with pytest.raises(SystemExit):
            parse_args(["--arch", "mamba2-130m", flag])
    seen = {}
    monkeypatch.setattr(serve_mod, "serve",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    serve_mod.main(["--arch", "mamba2-130m", "--reduced", "--gen-len", "9"])
    assert seen["cfg"] == get_config("mamba2-130m").reduced()
    assert (seen["batch"], seen["prompt_len"], seen["gen_len"],
            seen["shards"], seen["trace_path"]) == (4, 32, 9, 1, None)


def test_traced_serve_writes_a_valid_chrome_trace(tmp_path):
    import json
    from repro_torch.obs import validate_chrome
    path = tmp_path / "serve.json"
    res = serve(get_config("mamba2-130m").reduced(), batch=1, prompt_len=8,
                gen_len=21, device="cpu", verbose=False,
                trace_path=str(path))
    assert validate_chrome(json.loads(path.read_text())) == []
    stages = {s.stage for s in res.ledger.stages}
    assert "record.decode" in stages and "serve.vet" in stages
