"""Readings that set the correctness limits of a cell (not run by the
benchmark's runs).

For each seed it draws the cell's weights and serves the cell's first
``--requests`` requests at the cell's load (the dashboard in the loop when
the mix has one), keeps the sampled ones as a run does, and prints, one
JSON line each:

- ``program``: the numbers ``check`` compares, for the program;
- ``control``: the same numbers for the control, the reference put in the
  program's place one precision below the configuration's (products in
  TF32 for f32 with TF32 off; the vet in bfloat16 for the dashboard's f32).
  The model control runs its own routing over the same prompts and served
  tokens and is judged as the program is; its ``token_gap`` is read at
  every position of the prompts and tokens, the gap of the token it puts
  first;
- ``fault``: the program's numbers with a fault planted in it
  (``FAULTS``): a token altered where it is produced, a decode step that
  leaves its cache unchanged, half of the batch left out (its rows given
  the other half's), a vetted window's answer altered, the dashboard's
  vetted windows lost (its stream shows none).

Usage, from the root of a checkout::

    python3 portbench/control.py --workload CELL --seeds 1,2,... \\
        [--control-seeds ...] [--fault-seeds ...] [--requests N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("token_altered", "state_unchanged", "half_batch", "vet_altered",
          "vet_skipped")


@contextlib.contextmanager
def fault(name: str):
    """Plant fault ``name`` in the program for the block's duration."""
    import dataclasses

    from repro_torch.engine import stream as S
    from repro_torch.models import blocks as B, model as M

    patched = []

    def patch(mod, attr, fn):
        patched.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if name == "token_altered":
        prefill = M.prefill

        def altered(*a, **k):
            logits, cache = prefill(*a, **k)
            logits = logits.clone()
            top = logits.argmax(dim=-1)
            other = (top + 1 + top * 7919 % 1000) % logits.shape[-1]
            rows = logits.new_tensor(range(logits.shape[0])).long()
            hi, lo = logits[rows, top].clone(), logits[rows, other].clone()
            logits[rows, top], logits[rows, other] = lo, hi
            return logits, cache
        patch(M, "prefill", altered)
    elif name == "state_unchanged":
        write = B._write_seq

        def unchanged(dst, src, at):
            if at > 0:  # a decode step's write
                return
            write(dst, src, at)
        patch(B, "_write_seq", unchanged)
    elif name == "half_batch":
        prefill = M.prefill

        def half(cfg, params, cache, batch, *a, **k):
            t = batch["tokens"]
            keep = max(1, t.shape[0] // 2)
            logits, cache = prefill(cfg, params, cache,
                                    {"tokens": t[:keep]}, *a, **k)
            idx = [i % keep for i in range(t.shape[0])]
            return logits[idx], cache
        patch(M, "prefill", half)
    elif name == "vet_altered":
        collect = S.VetStream.collect

        def altered_rows(self):
            rows = collect(self)
            if rows is None:
                return None
            vet = rows.vet.copy()
            vet[0] *= 1.01
            return dataclasses.replace(rows, vet=vet) \
                if dataclasses.is_dataclass(rows) else rows._replace(vet=vet)
        patch(S.VetStream, "collect", altered_rows)
    elif name == "vet_skipped":
        patch(S.VetStream, "collect", lambda self: None)
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(patched):
            setattr(mod, attr, fn)


def serve_requests(spec, seed: int, device, requests: int):
    """(weights, kept samples, dashboard windows, fed units) of the cell's
    first ``requests`` requests under ``seed``."""
    import torch

    from portbench import harness, weights as W
    from portbench.traffic import Traffic

    c, mix, cell = spec.config, spec.mix, spec.cell
    cfg = harness.port_config(c)
    traffic = Traffic(mix, c["vocab_size"], seed)
    params = W.make(c, seed, device)
    server = harness.Server(cfg, params, mix, device)
    spans = harness.Spans()
    for req in traffic.warmup():
        server.serve(req, spans, dashboard=False)
    sample = set(traffic.sample(cell["check"]["sample"],
                                cell["check"]["sample_from"]))
    served = [server.serve(traffic.request(i), spans, keep=i in sample)
              for i in range(requests)]
    windows = units = None
    if server.dashboard is not None:
        windows = server.dashboard.windows()
        units = list(server.dashboard.units)
        server.dashboard.close()
    del server
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return params, [x for x in served if x.logits is not None], windows, units


def model_control(c: dict, weights, samples, chunk: int = 512) -> dict:
    """The TF32 control's numbers over the program's sampled requests."""
    import torch

    from portbench import families
    from portbench.reference import model as R

    arch = R.Arch.from_file(c)
    inputs = families.of(c).reference_inputs  # the DeepSeek MoE family's
    device = weights["embed"].device
    out = {"route_gap": 0.0, "logit_err": 0.0, "token_gap": 0.0}
    for got in samples:
        ids, groups, _, positions = inputs(arch, got, device)
        with torch.no_grad():
            low, own, _ = R.forward(arch, weights, ids, groups,
                                    precision="tf32")
            ref, _, judged = R.forward(arch, weights, ids, groups, route=own)
            out["route_gap"] = max(out["route_gap"], judged["gap"])
            for lo in range(0, ids.shape[1], chunk):
                pos = list(range(lo, min(lo + chunk, ids.shape[1])))
                a = R.logits_at(arch, weights, low[:, pos], "tf32")
                b = R.logits_at(arch, weights, ref[:, pos])
                a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
                nums = R.judge_logits(a, b, a.argmax(dim=-1))
                out["token_gap"] = max(out["token_gap"], nums["token_gap"])
            a = R.logits_at(arch, weights, low[:, positions], "tf32")
            b = R.logits_at(arch, weights, ref[:, positions])
            nums = R.judge_logits(a.reshape(-1, a.shape[-1]),
                                  b.reshape(-1, b.shape[-1]))
            out["logit_err"] = max(out["logit_err"], nums["logit_err"])
        del low, ref
    return out


def vet_control(windows, units, dash: dict) -> dict:
    """The bfloat16 vet's ``vet_err`` over the windows the program vetted,
    judged as the program's are."""
    import numpy as np
    import torch

    from portbench.check import vet_err
    from portbench.reference.vet import vet_window

    if windows is None:
        return {}
    first, rows = windows
    w, stride = dash["window"], dash["stride"]
    err = 0.0
    for j in range(len(rows.vet)):
        k = first + j
        times = np.asarray(units[k * stride:k * stride + w])
        low = vet_window(times, buckets=dash["buckets"], dtype=torch.bfloat16)
        err = max(err, vet_err(times, low["t"], low["vet"], dash["buckets"]))
    return {"vet_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--fault-requests", type=int, default=8,
                    help="requests a seed of a fault other than vet_altered "
                         "serves")
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import check, harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    spec = harness.load_spec(args.workload, ROOT)
    dash = spec.mix.get("dashboard")

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"kind": kind, "workload": args.workload,
                          "seed": seed, **extra, **numbers}), flush=True)

    controls = set(ints(args.control_seeds))
    for seed in ints(args.seeds):
        t0 = time.perf_counter()
        params, samples, windows, units = serve_requests(
            spec, seed, device, args.requests)
        numbers = check.judge(spec.config, params, samples)
        if dash:
            numbers.update(check.judge_dashboard(windows, units, dash))
        emit("program", seed, numbers, seconds=time.perf_counter() - t0,
             vet_windows=0 if windows is None else len(windows[1].vet))
        if seed in controls:
            t0 = time.perf_counter()
            numbers = model_control(spec.config, params, samples)
            if dash:
                numbers.update(vet_control(windows, units, dash))
            emit("control", seed, numbers, seconds=time.perf_counter() - t0)
        del params, samples
        torch.cuda.empty_cache()
    for name in args.faults.split(","):
        if not name:
            continue
        for seed in ints(args.fault_seeds):
            n = args.requests if name.startswith("vet_") else \
                args.fault_requests
            with fault(name):
                params, samples, windows, units = serve_requests(
                    spec, seed, device, n)
            numbers = check.judge(spec.config, params, samples)
            if dash:
                numbers.update(check.judge_dashboard(windows, units, dash))
            emit("fault", seed, numbers, fault=name)
            del params, samples
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
