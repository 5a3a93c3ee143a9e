"""One run of one cell: set-up, the measured window, the traced window,
the correctness check and the result line.

``BENCHMARK.json``'s entry of a cell names its configuration, its traffic
mix and its chips; the cell's own file (``workloads/<cell>.json``) holds
what its runs trace and check.  The timed path is the
port's serving path as ``repro_torch.launch.serve`` drives it: one decode
cache (``models.model.init_cache``), each request's ``prefill`` and then
``decode_step`` a token at a time, greedy, each token copied to the host;
with a dashboard, every ``record_unit`` decode records fed as one unit to
a ``fleet.ShardedVetMux`` over ``engine.default_engine("cuda", ...)`` and
the mux ticked, inside the loop.  The benchmark times each decode record
itself and feeds those times, so the reference can vet the same numbers.

One client in a closed loop: the next request is issued when the last
one's tokens are back.  The window opens after set-up and issues requests
until ``seconds`` have passed; the request in flight then completes, and
the window closes with it, so every issued request completes and every
rate covers whole requests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, families, tracing, weights as W
from .traffic import Request, Traffic

__all__ = ["Spec", "load_spec", "port_config", "run"]

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names


@dataclasses.dataclass
class Spec:
    """Everything one cell's run reads: its entry in ``BENCHMARK.json``
    with its own file's keys (``trace_requests``, ``check``), its
    configuration file, its traffic mix and the metrics ``BENCHMARK.json``
    lists for it."""

    cell: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(name: str, root: Path) -> Spec:
    """The spec of cell ``name``, found by name from ``root/BENCHMARK.json``
    (the cell's and its mix's files under ``root/portbench``).

    Raises:
        KeyError: no such cell or configuration in ``BENCHMARK.json``.
        FileNotFoundError: a file it names is missing, or the family file
            its configuration names.
        AttributeError, ValueError: the family file lacks a name or a
            required number (``families.of``).
    """
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    own = root / HERE.name
    cell = dict(entry, **json.loads((own / "workloads" / f"{name}.json")
                                    .read_text()))
    mix = json.loads((own / "mixes" / f"{entry['traffic']}.json")
                     .read_text())
    config = json.loads((root / conf["file"]).read_text())
    families.of(config)  # the family file, whole, before any set-up
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    moves = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    return Spec(cell, config, mix, end_to_end, per_layer)


def port_config(c: dict):
    """The port's ``ArchConfig`` for configuration file ``c``, as its
    family makes it (``families``)."""
    return families.of(c).port_config(c)


class Spans:
    """The benchmark's own spans around its calls into the program: (name,
    start, end, attributes) on the host's clock, and, when ``annotate``,
    each also a ``torch.profiler`` range named ``portbench.<name>``."""

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.spans: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        mark = (torch.profiler.record_function(f"portbench.{name}")
                if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
        self.spans.append((name, t0, time.perf_counter(), attrs))


class Dashboard:
    """The live vet dashboard as ``launch.serve`` runs it: one stream in a
    ``ShardedVetMux``, fed one unit (the sum of ``record_unit`` decode
    records) at a time and ticked after each feed."""

    def __init__(self, dash: dict, device):
        from repro_torch.engine import default_engine
        from repro_torch.fleet import ShardedVetMux

        self.dash = dash
        self.engine = default_engine("cuda", buckets=dash["buckets"],
                                     device=device)
        self.mux = ShardedVetMux(dash["shards"], engine=self.engine)
        self.stream = self.mux.register(
            "decode", window=dash["window"], stride=dash["stride"],
            capacity=4 * dash["window"], history=dash["history"])
        self.pending: List[float] = []
        self.units: List[float] = []

    def warm(self, seed: int) -> None:
        """Vet one window of made-up units through a mux of its own on the
        same engine, so the first real vet finds the engine ready."""
        from repro_torch.fleet import ShardedVetMux

        mux = ShardedVetMux(self.dash["shards"], engine=self.engine)
        try:
            mux.register("warm", window=self.dash["window"],
                         stride=self.dash["stride"],
                         capacity=4 * self.dash["window"])
            rng = np.random.default_rng([seed % 2 ** 64, 7])
            mux.feed("warm", rng.lognormal(-2.0, 0.3, self.dash["window"]))
            mux.tick()
        finally:
            mux.close()

    def record(self, seconds: float, spans: Spans) -> None:
        self.pending.append(seconds)
        if len(self.pending) < self.dash["record_unit"]:
            return
        unit = float(sum(self.pending))
        self.pending.clear()
        with spans.span("dashboard"):
            self.mux.feed("decode", np.array([unit]))
            self.mux.tick()
        self.units.append(unit)

    def windows(self):
        """(first retained window, the stream's retained rows) or None."""
        rows = self.stream.collect()
        return None if rows is None else (self.stream.first_retained, rows)

    def close(self) -> None:
        self.mux.close()


@dataclasses.dataclass
class Served:
    """What one request gave back: its time to first token, its tokens
    (B, gen) and, for a sampled request, its logits (gen, B, V) and the
    routing of each MoE call (each token's experts, each expert's
    tokens)."""

    request: Request
    ttft_s: float
    tokens: np.ndarray
    logits: Optional[torch.Tensor] = None
    routing: Optional[list] = None


class Server:
    """The timed path: the port's prefill and decode steps on one cache,
    with the dashboard in the loop when the mix has one."""

    def __init__(self, cfg, params, mix: dict, device):
        from repro_torch.models import layers, model

        self.M, self.L = model, layers
        self.cfg, self.params, self.device = cfg, params, device
        self.batch = int(mix["batch"])
        s_max = max(mix["prompt_lengths"]) + int(mix["gen_tokens"])
        self.cache = model.init_cache(cfg, self.batch, s_max, device=device)
        self.dashboard = (Dashboard(mix["dashboard"], device)
                          if mix.get("dashboard") else None)
        self.routed = self.dropped = 0

    def serve(self, req: Request, spans: Spans, *, keep: bool = False,
              count: bool = False, dashboard: bool = True) -> Served:
        """Serve one request; ``keep`` holds its logits and routing for the
        check, ``count`` adds its routed and dropped slots to the
        counters."""
        M, cfg, params, cache = self.M, self.cfg, self.params, self.cache
        log = self.L.RoutingLog() if keep or count else None
        kept, out = [], []
        b, s = self.batch, req.prompt_len
        with (self.L.recording(log) if log is not None
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            with spans.span("request", batch=b, prompt=s):
                with spans.span("prefill", batch=b, prompt=s):
                    ids = torch.from_numpy(req.tokens).to(self.device)
                    logits, _ = M.prefill(cfg, params, cache, {"tokens": ids})
                    tok = torch.argmax(logits, dim=-1)[:, None]
                    out.append(tok.cpu())
                ttft = time.perf_counter() - t0
                if keep:
                    kept.append(logits)
                for i in range(req.gen_tokens - 1):
                    with spans.span("decode", batch=b, pos=s + i):
                        t = time.perf_counter()
                        logits, _ = M.decode_step(cfg, params, cache, tok,
                                                  s + i)
                        tok = torch.argmax(logits, dim=-1)[:, None]
                        out.append(tok.cpu())
                        dt = time.perf_counter() - t
                    if keep:
                        kept.append(logits)
                    if dashboard and self.dashboard is not None:
                        self.dashboard.record(dt, spans)
        got = Served(req, ttft, torch.cat(out, dim=1).numpy())
        if keep:
            got.logits = torch.stack(kept).cpu()
            got.routing = [(c.top_idx.cpu(), c.expert_idx.cpu())
                           for c in log.calls]
        if count and log.calls:
            self.routed += sum(c.slot.numel() for c in log.calls)
            self.dropped += int(torch.stack([(c.slot < 0).sum()
                                             for c in log.calls]).sum())
        return got


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def run(spec: Spec, *, seed: int, seconds: float, trace: bool, device,
        started: float) -> Dict:
    """One run; returns the result line's object (``correct``, ...,
    ``checks`` last).  ``started`` is the host clock at the process's start,
    so ``setup_s`` counts the imports too."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    c, mix, cell = spec.config, spec.mix, spec.cell
    cfg = port_config(c)
    traffic = Traffic(mix, c["vocab_size"], seed)
    params = W.make(c, seed, device)
    server = Server(cfg, params, mix, device)
    quiet_spans = Spans()
    for req in traffic.warmup():
        server.serve(req, quiet_spans, dashboard=False)
    if server.dashboard is not None:
        server.dashboard.warm(seed)
    sample = set(traffic.sample(cell["check"]["sample"],
                                cell["check"]["sample_from"]))
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started

    spans = Spans()
    served: List[Served] = []
    t_open = time.perf_counter()
    i = 0
    while time.perf_counter() - t_open < seconds:
        served.append(server.serve(traffic.request(i), spans,
                                   keep=i in sample))
        i += 1
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    traced = None
    if trace:
        tspans = Spans(annotate=True)
        traced = tracing.traced_window(
            lambda: [server.serve(traffic.request(i + k), tspans, count=True)
                     for k in range(cell["trace_requests"])],
            tspans, cuda)

    metrics = {}
    if trace:
        records = {"config": c, "spans": spans.spans, "trace": traced,
                   "counters": {"moe_routed": server.routed,
                                "moe_dropped": server.dropped}}
        for m in spec.per_layer:
            value = _reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ttfts = [x.ttft_s for x in served]
        tokens = sum(x.tokens.size for x in served)
        values = {"ttft_ms_p90": float(np.percentile(ttfts, 90)) * 1e3,
                  "output_tokens_per_s": tokens / window_s,
                  "peak_gb": peak / 1e9, "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    windows = (server.dashboard.windows()
               if server.dashboard is not None else None)
    units = (list(server.dashboard.units)
             if server.dashboard is not None else [])
    if server.dashboard is not None:
        server.dashboard.close()
    del server
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.judge(c, params, [x for x in served if x.logits is not None])
    if mix.get("dashboard"):
        numbers.update(check.judge_dashboard(windows, units, mix["dashboard"]))
    checks = check.against(numbers, cell["check"]["limits"])
    required = tuple(families.of(c).NUMBERS) + (
        check.DASHBOARD_NUMBERS if mix.get("dashboard") else ())
    correct = (all(k in checks for k in required)
               and all(v["value"] <= v["limit"] for v in checks.values()))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power_limit"] = tracing.power_limit()
    result = {"correct": bool(correct), "attempted": len(served),
              "failed": 0, "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    phase_ms = {}
    for name in ("prefill", "decode", "dashboard"):
        d = sorted(t1 - t0 for n, t0, t1, _ in spans.spans if n == name)
        if d:
            phase_ms[name] = {"calls": len(d), "mean": 1e3 * sum(d) / len(d),
                              "p50": 1e3 * d[len(d) // 2],
                              "max": 1e3 * d[-1]}
    result["window"] = {"seconds": window_s, "requests": len(served),
                        "phase_ms": phase_ms,
                        "sampled": sum(x.logits is not None for x in served),
                        "vet_windows": (0 if windows is None
                                        else len(windows[1].vet))}
    result["checks"] = checks
    return result
