"""Batched decode serving loop with per-request-step vet profiling (the
port of ``repro.launch.serve``).

prefill(prompt batch) -> decode loop; every decode step is a profiled record
(the paper's reduce-write analogue), so a serving deployment gets the same
optimality dashboard as training: vet per serving worker, EI as the
estimated ideal per-token latency, and per-window snapshots showing vet
drift over the generation.  The window snapshots come from a ``VetStream``
registered in a ``ShardedVetMux`` and ticked inside the decode loop, and the
mux's live anomaly monitor prints a regime shift the tick it is flagged.

Where the reference blocks on the token (``block_until_ready``), the port
synchronises the token's device, so each record is the device's step time
and not the launch time.  The vet engine is ``default_engine("cuda",
buckets=64)`` on the serving device.  Weights and prompts come from a
``torch.Generator`` seeded by ``seed`` on the CPU, so a seed gives the same
model on every device.

Not in this slice: ``--transport`` (``fleet.transport``, ROADMAP A.8) and
``--tune`` (``fleet.knobs`` and ``sched.tuner``, ROADMAP A.6/A.9).

Usage: ``python -m repro_torch.launch.serve --arch mamba2-130m`` (on the
card; ``REPRO_TORCH_DEVICE=cpu`` and ``--reduced`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..engine import BatchVetResult, VetEngine, default_engine
from ..fleet import MuxStats, ShardedVetMux
from ..kernels.runtime import require_device, resolve_device
from ..models import decode_step, init_cache, init_params, prefill
from ..obs import LedgerReport, Tracer, format_ledger, ledger_from, write_chrome
from ..obs.trace import timed as _timed
from ..profiling import RecordProfiler

__all__ = ["ServeResult", "main", "serve"]

_SNAPSHOT_WINDOW = 32  # unit-records per windowed vet snapshot
_SNAPSHOT_HISTORY = 64  # newest window snapshots retained for the drift view


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, generated) int32
    vet: Optional[float]
    ei: Optional[float]
    pr: Optional[float]
    tokens_per_s: float
    # Windowed per-worker snapshots (newest <= _SNAPSHOT_HISTORY windows)
    # from the stream ticked during decode (None when the run produced
    # fewer than two full windows).
    windows: Optional[BatchVetResult] = None
    # Regime-shift flags raised by the mux's live anomaly monitor while the
    # decode loop ran (``repro_torch.fleet.RegimeShift``).
    flags: tuple = ()
    # Optimality ledger over the run's trace (None unless traced).
    ledger: Optional[LedgerReport] = None
    # Seconds from the prompt batch to the first token, synchronised.
    prefill_s: float = 0.0
    # The mux's lifetime counters at the end of the run.
    mux: Optional[MuxStats] = None
    # Per-unit decode times the dashboard vetted (seconds).
    unit_times: Optional[np.ndarray] = None


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def serve_inputs(cfg, *, batch: int, prompt_len: int, seed: int, dtype,
                 device):
    """``(params, prompts)`` as ``serve`` makes them: random weights, then
    prompt tokens, from one CPU generator seeded by ``seed``, moved to
    ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    params = init_params(cfg, gen, dtype=dtype)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen)
    params = _to(params, device)
    return params, prompts.to(device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve(
    cfg_or_name,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen_len: int = 64,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
    record_unit: int = 5,
    verbose: bool = True,
    engine: Optional[VetEngine] = None,
    shards: int = 1,
    tracer: Optional[Tracer] = None,
    trace_path: Optional[str] = None,
) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and generate
    ``gen_len`` tokens each, greedily, with the live vet dashboard.

    Raises:
        ValueError: an encoder-only config, or ``prompt_len`` not a multiple
            of ``cfg.ssm_chunk`` (the SSD scan's chunking, as in the
            reference).
        NotImplementedError: a model family the port does not run yet.
        RuntimeError: the resolved device is CUDA and no card is present.
    """
    cfg = get_config(cfg_or_name) if isinstance(cfg_or_name, str) else cfg_or_name
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    if tracer is None and trace_path is not None:
        tracer = Tracer()
    device = require_device(resolve_device(device))

    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=seed, dtype=dtype, device=device)
    cache = init_cache(cfg, batch, prompt_len + gen_len, dtype=dtype,
                       device=device)

    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, cache, {"tokens": prompts})
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(tok)
    prefill_s = time.perf_counter() - t0

    prof = RecordProfiler(unit=record_unit, name="decode", tracer=tracer)
    # Live window snapshots: this worker's stream registered in a sharded
    # fleet mux (``shards=1`` is one local decode worker) and ticked as
    # unit-records complete, so each tick vets only the newly finished
    # windows through the fleet's coalesced dispatch path.
    mux = ShardedVetMux(shards,
                        engine=(engine if engine is not None
                                else default_engine("cuda", buckets=64,
                                                    device=device)),
                        tracer=tracer)
    stream = mux.register("decode", window=_SNAPSHOT_WINDOW,
                          stride=_SNAPSHOT_WINDOW,
                          capacity=4 * _SNAPSHOT_WINDOW,
                          history=_SNAPSHOT_HISTORY)
    fed_units = 0
    flags = []  # regime-shift flags raised live during decode
    vet_s = 0.0  # estimation overhead, excluded from the throughput wall

    def _tick():
        for f in mux.tick().flags:
            flags.append(f)
            if verbose:
                print(f"[serve] REGIME SHIFT {f.stream_id}: window "
                      f"{f.onset} vet {f.pre:.2f} -> {f.post:.2f} "
                      f"(confidence {f.confidence:.2f})")

    out = [tok]
    for i in range(gen_len - 1):
        with prof.record():
            logits, cache = decode_step(cfg, params, cache, tok,
                                        prompt_len + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
            _sync(tok)
        out.append(tok)
        if prof.num_records % record_unit == 0:
            sw = _timed(tracer, "serve.vet", step=i)
            with sw:
                new_units = prof.unit_times(start=fed_units)
                mux.feed("decode", new_units)
                fed_units += new_units.size
                _tick()
            vet_s += sw.dur
    wall = time.perf_counter() - t0 - vet_s
    gen = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    vet = ei = pr = None
    windows = None
    times = prof.unit_times()
    if times.size >= 16:
        if engine is None:
            # the bucket count adapts to the profile size so short runs
            # keep the bucketed estimator
            engine = default_engine("cuda", buckets=min(64, times.size // 4),
                                    device=device)
        r = engine.vet_one(times)
        vet, ei, pr = float(r.vet), float(r.ei), float(r.pr)
        if verbose:
            print(f"[serve] vet={vet:.3f} EI={ei:.4f}s PR={pr:.4f}s")
        with _timed(tracer, "serve.vet", post=True):
            mux.feed("decode", times[fed_units:])  # trailing units
            _tick()
        win = mux.stream("decode").collect()
        if win is not None and win.workers >= 2:
            windows = win
            if verbose:
                ws = " ".join(f"{v:.2f}" for v in windows.vet)
                ms = mux.stats
                print(f"[serve] window vets: {ws} "
                      f"({stream.stats.vetted} vetted / "
                      f"{stream.stats.reused} reused rows over {ms.ticks} "
                      f"mux ticks / {ms.dispatches} dispatches / "
                      f"{ms.anomalies} anomalies)")
    tps = batch * gen_len / wall
    if verbose:
        print(f"[serve] {batch}x{gen_len} tokens in {wall:.2f}s = {tps:.1f} "
              f"tok/s (prefill {prefill_s * 1e3:.1f} ms on {device})")
    ledger = None
    if tracer is not None:
        ledger = ledger_from(tracer.records)
        if verbose:
            print(format_ledger(ledger, title="serve optimality ledger"))
        if trace_path is not None:
            write_chrome(trace_path, tracer)
            if verbose:
                print(f"[serve] chrome trace -> {trace_path} "
                      f"(load in Perfetto / chrome://tracing)")
    return ServeResult(tokens=gen, vet=vet, ei=ei, pr=pr, tokens_per_s=tps,
                       windows=windows, flags=tuple(flags), ledger=ledger,
                       prefill_s=prefill_s, mux=mux.stats, unit_times=times)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's command line; ``--transport`` and ``--tune`` are
    refused with the ROADMAP item that brings them."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the vet fleet across N shard muxes")
    ap.add_argument("--transport", action="store_true",
                    help="not ported yet (ROADMAP A.8)")
    ap.add_argument("--tune", action="store_true",
                    help="not ported yet (ROADMAP A.6, A.9)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="trace the run and write a Chrome trace-event JSON "
                         "here (Perfetto-loadable); also prints the "
                         "optimality ledger")
    args = ap.parse_args(argv)
    if args.transport:
        ap.error("--transport needs fleet.transport, not ported yet "
                 "(ROADMAP A.8)")
    if args.tune:
        ap.error("--tune needs fleet.knobs and sched.tuner, not ported yet "
                 "(ROADMAP A.6, A.9)")
    return args


def main(argv=None) -> ServeResult:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen_len=args.gen_len, shards=args.shards,
                 trace_path=args.trace)


if __name__ == "__main__":
    main()
