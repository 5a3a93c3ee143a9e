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
model on every device; ``init_device`` draws them on another device
instead (a full-width model's weights drawn on the card, which gives other
numbers than the CPU draw of the same seed).  The decode cache is written
in place (``models.model``).

``transport=True`` (``--transport``) moves each shard mux into its own
spawned worker process (``fleet.transport.TransportVetMux``: retries,
checkpoint/resume), so the dashboard's kernels launch in the workers and
the retained windows come back through ``collect``.  ``tune=True``
(``--tune``) closes the loop: a ``sched.tuner.VetTuner`` drives the mux's
``tick_budget`` knob (``fleet.knobs.mux_knob_hooks``) with each estimation
tick's measured duration as the objective, strictly between ticks, and
its report lands on ``ServeResult.tuner``.

A tracer (``tracer=``, or ``--trace PATH``) records the dashboard's spans
and, through ``obs.trace.tracing``, the model's own (``model.prefill``,
``model.decode_step`` and the layers' spans inside them), into the Chrome
trace and the ledger.  On the card a decode step from the third on is a
replay of the step's CUDA graph (``models.graph``), so the ledger shows
one ``model.decode_step`` span for such a step, with no layer span inside
it.  ``tokens_per_s`` counts the whole wall from the
prompt batch to the last token, the dashboard's ticks inside it;
``vet_s`` says how much of it the dashboard took.

Usage: ``python -m repro_torch.launch.serve --arch mamba2-130m``, or any
decoder config: ``--arch h2o-danube-3-4b``, ``--arch deepseek-moe-16b``,
``--arch zamba2-7b`` (the hybrid), ``--arch deepseek-v2-lite-16b`` (MLA)
(on the card; ``REPRO_TORCH_DEVICE=cpu`` and ``--reduced`` to run on the
CPU), with ``--shards N``, ``--transport`` and ``--tune`` as options.
``kv_cache_dtype="int8"`` on the config serves an attention model from the
int8 KV cache.
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
from ..fleet import MuxStats, ShardedVetMux, TransportVetMux
from ..fleet.knobs import mux_knob_hooks
from ..kernels.runtime import require_device, resolve_device
from ..models import decode_step, init_cache, init_params, prefill
from ..obs import LedgerReport, Tracer, format_ledger, ledger_from, write_chrome
from ..obs.trace import timed as _timed, tracing
from ..profiling import RecordProfiler
from ..sched.tuner import VetTuner

__all__ = ["ServeResult", "main", "serve", "serve_inputs"]

_SNAPSHOT_WINDOW = 32  # unit-records per windowed vet snapshot
_SNAPSHOT_HISTORY = 64  # newest window snapshots retained for the drift view


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, generated) int32
    vet: Optional[float]
    ei: Optional[float]
    pr: Optional[float]
    # batch * gen_len over the wall from the prompt batch to the last
    # token: prefill, decode and the dashboard's ticks inside the loop.
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
    # Seconds to draw the weights and prompts and place them, synchronised.
    init_s: float = 0.0
    # The online tuner's report (``VetTuner.report()``; None unless tuned).
    tuner: Optional[dict] = None
    # Seconds of the dashboard's feeds and ticks inside the decode loop
    # (its ``serve.vet`` spans), part of ``tokens_per_s``'s wall.
    vet_s: float = 0.0


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def serve_inputs(cfg, *, batch: int, prompt_len: int, seed: int, dtype,
                 device, init_device=None):
    """``(params, prompts)`` as ``serve`` makes them: random weights, then
    prompt tokens, from one generator seeded by ``seed`` on ``init_device``
    (the CPU when ``None``), moved to ``device``."""
    gen_device = torch.device("cpu" if init_device is None else init_device)
    gen = torch.Generator(device=gen_device).manual_seed(int(seed))
    params = init_params(cfg, gen, dtype=dtype)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=gen_device)
    params = _to(params, device)
    return params, prompts.to(device)


def _check_prompt_len(cfg, prompt_len: int, q_chunk: int = 1024) -> None:
    """The reference's prompt-length rules, before any weight is drawn.

    Raises:
        ValueError: a prompt of an SSM or hybrid model that is not a
            multiple of ``cfg.ssm_chunk`` (the SSD scan's chunking), or an
            attention prompt longer than ``q_chunk`` that is not a
            multiple of it (the query-chunked attention's blocks).  A
            hybrid prompt meets both rules.
    """
    if cfg.is_ssm_layer_model and prompt_len % cfg.ssm_chunk:
        raise ValueError(f"sequence length {prompt_len} is not a multiple "
                         f"of the SSD chunk {cfg.ssm_chunk}")
    if cfg.num_heads and prompt_len > q_chunk and prompt_len % q_chunk:
        raise ValueError(f"sequence length {prompt_len} is not a multiple "
                         f"of the attention query chunk {q_chunk}")


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
    transport: bool = False,
    tune: bool = False,
    tracer: Optional[Tracer] = None,
    trace_path: Optional[str] = None,
    init_device=None,
) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and generate
    ``gen_len`` tokens each, greedily, with the live vet dashboard.

    ``transport`` runs the dashboard's ``shards`` shard muxes in worker
    processes; ``tune`` drives their ``tick_budget`` knob with the online
    tuner (module docstring).

    Raises:
        ValueError: an encoder-only config (hubert-xlarge); a
            vision-language config (internvl2-26b: the reference's serve
            feeds token prompts only, so serving images is a feature it
            lacks); for an SSM or hybrid model, ``prompt_len`` not a
            multiple of ``cfg.ssm_chunk`` (the SSD scan's chunking); for a
            model with attention (the hybrid's included), ``prompt_len``
            above 1024 and not a multiple of it (the attention's query
            chunk).  The length rules are the reference's.  All raised
            before any weight is drawn.
        RuntimeError: the resolved device is CUDA and no card is present.
    """
    cfg = get_config(cfg_or_name) if isinstance(cfg_or_name, str) else cfg_or_name
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    if cfg.frontend == "vision_patches":
        raise ValueError(
            f"{cfg.name} is a vision-language model and serve feeds token "
            f"prompts only, as the reference's serve does: serving images "
            f"is a feature the reference lacks")
    _check_prompt_len(cfg, prompt_len)
    if tracer is None and trace_path is not None:
        tracer = Tracer()
    device = require_device(resolve_device(device))

    t0 = time.perf_counter()
    params, prompts = serve_inputs(cfg, batch=batch, prompt_len=prompt_len,
                                   seed=seed, dtype=dtype, device=device,
                                   init_device=init_device)
    cache = init_cache(cfg, batch, prompt_len + gen_len, dtype=dtype,
                       device=device)
    _sync(prompts)
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tracing(tracer):
        logits, cache = prefill(cfg, params, cache, {"tokens": prompts})
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(tok)
    prefill_s = time.perf_counter() - t0

    prof = RecordProfiler(unit=record_unit, name="decode", tracer=tracer)
    # Live window snapshots: this worker's stream registered in a sharded
    # fleet mux (``shards=1`` is one local decode worker) and ticked as
    # unit-records complete, so each tick vets only the newly finished
    # windows through the fleet's coalesced dispatch path.  Under
    # ``transport`` each shard mux lives in its own worker process.
    fleet = TransportVetMux if transport else ShardedVetMux
    mux = fleet(shards,
                engine=(engine if engine is not None
                        else default_engine("cuda", buckets=64,
                                            device=device)),
                tracer=tracer)
    try:
        # (Under transport the stream lives in a worker, so register
        # returns its shard index, not the stream.)
        stream = mux.register("decode", window=_SNAPSHOT_WINDOW,
                              stride=_SNAPSHOT_WINDOW,
                              capacity=4 * _SNAPSHOT_WINDOW,
                              history=_SNAPSHOT_HISTORY)
        fed_units = 0
        flags = []  # regime-shift flags raised live during decode
        vet_s = 0.0  # the dashboard's share of the throughput wall
        # The mux's tick_budget knob driven by the online tuner, each
        # estimation tick's measured duration the (noisy) objective sample.
        tuner = (VetTuner(mux_knob_hooks(mux), seed=seed, noise_band=0.5,
                          tracer=tracer) if tune else None)

        def _tick():
            for f in mux.tick().flags:
                flags.append(f)
                if verbose:
                    print(f"[serve] REGIME SHIFT {f.stream_id}: window "
                          f"{f.onset} vet {f.pre:.2f} -> {f.post:.2f} "
                          f"(confidence {f.confidence:.2f})")

        out = [tok]
        for i in range(gen_len - 1):
            with prof.record(), tracing(tracer):
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
                if tuner is not None:
                    # Knob write-back happens here, strictly between ticks.
                    tuner.step(sw.dur)
        wall = time.perf_counter() - t0
        gen = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

        vet = ei = pr = None
        windows = None
        times = prof.unit_times()
        if times.size >= 16:
            if engine is None:
                # the bucket count adapts to the profile size so short runs
                # keep the bucketed estimator
                engine = default_engine("cuda",
                                        buckets=min(64, times.size // 4),
                                        device=device)
            r = engine.vet_one(times)
            vet, ei, pr = float(r.vet), float(r.ei), float(r.pr)
            if verbose:
                print(f"[serve] vet={vet:.3f} EI={ei:.4f}s PR={pr:.4f}s")
            with _timed(tracer, "serve.vet", post=True):
                mux.feed("decode", times[fed_units:])  # trailing units
                _tick()
            # Transport ticks carry newest-window rows only; the retained
            # drift history comes from the bulk path.
            win = (mux.collect("decode") if transport
                   else mux.stream("decode").collect())
            if win is not None and win.workers >= 2:
                windows = win
                if verbose:
                    ws = " ".join(f"{v:.2f}" for v in windows.vet)
                    ms = mux.stats
                    detail = (f"{ms.respawns} respawns" if transport else
                              f"{stream.stats.vetted} vetted / "
                              f"{stream.stats.reused} reused rows")
                    print(f"[serve] window vets: {ws} "
                          f"({detail} over {ms.ticks} mux ticks / "
                          f"{ms.dispatches} dispatches / "
                          f"{ms.anomalies} anomalies)")
        mux_stats = mux.stats
    finally:
        mux.close()
    tps = batch * gen_len / wall
    if verbose:
        print(f"[serve] {batch}x{gen_len} tokens in {wall:.2f}s = {tps:.1f} "
              f"tok/s (prefill {prefill_s * 1e3:.1f} ms, dashboard "
              f"{vet_s * 1e3:.1f} ms on {device})")
    tuner_report = None
    if tuner is not None:
        tuner_report = tuner.report()
        if verbose:
            knobs = " ".join(f"{k}={v}"
                             for k, v in sorted(tuner_report["best"].items()))
            print(f"[serve] tuner: best {knobs} "
                  f"(obj {tuner_report['best_y'] * 1e3:.2f}ms/tick over "
                  f"{tuner_report['rounds']} rounds / "
                  f"{tuner_report['rollbacks']} rollbacks"
                  f"{', converged' if tuner_report['converged'] else ''})")
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
                       prefill_s=prefill_s, mux=mux_stats, unit_times=times,
                       init_s=init_s, tuner=tuner_report, vet_s=vet_s)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--shards", type=int, default=1,
                    help="partition the vet fleet across N shard muxes")
    ap.add_argument("--transport", action="store_true",
                    help="run each shard mux in its own worker process "
                         "(retries + checkpoint/resume)")
    ap.add_argument("--tune", action="store_true",
                    help="close the loop: drive the mux tick_budget knob "
                         "with the online VetTuner and print its best "
                         "assignment on the dashboard")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="trace the run and write a Chrome trace-event JSON "
                         "here (Perfetto-loadable); also prints the "
                         "optimality ledger")
    return ap.parse_args(argv)


def main(argv=None) -> ServeResult:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen_len=args.gen_len, shards=args.shards,
                 transport=args.transport, tune=args.tune,
                 trace_path=args.trace)


if __name__ == "__main__":
    main()
