"""Quickstart: the vet optimality measure end-to-end in ~a minute.

1. Simulated profile with known ground truth -> EI recovers the ideal.
2. REAL oversubscription on this host (paper Table 2 regime) -> PR grows
   with worker count, EI stays put, vet exposes the reducible overhead.
3. Heavy-tail diagnosis (Hill estimator, paper Fig. 9).
4. Windowed vetting: every sliding window of the stream in one batched
   engine call, repeated ticks served from the result cache.
5. Streaming ticks: the same stream fed live through a VetStream — each
   tick vets only the windows that just completed, reusing every earlier row.
6. Sharded fleet: a whole fleet of live streams partitioned across shard
   muxes (one engine per shard — the cross-process model), per-shard ticks
   merged into one job-level vet (paper §4.4 at fleet scale).
7. Observability: the same fleet traced end to end (driver + every shard
   worker in one span tree), rendered as a flamegraph and scored by the
   optimality ledger — the paper's measured-over-floor discipline applied
   to our own stack.  ``--trace out.json`` dumps a Chrome trace you can
   load in Perfetto / chrome://tracing.
8. Closed loop: an online ``VetTuner`` drives the ``tunable`` scenario's
   knobs through the knob_hooks seam — SPSA probe pairs on the integer
   knobs, a discounted bandit on the categorical one — and lands on the
   scenario's designed optimum, which exhaustive grid search confirms.

This is the PyTorch/CUDA port's tour (``repro_torch``): the engines run
the ``cuda`` backend, on the card by default; ``--device cpu`` or
``REPRO_TORCH_DEVICE=cpu`` runs them on the CPU through the kernels'
plain versions.  Stanza 8's tuner stays on the ``numpy`` backend, as in
the reference's tour.

Run:  PYTHONPATH=src python examples/port_quickstart.py
      PYTHONPATH=src python examples/port_quickstart.py --stanza 6   # fleet only
      PYTHONPATH=src python examples/port_quickstart.py --stanza 7 --trace t.json
      PYTHONPATH=src python examples/port_quickstart.py --stanza 8   # autotuner
"""

import argparse
import time

import numpy as np

from repro_torch.core import tail_report, vet_job, vet_task
from repro_torch.engine import VetEngine, VetStream, default_engine
from repro_torch.fleet import ShardedVetMux, TransportVetMux, build, play
from repro_torch.obs import Tracer, flamegraph, format_ledger, ledger_from, \
    write_chrome
from repro_torch.profiling import run_contended_job, simulate_records


def stanza6(n_workers: int = 12, shards: int = 2, n_ticks: int = 5,
            backend: str = "cuda", verbose: bool = True,
            device=None) -> dict:
    """Sharded fleet tick + merged job-level vet (runs standalone)."""
    if verbose:
        print("=" * 64)
        print(f"6) Sharded fleet: {n_workers} live streams over {shards} "
              f"shard muxes, merged vet_job")
    scenario = build("mixed_windows", n_workers=n_workers, n_ticks=n_ticks,
                     seed=0)
    fleet = ShardedVetMux(shards, engine=VetEngine(backend, buckets=64,
                                                   device=device))
    last = play(scenario, fleet)[-1]
    job = last.job  # stream-count-weighted merge of per-shard reductions
    per_shard = [s.dispatches for s in fleet.shard_stats]
    balance = [0] * shards
    for k in fleet.assignment.values():
        balance[k] += 1
    if verbose:
        print(f"   placement: {balance} streams/shard "
              f"(deterministic length-affine bin-packing)")
        print(f"   dispatches per shard over {n_ticks} ticks: {per_shard} "
              f"— each shard pays only its local window lengths")
        print(f"   job-level: vet_job {job.vet_job:.2f}   "
              f"EI {job.ei * 1e3:.2f}ms   OC {job.oc * 1e3:.2f}ms   "
              f"({job.streams} streams merged)")
        print("   (a single mux over the same feeds computes the same "
              "rows: tests/test_torch_shard.py)")
    return {"vet_job": job.vet_job, "balance": balance,
            "dispatches_per_shard": per_shard, "streams": job.streams}


def stanza7(n_workers: int = 12, shards: int = 2, n_ticks: int = 5,
            trace_path=None, verbose: bool = True, device=None) -> dict:
    """Traced fleet + flamegraph + optimality ledger (runs standalone)."""
    if verbose:
        print("=" * 64)
        print(f"7) Observability: {n_workers} streams over {shards} shard "
              f"workers, one cross-process trace")
    tracer = Tracer()
    scenario = build("mixed_windows", n_workers=n_workers, n_ticks=n_ticks,
                     seed=0)
    # The in-process transport driver runs the identical command protocol
    # as real worker processes — worker spans ride back on every tick reply
    # and are adopted under their shard's process lane.
    with TransportVetMux(shards, engine=VetEngine("cuda", buckets=64,
                                                  device=device),
                         driver="inprocess", tracer=tracer) as fleet:
        play(scenario, fleet)
    ledger = ledger_from(tracer.records)
    pids = sorted({r.pid for r in tracer.records})
    if verbose:
        print(f"   {len(tracer.records)} spans across processes {pids} "
              f"({', '.join(tracer.process_names[p] for p in pids)})")
        print(flamegraph(tracer.records))
        print(format_ledger(ledger))
        print("   (x over floor ~1 = dispatch runs at the data-movement "
              "bound; big = headroom)")
    if trace_path:
        write_chrome(trace_path, tracer)
        if verbose:
            print(f"   chrome trace -> {trace_path} "
                  f"(load in Perfetto / chrome://tracing)")
    return {"spans": len(tracer.records), "pids": pids,
            "ledger_ratio": ledger.ratio}


def stanza8(backend: str = "numpy", max_ticks: int = 96,
            verbose: bool = True) -> dict:
    """Online autotuning: VetTuner vs the exhaustive grid oracle."""
    from repro_torch.fleet import tunable
    from repro_torch.sched.tuner import grid_scenario, tune_scenario

    if verbose:
        print("=" * 64)
        print("8) Closed loop: online VetTuner on the tunable scenario "
              f"({backend} backend)")
    sc = tunable(seed=0)
    rep = tune_scenario(tunable(seed=0), engine=VetEngine(backend, buckets=64),
                        max_ticks=max_ticks, seed=0)
    grid = grid_scenario(sc, engine=VetEngine(backend, buckets=64))
    agree = rep.best == grid.best[0] == sc.optimum
    if verbose:
        knobs = ", ".join(f"{k}={v}" for k, v in sorted(rep.best.items()))
        print(f"   tuner best after {rep.ticks} ticks / {rep.rounds} rounds: "
              f"{knobs}  (vet objective {rep.best_y:.3f})")
        print(f"   grid oracle ({len(grid.table)} cells) agrees: {agree}   "
              f"designed optimum recovered, converged={rep.converged}")
        print("   (the reference's walk, step for step: "
              "tests/test_torch_tuner.py; live fleets: launch.serve --tune)")
    return {"best": rep.best, "agree": agree, "rounds": rep.rounds,
            "converged": rep.converged}


def tour(trace_path=None, device=None) -> dict:
    print("=" * 64)
    print("1) Controlled validation: simulator with known ground truth")
    p = simulate_records(200_000, base=1e-6, base_jitter=0.1, io_frac=0.1,
                         io_cost=2e-6, overhead_frac=0.05, overhead_scale=2e-5,
                         seed=0)
    r = vet_task(p.times)
    print(f"   true EI {p.true_ei:.3f}s   estimated EI {float(r.ei):.3f}s "
          f"({abs(float(r.ei) - p.true_ei) / p.true_ei:+.1%})")
    print(f"   true vet {p.true_vet:.2f}    estimated vet {float(r.vet):.2f}")

    print("=" * 64)
    print("2) Real measurement: oversubscribed workers on this host")
    print("   (the paper's Table 2: slots 1->4 gave PR 3.2->10.3s, EI ~const)")
    for w in (1, 2, 4):
        tasks = run_contended_job(w, 300, unit=5)
        jr = vet_job(tasks, buckets=64)
        print(f"   W={w}:  PR {float(jr.pr_mean)*1e3:7.1f}ms   "
              f"EI {float(jr.ei_mean)*1e3:6.1f}ms   vet_job {float(jr.vet_job):.2f}")

    print("=" * 64)
    print("3) Tail diagnosis (paper Fig. 9: alpha ~ 1.3 => heavy tail)")
    tasks = run_contended_job(3, 600, unit=1)
    times = np.concatenate(tasks)
    rep = tail_report(times)
    print(f"   Hill alpha {rep.alpha:.2f}  (band {rep.alpha_stable_band[0]:.2f}"
          f"-{rep.alpha_stable_band[1]:.2f})  heavy={rep.heavy}")

    print("=" * 64)
    print("4) Windowed vetting: the whole stream, one batched engine call")
    engine = default_engine("cuda", buckets=64, device=device)
    win = engine.vet_sliding(times, window=256, stride=64)
    print(f"   {win.workers} sliding windows: vet p50 "
          f"{float(np.median(win.vet)):.2f}   worst window "
          f"{float(win.vet.max()):.2f}")
    t0 = time.perf_counter()
    engine.vet_sliding(times, window=256, stride=64)  # unchanged stream
    print(f"   repeated dashboard tick: {1e6*(time.perf_counter()-t0):.0f}us "
          f"(result cache: {engine.cache_info().hits} hits)")

    print("=" * 64)
    print("5) Streaming ticks: feed the same stream live, vet only the delta")
    stream = VetStream(engine, window=256, stride=64, capacity=1024)
    chunk, tick_us = 512, []
    for lo in range(0, times.size, chunk):
        stream.append(times[lo:lo + chunk])  # O(chunk): rolling fingerprint
        t0 = time.perf_counter()
        live = stream.tick()  # vets only newly complete windows
        tick_us.append(1e6 * (time.perf_counter() - t0))
    st = stream.stats
    print(f"   {st.ticks} ticks over {st.records} records: {st.vetted} "
          f"windows vetted once, {st.reused} rows reused, "
          f"~{np.median(tick_us):.0f}us/tick (first tick pays the compile)")
    print(f"   stream result == batch oracle: "
          f"{np.allclose(live.vet, win.vet, rtol=1e-5)}   "
          f"latest window vet {float(live.vet[-1]):.2f}")

    out = {"stanza6": stanza6(device=device),
           "stanza7": stanza7(trace_path=trace_path, device=device),
           "stanza8": stanza8()}
    print("Done. vet == 1 would mean nothing left to optimize.")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stanza", type=int, default=None,
                    help="run a single stanza (6 = sharded fleet, 7 = "
                         "traced fleet + ledger, 8 = online autotuner; "
                         "the others share state and run together)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write stanza 7's Chrome trace-event JSON here "
                         "(Perfetto-loadable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.stanza is None:
        return tour(trace_path=args.trace, device=args.device)
    if args.stanza == 6:
        return stanza6(device=args.device)
    if args.stanza == 7:
        return stanza7(trace_path=args.trace, device=args.device)
    if args.stanza == 8:
        return stanza8()
    ap.error("only stanzas 6-8 run standalone; omit --stanza for "
             "the full tour")


if __name__ == "__main__":
    main()
