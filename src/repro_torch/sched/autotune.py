"""Starfish-analogue config tuner, audited by vet (the port of
``repro.sched.autotune``; paper §5.5 context).

Starfish searches Hadoop parameter space against a cost model; the analogue
here grid-searches launcher knobs (microbatch count, q_chunk) against
measured step time, then vet answers the paper's question: *how far from
ideal is the tuned configuration still?*  (Paper Table 3: Starfish-tuned
jobs still show vet 3.3-4.2.)

This is the *offline* half of the tuning layer: candidate scoring is shared
with the online tuner (``sched.tuner.evaluate_candidate``), and with
``tracer=`` every candidate shows up as a ``tuner.candidate`` span over its
``tune.step`` samples.  Each step is timed to the loss on the host, which
waits for the device.  Every candidate starts from the same weights,
drawn from ``seed`` on the CPU as ``launch.train`` draws them.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch

from ..data.pipeline import SyntheticTokenPipeline
from ..engine import VetEngine, default_engine
from ..kernels.runtime import require_device, resolve_device
from ..models import init_params
from ..optim.adamw import AdamWConfig, init_opt_state
from ..profiling import RecordProfiler
from ..tree import tree_map
from .tuner import TuneCandidate, evaluate_candidate

__all__ = ["TuneCandidate", "tune"]


def tune(
    cfg,
    *,
    batch: int = 8,
    seq_len: int = 64,
    steps_per_candidate: int = 30,
    n_micro_options: Sequence[int] = (1, 2),
    q_chunk_options: Sequence[int] = (32, 64),
    seed: int = 0,
    verbose: bool = True,
    engine: Optional[VetEngine] = None,
    tracer=None,
    device=None,
) -> List[TuneCandidate]:
    """Measure every knob combination; return candidates sorted by step
    time, each annotated with its vet score (the optimality audit).  A
    ``n_micro`` that does not divide ``batch`` is skipped.

    Raises:
        RuntimeError: the resolved device is CUDA and no card is present.
    """
    from ..launch.steps import make_train_step

    device = require_device(resolve_device(device))
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch, seq_len, seed=seed,
                                  d_model=cfg.d_model, frontend=cfg.frontend,
                                  frontend_seq=max(cfg.frontend_seq, 0))
    results = []
    for n_micro, q_chunk in itertools.product(n_micro_options, q_chunk_options):
        if batch % n_micro:
            continue
        params = tree_map(
            lambda t: t.to(device),
            init_params(cfg, torch.Generator().manual_seed(seed),
                        dtype=torch.float32))
        opt = init_opt_state(params)
        step_fn = make_train_step(
            cfg, None, opt_cfg=AdamWConfig(total_steps=steps_per_candidate),
            q_chunk=q_chunk, n_micro=n_micro)
        prof = RecordProfiler(unit=1, name="tune.step", tracer=tracer)
        for s in range(steps_per_candidate):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(s).items()}
            with prof.record():
                params, opt, m = step_fn(params, opt, b)
                float(m["loss"])
        times = prof.record_times()[2:]  # drop the warm-up steps
        eng = engine if engine is not None else default_engine(
            "cuda", buckets=min(64, max(8, times.size // 4)), device=device)
        cand = evaluate_candidate({"n_micro": n_micro, "q_chunk": q_chunk},
                                  times, engine=eng, tracer=tracer)
        results.append(cand)
        if verbose:
            print(f"[tune] {cand.knobs}: step {cand.mean_step_s*1e3:.1f}ms "
                  f"vet {cand.vet:.2f}")
    results.sort(key=lambda c: c.mean_step_s)
    return results
