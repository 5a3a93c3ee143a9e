"""Fault-tolerant training driver with vet instrumentation (the port of
``repro.launch.train``).

Loop: data fetch -> train step -> (periodic) async checkpoint, with
  * every step timed as a vet "record" (unit-grouped, paper §5.2), the
    step's loss read back to the host inside the record, which waits for
    the device;
  * sub-phases (data / step / ckpt) timed for the Fig. 3 spill-constancy
    view;
  * crash-resume: restore from the newest complete checkpoint, replay the
    deterministic data stream from the step counter;
  * simulated failure injection (``fail_at_step``) for the recovery tests;
  * a ``VetController`` consuming the live profile (paper §5.5) whose
    decision is surfaced in the result;
  * all vet estimation routed through one shared ``VetEngine``
    (``engine=``); by default ``default_engine("cuda", ...)`` on the
    training device, as ``launch.serve`` does, so on the card the report's
    ``vet_one`` runs the change-point kernel once its curve holds 6 points
    (a 96-step run's 19 unit records make a 4-bucket curve, which takes
    none) and the controller's ``decide()`` the window-vet kernel once a
    worker holds a full window of unit records (below 32 it answers
    "insufficient data", as the reference's does).

Weights come from ``models.init_params`` with a ``torch.Generator`` seeded
by ``seed`` on the CPU (the same model on every device; not the
reference's ``jax.random`` draw), or from ``params=``, a tree in the port's
layout: ``models.params_from_numpy`` carries the reference's weights
across.  On the card the forward pass launches the SSD kernel in every
Mamba layer and the flash-attention kernel in every attention layer, and
under the default ``remat="full"`` once more in the backward pass's
recompute; their gradients are the plain versions'
(``kernels.runtime.plain_vjp``).

``mesh`` (a ``DeviceMesh``, ``launch.mesh.make_mesh``) trains on a mesh:
the weights and moments are placed by the sharding rules
(``distributed.elastic.reshard_state``) and each step is
``launch.steps.jit_train_step``'s, which places each batch over the DP
axes; a resumed run restores the checkpoint's full arrays onto the mesh
(``checkpoint.restore`` into the placed state, then ``reshard_state``),
whatever mesh wrote them.

CLI: ``python -m repro_torch.launch.train --arch mamba2-130m --steps 100``
(on the card; ``REPRO_TORCH_DEVICE=cpu`` and ``--reduced`` to run on the
CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, Optional

import torch

from ..checkpoint.checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..data.pipeline import SyntheticTokenPipeline
from ..distributed.elastic import reshard_state
from ..engine import VetEngine, default_engine
from ..kernels.runtime import require_device, resolve_device
from ..models import init_params
from ..optim.adamw import AdamWConfig, init_opt_state
from ..profiling import PhaseTimer, RecordProfiler
from ..sched.straggler import VetController
from ..tree import tree_map
from .steps import jit_train_step, make_train_step

__all__ = ["SimulatedFailure", "TrainResult", "main", "train"]


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list
    vet: Optional[float]
    ei: Optional[float]
    pr: Optional[float]
    phase_totals: Dict[str, float]
    resumed_from: Optional[int]
    controller_decision: Optional[Any]
    # per-worker vet snapshots from the controller's batched engine call
    worker_vets: Optional[Dict[int, float]] = None


class SimulatedFailure(RuntimeError):
    pass


def train(
    cfg_or_name,
    *,
    steps: int,
    batch: int = 8,
    seq_len: int = 128,
    lr: float = 3e-4,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    dtype=torch.float32,
    mesh=None,
    n_micro: int = 1,
    record_unit: int = 5,
    fail_at_step: Optional[int] = None,
    fetch_stall_s: float = 0.0,
    q_chunk: int = 1024,
    log_every: int = 10,
    verbose: bool = True,
    engine: Optional[VetEngine] = None,
    device=None,
    params=None,
) -> TrainResult:
    """Train ``steps`` steps (resuming from ``ckpt_dir`` when it holds a
    checkpoint) and vet the run's step profile.

    ``params`` (the port's layout, on any device) replaces the seeded
    initial weights; a resumed run overwrites it from the checkpoint.
    ``mesh`` places weights, moments and batches on it (module docstring);
    every rank of the mesh calls ``train`` alike.

    Raises:
        SimulatedFailure: at ``fail_at_step``, after that step's update.
        RuntimeError: the resolved device is CUDA and no card is present.
    """
    cfg = get_config(cfg_or_name) if isinstance(cfg_or_name, str) else cfg_or_name
    device = require_device(resolve_device(device))
    pipe = SyntheticTokenPipeline(
        cfg.vocab_size, batch, seq_len, seed=seed, d_model=cfg.d_model,
        frontend=cfg.frontend, frontend_seq=max(cfg.frontend_seq, 0),
        fetch_stall_s=fetch_stall_s,
    )
    opt_cfg = AdamWConfig(lr=lr, total_steps=max(steps, 2),
                          warmup_steps=min(20, steps // 5 + 1))
    step_kw = dict(opt_cfg=opt_cfg, q_chunk=q_chunk, n_micro=n_micro)

    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             dtype=dtype)
    params = tree_map(lambda t: t.to(device), params)
    opt = init_opt_state(params)
    if mesh is None:
        step_fn = make_train_step(cfg, None, **step_kw)
    else:
        b_shape = {k: torch.empty(v.shape, device="meta")
                   for k, v in pipe.batch_at(0).items()}
        step_fn = jit_train_step(cfg, mesh, params, opt, b_shape, **step_kw)
        params, opt = reshard_state(cfg, mesh, params, opt)

    start_step, resumed_from = 0, None
    ckpt: Optional[AsyncCheckpointer] = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        if latest_step(ckpt_dir) is not None:
            # the checkpoint's full arrays, each rank's shard cut as the
            # leaf it replaces is placed, then the rules' placements
            (params, opt), start_step = restore(ckpt_dir, (params, opt))
            if mesh is not None:
                params, opt = reshard_state(cfg, mesh, params, opt)
            start_step += 1
            resumed_from = start_step - 1
            if verbose:
                print(f"[train] resumed from step {resumed_from}")

    prof = RecordProfiler(unit=record_unit)
    phases = PhaseTimer()
    # With no explicit engine, the controller gets the shared fixed-bucket
    # default; the end-of-run report below adapts buckets to the profile
    # size (the reference's convention for short runs).
    controller = VetController(
        n_workers=max(n_micro, 1),
        engine=(engine if engine is not None
                else default_engine("cuda", device=device)),
    )
    losses = []

    step = start_step
    try:
        for step in range(start_step, steps):
            with phases.phase("data"):
                dev_batch = {k: torch.from_numpy(v).to(device)
                             for k, v in pipe.batch_at(step).items()}
            with prof.record():
                with phases.phase("step"):
                    params, opt, metrics = step_fn(params, opt, dev_batch)
                    loss = float(metrics["loss"])
            losses.append(loss)
            if fail_at_step is not None and step == fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            if ckpt and step > 0 and step % ckpt_every == 0:
                with phases.phase("ckpt"):
                    ckpt.save(step, (params, opt))
            if verbose and step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
    finally:
        if ckpt:
            try:
                ckpt.wait()
            except Exception:  # the loop's own error, if any, is the news
                pass

    # final checkpoint + vet report
    if ckpt:
        ckpt.save(step, (params, opt))
        ckpt.wait()

    vet = ei = pr = None
    decision = None
    worker_vets = None
    times = prof.unit_times()
    if times.size >= 16:
        if engine is None:
            engine = default_engine("cuda", buckets=min(64, times.size // 4),
                                    device=device)
        r = engine.vet_one(times)
        vet, ei, pr = float(r.vet), float(r.ei), float(r.pr)
        controller.feed(0, times)
        decision = controller.decide()
        worker_vets = dict(decision.worker_vets) or None
        if verbose:
            print(f"[train] vet={vet:.3f} EI={ei:.3f}s PR={pr:.3f}s "
                  f"controller: {decision.reason}")
    return TrainResult(
        final_step=step, losses=losses, vet=vet, ei=ei, pr=pr,
        phase_totals=phases.totals(), resumed_from=resumed_from,
        controller_decision=decision, worker_vets=worker_vets,
    )


def parse_args(argv=None) -> argparse.Namespace:
    """The reference's command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--n-micro", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                lr=args.lr, ckpt_dir=args.ckpt_dir, n_micro=args.n_micro)
    print(f"[train] done at step {res.final_step}; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
