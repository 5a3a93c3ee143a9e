"""The paper's §5.5 application on the PyTorch/CUDA port: vet as the
control signal for scheduling.

1. Grid-tune launcher knobs (Starfish analogue) and AUDIT each candidate with
   vet — the tuner can rank configs, vet says how far from ideal the best
   one still is (paper Table 3: Starfish-tuned jobs still at vet 3.3-4.2).
2. Drive the VetController with live profiles from an oversubscribed host:
   it applies the paper's W-rule and recommends the concurrency change.

Runs on the card by default; ``--device cpu`` or ``REPRO_TORCH_DEVICE=cpu``
runs it on the CPU.  ``--steps``, ``--records`` and ``--workers`` size it.

Run:  PYTHONPATH=src python examples/port_vet_tuning.py
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.engine import VetEngine
from repro_torch.profiling import run_contended_job
from repro_torch.sched import VetController
from repro_torch.sched.autotune import tune


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20,
                    help="training steps per tuning candidate")
    ap.add_argument("--records", type=int, default=300,
                    help="records per contended task")
    ap.add_argument("--workers", default="1,4",
                    help="worker counts the controller measures")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print("=" * 64)
    print("1) Starfish-analogue tuning audited by vet")
    cfg = get_config("qwen3-14b").reduced()
    cands = tune(cfg, batch=8, seq_len=64, steps_per_candidate=args.steps,
                 n_micro_options=(1, 2), q_chunk_options=(32, 64),
                 device=args.device)
    best = cands[0]
    print(f"   best knobs {best.knobs}: step {best.mean_step_s*1e3:.1f}ms, "
          f"vet {best.vet:.2f}")
    print(f"   -> even the tuned config leaves {best.vet - 1:.0%} reducible "
          f"overhead (the paper's Table 3 observation)")

    print("=" * 64)
    print("2) vet-driven concurrency controller (paper §5.5 W-rule)")
    decisions = {}
    for w in (int(x) for x in args.workers.split(",")):
        controller = VetController(
            n_workers=w, max_workers=6,
            engine=VetEngine("cuda", buckets=64, device=args.device))
        tasks = run_contended_job(w, args.records, unit=5)
        for i, t in enumerate(tasks):
            controller.feed(i, t)
        d = controller.decide()
        decisions[w] = d.target_workers
        print(f"   measured at W={w}: vet_job {d.vet_job:.2f} -> "
              f"recommend W={d.target_workers}  ({d.reason})")
    return {"best_knobs": best.knobs, "best_vet": best.vet,
            "targets": decisions}


if __name__ == "__main__":
    main()
