"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

Usage, from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's card and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
correctness check compared beside its limit (also the last lines of
standard error).  Exits non-zero and prints no result when there is no
card, or fewer than the cell asks for, or when JAX or the JAX package was
loaded.  Every cache the program builds lies under ``build/`` in the
checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# One host thread for the libraries' own pools: the served path is one
# Python thread dispatching to the card, and idle pool threads spinning
# beside it slow it by varying amounts.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    from portbench import harness

    spec = harness.load_spec(args.workload, ROOT)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(spec, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda",
                         started=STARTED)
    banned = harness.banned_modules()
    if banned:
        print(f"portbench: loaded in the run's process: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
