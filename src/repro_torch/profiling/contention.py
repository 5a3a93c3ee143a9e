"""Real-measurement oversubscription harness (paper Table 2 / Fig. 13).

The port of ``repro.profiling.contention``, over the port's
``RecordProfiler``.  The record work stays a host numpy matmul: the paper's
Table 2 regime is host cores oversubscribed, not the card.

Runs W concurrent worker "tasks" on the host, each processing a stream of
records (small blocking computations), timing every record.  With W workers
sharing the host core(s) — exactly the paper's "slots per node > cores"
regime — most records still complete within their OS scheduling quantum
(record work is ~0.1-1 ms << quantum), but a heavy tail of records absorbs the
context switches and run-queue waits.  PR grows with W while EI stays put:
the paper's Table 2 phenomenon, measured for real.

NumPy releases the GIL during compute, so plain threads genuinely contend
for the core.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from .recorder import RecordProfiler

__all__ = ["make_record_work", "run_contended_job"]


def make_record_work(size: int = 96, reps: int = 2) -> Callable[[], float]:
    """A deterministic ~0.2-1 ms record computation (GIL-releasing matmuls).

    Returns a closure; calling it processes "one record" and returns a checksum
    (prevents dead-code elimination).
    """
    a = np.random.default_rng(0).standard_normal((size, size)).astype(np.float32)

    def work() -> float:
        x = a
        for _ in range(reps):
            x = x @ a
        return float(x[0, 0])

    return work


def run_contended_job(
    n_tasks: int,
    records_per_task: int,
    *,
    work: Optional[Callable[[], float]] = None,
    unit: int = 5,
    per_record_hook: Optional[Callable[[int, int], None]] = None,
) -> List[np.ndarray]:
    """Run ``n_tasks`` concurrent tasks; return per-task unit-grouped times.

    ``per_record_hook(task_id, record_id)`` (optional) runs outside the timed
    region — e.g. to inject I/O stalls for the Fig. 13 HDD/SSD contrast.
    The first error a task raises is raised here, after every task stopped.
    """
    work = work or make_record_work()
    profilers = [RecordProfiler(unit=unit, name=f"task{i}") for i in range(n_tasks)]
    barrier = threading.Barrier(n_tasks)
    errors: List[BaseException] = []

    def run(task_id: int) -> None:
        try:
            prof = profilers[task_id]
            work()  # warm caches outside the profile
            barrier.wait()
            for r in range(records_per_task):
                if per_record_hook is not None:
                    per_record_hook(task_id, r)
                with prof.record():
                    work()
        except BaseException as e:  # surfaced below
            errors.append(e)
            # A task that fails before the barrier would leave the others
            # waiting there forever: break it, so they stop too.
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_tasks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [p.unit_times() for p in profilers]
