"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``),
driven by data: ``BENCHMARK.json`` at the checkout's root names the cells;
``configs/<config>.json``, ``mixes/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py`` are found by those
names.  ``run.py`` is the command."""
