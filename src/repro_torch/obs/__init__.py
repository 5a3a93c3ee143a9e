"""repro_torch.obs — tracing, metrics and the optimality ledger (a copy of
``repro.obs``, pure Python).

- ``Tracer`` / ``span`` / ``timed`` (``trace``): nested spans with an
  injectable monotonic clock and a no-op path when disabled; the engine,
  stream, mux and shard layers time themselves through this one seam.
- ``MetricsRegistry`` (``metrics``): counters, gauges, fixed-bucket
  histograms.
- ``to_chrome`` / ``write_chrome`` / ``validate_chrome`` / ``flamegraph``
  (``export``) and ``ledger_from`` / ``format_ledger`` (``ledger``): Chrome
  trace-event JSON and the measured-over-floor ledger that
  ``launch.serve --trace`` prints.
"""

from .trace import SpanRecord, Tracer, span, timed
from .metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .export import flamegraph, to_chrome, validate_chrome, write_chrome
from .ledger import (
    DISPATCH_FLOOR_S,
    LEDGER_MEM_BW,
    LedgerReport,
    StageLedger,
    format_ledger,
    ledger_from,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "DISPATCH_FLOOR_S",
    "LEDGER_MEM_BW",
    "Counter",
    "Gauge",
    "Histogram",
    "LedgerReport",
    "MetricsRegistry",
    "SpanRecord",
    "StageLedger",
    "Tracer",
    "flamegraph",
    "format_ledger",
    "ledger_from",
    "span",
    "timed",
    "to_chrome",
    "validate_chrome",
    "write_chrome",
]
