"""repro_torch.obs — tracing and the optimality ledger (the port of
``repro.obs``; the reference's metrics registry has no port).

- ``Tracer`` / ``span`` / ``timed`` (``trace``): nested spans with an
  injectable monotonic clock and a no-op path when disabled; the engine,
  stream, mux and shard layers time themselves through this one seam.
  ``tracing`` / ``region``: the ambient tracer the model's spans record
  into.  Under ``torch.profiler`` every span is also a ``repro_torch.*``
  range on the profiler's clock.
- ``to_chrome`` / ``write_chrome`` / ``validate_chrome`` / ``flamegraph``
  (``export``) and ``ledger_from`` / ``format_ledger`` (``ledger``): Chrome
  trace-event JSON and the measured-over-floor ledger that
  ``launch.serve --trace`` prints.
"""

from .trace import SpanRecord, Tracer, region, span, timed, tracing
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
    "DISPATCH_FLOOR_S",
    "LEDGER_MEM_BW",
    "LedgerReport",
    "SpanRecord",
    "StageLedger",
    "Tracer",
    "flamegraph",
    "format_ledger",
    "ledger_from",
    "region",
    "span",
    "timed",
    "to_chrome",
    "tracing",
    "validate_chrome",
    "write_chrome",
]
