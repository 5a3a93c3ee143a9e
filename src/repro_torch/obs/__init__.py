"""repro_torch.obs — the span tracer (a copy of ``repro.obs.trace``).

Only the ``span`` seam the engine, stream and mux time themselves through
is ported so far; metrics, exports and the optimality ledger come later.
"""

from .trace import SpanRecord, Tracer, span, timed

__all__ = ["SpanRecord", "Tracer", "span", "timed"]
