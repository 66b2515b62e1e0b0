"""Zero-sync telemetry for the serving stack (counterpart of `repro.obs`).

Stdlib-only: the tracer and the metrics registry only ever receive
host-side Python values — scheduler counters, allocator free-list
sizes, host mirrors of row counts — so instrumentation sits inside the
double-buffered decode loops without adding a device sync. Trace-off is
the default (`NULL_TRACER` / `NULL_METRICS` are falsy singletons) and
costs one truthiness check per event site.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metrics,
                                     NULL_METRICS, NullMetrics,
                                     write_metrics_json)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "NullMetrics",
    "NULL_METRICS", "write_metrics_json",
    "NullTracer", "NULL_TRACER", "Span", "Tracer",
]
