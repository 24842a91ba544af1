"""Observability: span tracing and metrics.

Port of ``src/repro/obs/__init__.py``; stdlib only.  The span names
(``compile``, ``pass.*``, ``build_runner``, ``residency.upload``) match the
reference's, so a trace of the port reads like a trace of the reference.
Per-op profiling (``obs/profile.py``) is not ported yet (ROADMAP queue 1
item 5).

  * **spans** (``obs.span`` / ``obs.get_tracer``) — nested wall-clock
    regions over the compile pipeline (one span per pass) and runner
    builds, exportable as Chrome/Perfetto trace-event JSON
    (``obs.export_chrome_trace``);
  * **metrics** (``obs.MetricsRegistry`` / the process-global
    ``obs.metrics()``) — counters, gauges, and zero-safe histograms.

Tracing is **off by default**; hot paths pay one attribute read per
instrumented site.  ``telemetry(True)`` (what
``CompileOptions(telemetry=True)`` routes through) force-enables the
tracer for a region.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, metrics)
from repro_torch.obs.trace import (NOOP_SPAN, Span, Tracer,  # noqa: F401
                                   clear, complete, enabled,
                                   export_chrome_trace, get_tracer, instant,
                                   now, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "Span", "Tracer", "get_tracer", "span", "now", "enabled", "instant",
    "complete", "export_chrome_trace", "clear", "telemetry",
]


@contextlib.contextmanager
def telemetry(on: bool = True):
    """Force span recording for a region (no-op when ``on`` is falsy or
    the tracer is already enabled) — ``CompileOptions(telemetry=True)``
    wraps one compile in this so its pass spans record."""
    tracer = get_tracer()
    if not on or tracer.enabled:
        yield tracer
        return
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
