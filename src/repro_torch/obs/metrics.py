"""Metrics — the counter/gauge/histogram half of the observability layer.

Port of ``src/repro/obs/metrics.py`` (numpy/stdlib only; imports rewritten).

A ``MetricsRegistry`` is a cheap named store of three instrument kinds:

  * ``Counter``   — monotonically increasing int (requests served, cache
    hits); one dict probe + one add per ``inc``, safe on any hot path;
  * ``Gauge``     — last-written value (queue depth, in-flight batches);
  * ``Histogram`` — bounded reservoir of observations with zero-safe
    percentiles (request sojourn) — ``percentile`` on an empty histogram
    returns ``None``, never NaN and never a ZeroDivisionError.

Registries are *instances*, not process globals, so two serving engines in
one process never see each other's request counts; the one process-global
registry (``obs.metrics()``) exists for genuinely process-wide state such
as the plan/runner cache counters.  ``stats()`` surfaces read instruments
from a registry instead of keeping their own ad-hoc tallies.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics"]


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Bounded reservoir (newest ``maxlen`` observations) with running
    count/sum over *all* observations ever made."""

    __slots__ = ("name", "count", "total", "values")

    def __init__(self, name: str, maxlen: int = 65536):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.values: deque[float] = deque(maxlen=maxlen)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.values.append(v)

    def percentile(self, q: float) -> float | None:
        """q-th percentile of the retained observations — ``None`` when
        nothing has been observed (the explicit zero-traffic answer)."""
        if not self.values:
            return None
        xs = sorted(self.values)
        idx = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
        return xs[idx]

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def recent_mean(self, n: int = 32) -> float | None:
        """Mean of the newest ``n`` observations (``None`` when empty) —
        a live estimate that tracks drift instead of averaging over a
        process lifetime; O(n), never O(maxlen).  The serving scheduler's
        warm per-bucket service-time estimate."""
        total, k = 0.0, 0
        for v in reversed(self.values):
            total += v
            k += 1
            if k >= n:
                break
        return total / k if k else None

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class MetricsRegistry:
    """Named get-or-create store of instruments.

    Lookups are single dict probes; creation takes a lock so concurrent
    first-touch from serving threads cannot race two instruments onto one
    name.
    """

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory, kind):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, factory(name))
        assert isinstance(inst, kind), \
            f"metric {name!r} already registered as " \
            f"{type(inst).__name__}, not {kind.__name__}"
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, maxlen: int = 65536) -> Histogram:
        return self._get(name, lambda n: Histogram(n, maxlen), Histogram)

    def snapshot(self) -> dict:
        """Flat ``name -> value`` view (histograms expand to their
        count/sum/percentile snapshot) — what ``stats()`` surfaces embed."""
        out = {}
        for name, inst in sorted(self._instruments.items()):
            out[name] = inst.snapshot() if isinstance(inst, Histogram) \
                else inst.value
        return out

    def reset(self, prefix: str = "") -> None:
        for name, inst in self._instruments.items():
            if name.startswith(prefix):
                if isinstance(inst, Counter):
                    inst.reset()
                elif isinstance(inst, Gauge):
                    inst.value = 0.0
                else:
                    inst.count = 0
                    inst.total = 0.0
                    inst.values.clear()


_METRICS = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-global registry — for process-wide state (the plan and
    runner cache counters); per-engine/per-model state belongs in an owned
    ``MetricsRegistry`` instance."""
    return _METRICS
