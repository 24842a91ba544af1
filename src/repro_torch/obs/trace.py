"""Span tracing — the timeline half of the observability layer.

Port of ``src/repro/obs/trace.py`` (numpy/stdlib only; imports rewritten).

One process-global ``Tracer`` records nested, wall-clock spans from every
layer of the stack (compile passes, runner builds, residency uploads,
serving dispatch/harvest) and exports them as Chrome trace-event JSON, so
a serve run opens directly in ``chrome://tracing`` / Perfetto.

Design constraints, in order:

  * **zero cost when off** — the tracer is disabled by default; the
    module-level ``span()`` helper returns a shared no-op object without
    allocating, so instrumented hot paths pay one attribute read;
  * **zero dependencies** — stdlib only (``time``/``threading``/``json``);
    this module is the one place in the repo allowed to call
    ``time.perf_counter`` for timing (``tools/lint_deprecated.py`` gates
    everything else onto ``obs.now()``/``obs.span()``);
  * **nesting without bookkeeping** — spans track their parent through a
    per-thread stack, so the Chrome flame graph comes out right even when
    compile spans nest three deep, and tests can assert on ``.parent``.

Timestamps are seconds on the ``perf_counter`` clock; export converts to
the trace-event format's microseconds relative to the tracer's epoch.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Any

__all__ = ["Span", "Tracer", "get_tracer", "span", "now", "enabled",
           "instant", "complete", "export_chrome_trace", "clear"]


def now() -> float:
    """Monotonic wall-clock seconds (the repo's one timing primitive)."""
    return time.perf_counter()


class _NoopSpan:
    """What ``span()`` hands out while tracing is disabled: enters, exits,
    and absorbs ``set()`` without recording or allocating anything."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region.  Context manager; ``set(**attrs)`` adds attributes
    mid-flight (op counts, byte totals) that are only known once the work
    has run."""

    __slots__ = ("name", "cat", "args", "t0", "dur", "parent", "tid",
                 "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0
        self.parent: str | None = None
        self.tid = 0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = now() - self.t0
        self._tracer._pop(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.dur * 1e3:.3f}ms, parent={self.parent!r})")


class Tracer:
    """Process-global span recorder (get it via ``obs.get_tracer()``).

    ``enabled`` gates recording: ``span()`` on a disabled tracer returns
    the shared no-op.  Finished spans accumulate in ``.spans`` (finish
    order); ``export_chrome_trace`` writes them as complete ("X") events
    plus any instant/retroactive events added through ``instant`` /
    ``complete``.
    """

    def __init__(self):
        self.enabled = False
        self.epoch = now()                 # ts=0 of the exported trace
        self.spans: list[Span] = []
        self.events: list[dict] = []       # pre-rendered non-span events
        self._lock = threading.Lock()
        self._stacks: dict[int, list[Span]] = {}
        self._tids: dict[int, int] = {}    # thread ident -> small tid

    # ------------------------------------------------------------ control --
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self._stacks.clear()
            self.epoch = now()

    # ----------------------------------------------------------- recording --
    def span(self, name: str, cat: str = "", **args):
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, cat, args)

    def _tid(self, ident: int) -> int:
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _push(self, sp: Span) -> None:
        ident = threading.get_ident()
        stack = self._stacks.setdefault(ident, [])
        sp.parent = stack[-1].name if stack else None
        sp.tid = self._tid(ident)
        stack.append(sp)

    def _pop(self, sp: Span) -> None:
        stack = self._stacks.get(threading.get_ident(), [])
        if stack and stack[-1] is sp:
            stack.pop()
        with self._lock:
            self.spans.append(sp)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Zero-duration marker (trace-event phase "i")."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat or "event", "ph": "i", "s": "t",
              "ts": (now() - self.epoch) * 1e6,
              "pid": os.getpid(), "tid": self._tid(threading.get_ident()),
              "args": args}
        with self._lock:
            self.events.append(ev)

    def complete(self, name: str, start_s: float, end_s: float,
                 cat: str = "", **args) -> None:
        """Retroactive complete event from two ``obs.now()`` readings —
        how the serving engine emits one span per request at harvest time
        (the request's life began long before harvest runs)."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat or "event", "ph": "X",
              "ts": (start_s - self.epoch) * 1e6,
              "dur": max(0.0, end_s - start_s) * 1e6,
              "pid": os.getpid(), "tid": self._tid(threading.get_ident()),
              "args": args}
        with self._lock:
            self.events.append(ev)

    # -------------------------------------------------------------- export --
    # Events carrying an integer ``device`` attribute (sharded serving:
    # serve.dispatch / serve.harvest / request) are routed to a synthetic
    # per-device track so Perfetto shows one swim-lane per device; offset
    # keeps the tracks clear of real thread tids.
    DEVICE_TID_BASE = 1000

    def to_chrome(self) -> dict:
        """The trace as a Chrome/Perfetto trace-event object."""
        pid = os.getpid()
        events = [{"name": sp.name, "cat": sp.cat or "span", "ph": "X",
                   "ts": (sp.t0 - self.epoch) * 1e6,
                   "dur": sp.dur * 1e6, "pid": pid, "tid": sp.tid,
                   "args": dict(sp.args)}
                  for sp in self.spans]
        events.extend(self.events)
        devices = set()
        for e in events:
            dev = e.get("args", {}).get("device")
            if isinstance(dev, int) and not isinstance(dev, bool) \
                    and dev >= 0:
                e["tid"] = self.DEVICE_TID_BASE + dev
                devices.add(dev)
        events.sort(key=lambda e: e["ts"])
        if events and events[0]["ts"] < 0:
            # a retroactive event can predate the epoch (a request
            # submitted before tracing started); shift the whole timeline
            # so every ts is non-negative — viewers and the CI trace
            # check both expect that
            shift = -events[0]["ts"]
            for e in events:
                e["ts"] += shift
        # name the device tracks (metadata "M" events carry no ts and sort
        # first in viewers regardless of position)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid,
                 "tid": self.DEVICE_TID_BASE + d,
                 "args": {"name": f"device {d}"}}
                for d in sorted(devices)]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro.obs", "pid": pid}}

    def export_chrome_trace(self, path) -> pathlib.Path:
        """Write the trace-event JSON; open the file in ``chrome://tracing``
        or https://ui.perfetto.dev."""
        out = pathlib.Path(path)
        out.write_text(json.dumps(self.to_chrome()) + "\n")
        return out


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, cat: str = "", **args):
    """Open a span on the global tracer (no-op when tracing is off)::

        with obs.span("pass.fusion", cat="compile", layers_in=12) as sp:
            ...
            sp.set(layers_out=9)
    """
    if not _TRACER.enabled:
        return NOOP_SPAN
    return Span(_TRACER, name, cat, args)


def instant(name: str, cat: str = "", **args) -> None:
    _TRACER.instant(name, cat, **args)


def complete(name: str, start_s: float, end_s: float, cat: str = "",
             **args) -> None:
    _TRACER.complete(name, start_s, end_s, cat, **args)


def export_chrome_trace(path) -> pathlib.Path:
    return _TRACER.export_chrome_trace(path)


def clear() -> None:
    _TRACER.clear()
