"""The measured window: the open and the closed loop over a serving
engine's ``submit`` / ``poll``, timed on the benchmark's own clock.
``at_close`` is called as the window closes, before the answers still in
flight are drained.

Every request is stamped by the benchmark: when it was due (open loop:
its place in the schedule; closed loop: when its client sent it), when
``submit`` took it, and when its scores were on the host, which is the
return of the ``poll`` that harvested it.  The engine's own
``TaskRequest.t_dispatch`` is read for the queue wait.  Host spans
(``submit``, ``poll/dispatch``, ``poll/harvest``, ``poll/idle``) are
kept only while the device trace records, to label its idle gaps.
"""
from __future__ import annotations

import dataclasses
import time

from gcvbench import traffic as gen

clock = time.perf_counter
DRAIN_S = 60.0        # an answer may come this long after the window closes


@dataclasses.dataclass
class Window:
    t0: float = 0.0                 # the window opens
    t_end: float = 0.0              # and closes
    pool_idx: list = dataclasses.field(default_factory=list)
    t_due: list = dataclasses.field(default_factory=list)
    t_submit: list = dataclasses.field(default_factory=list)
    t_done: list = dataclasses.field(default_factory=list)  # nan: no answer
    reqs: list = dataclasses.field(default_factory=list)
    busy_poll_s: float = 0.0        # in polls of the window that
                                    # dispatched or harvested
    spans: list = dataclasses.field(default_factory=list)
    drained: bool = True            # every request got its answer


class _Driver:
    def __init__(self, eng, task, pool, order, tracer, deadline_ms=None):
        self.eng, self.task, self.pool, self.order = eng, task, pool, order
        self.tracer = tracer
        self.deadline_ms = deadline_ms
        self.win = Window()
        self.outstanding: list[int] = []      # indices into win lists
        self.sent = 0

    def submit(self, due: float) -> None:
        k = self.order[self.sent % len(self.order)]
        self.sent += 1
        t_a = clock()
        kw = {}
        if self.deadline_ms is not None:
            # the deadline runs from the due time: a late submit has less
            # of it left (never none, so the engine takes the request and
            # its answer counts late rather than refused)
            kw["deadline_ms"] = max(self.deadline_ms - (t_a - due) * 1e3,
                                    1e-3)
        req = self.eng.submit(self.task, **kw, **self.pool[k])
        t_b = clock()
        w = self.win
        self.outstanding.append(len(w.reqs))
        w.pool_idx.append(int(k))
        w.t_due.append(due)
        w.t_submit.append(t_a)
        w.t_done.append(float("nan"))
        w.reqs.append(req)
        if self.tracer.recording(t_a):
            w.spans.append((t_a, t_b, "submit"))

    def poll(self, draining: bool) -> list[int]:
        """One ``poll``; returns the indices of requests it finished."""
        t_a = clock()
        dispatched, harvested = self.eng.poll(draining=draining)
        t_b = clock()
        w = self.win
        finished = []
        if harvested or not (self.eng.pending() or self.eng.inflight()):
            keep = []
            for i in self.outstanding:
                if w.reqs[i].done:
                    w.t_done[i] = t_b
                    finished.append(i)
                else:
                    keep.append(i)
            self.outstanding = keep
        if (dispatched or harvested) and w.t0 <= t_a < w.t_end:
            w.busy_poll_s += t_b - t_a
        if self.tracer.recording(t_a):
            label = ("poll/dispatch" if dispatched else
                     "poll/harvest" if harvested else "poll/idle")
            w.spans.append((t_a, t_b, label))
        return finished

    def drain(self) -> None:
        """After the window: every answer, for at most ``DRAIN_S``."""
        limit = clock() + DRAIN_S
        while self.outstanding and clock() < limit:
            self.poll(draining=True)
        self.win.drained = not self.outstanding


def run_open(eng, task, pool, traffic, seed, seconds, tracer, at_open,
             at_close) -> Window:
    """Poisson arrivals at the mix's fixed rate, each submitted when the
    loop reaches its due time and timed from that due time."""
    offsets = gen.arrival_offsets(float(traffic["rate_per_s"]), seconds,
                                  seed)
    d = _Driver(eng, task, pool, gen.pool_order(len(pool), seed), tracer,
                deadline_ms=float(traffic["deadline_ms"]))
    w = d.win
    w.t0 = clock()
    w.t_end = w.t0 + seconds
    tracer.arm(w.t_end)
    at_open()
    due = w.t0 + offsets
    i, n = 0, len(due)
    while True:
        now = clock()
        while i < n and due[i] <= now:
            d.submit(float(due[i]))
            i += 1
        tracer.tick(now)
        if now >= w.t_end and i >= n:
            break
        d.poll(draining=False)
    tracer.tick(clock())
    at_close()
    d.drain()
    return w


def run_closed(eng, task, pool, traffic, seed, seconds, tracer, chips,
               at_open, at_close) -> Window:
    """``clients_per_chip * chips`` clients, each sending its next request
    as soon as its last answer is on the host, until the window closes."""
    clients = int(traffic["clients_per_chip"]) * chips
    d = _Driver(eng, task, pool, gen.pool_order(len(pool), seed), tracer)
    w = d.win
    w.t0 = clock()
    w.t_end = w.t0 + seconds
    tracer.arm(w.t_end)
    at_open()
    for _ in range(clients):
        d.submit(clock())
    while True:
        now = clock()
        tracer.tick(now)
        if now >= w.t_end:
            break
        for _ in d.poll(draining=False):
            if clock() < w.t_end:
                d.submit(clock())
    at_close()
    d.drain()
    return w
