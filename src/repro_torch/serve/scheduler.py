"""Stream scheduling — the management plane of the GNN-CV serving engine.

Port of ``src/repro/serve/scheduler.py``: pure Python, copied with its
imports rewritten.

Continuous batching splits the engine the way LLM serving backends split a
management plane from the execution backend: ``Scheduler.pick`` decides
*what to dispatch next* — which ``(task, take, bucket)`` — while the engine
keeps the execution-backend duties (pad, shard-place, launch, harvest).
The scheduler sees only queue state and the engine's latency estimator
(``estimate_batch_seconds``: Step-4b analytic plan cost as the cold start,
live per-(task, bucket) service-time histograms once warm); it never
touches devices, so policies compose with single- and multi-device engines
alike.

Two built-in policies:

  * ``FIFOScheduler`` — the closed-batch schedule, verbatim: serve
    the task whose front request has waited longest, take everything
    queued behind it up to ``max_batch``.  Deadlines and priorities are
    carried but ignored.  ``engine.run()`` under this policy is
    bit-for-bit the pre-stream engine — continuous batching degenerates
    to batch draining.
  * ``SLOScheduler`` — deadline goodput: expired queued requests are shed
    before they can waste a dispatch, then the dispatch with the least
    *service-corrected slack* wins — ``slack = earliest deadline in the
    candidate batch - now - estimated batch service time`` (EDF with a
    marginal-latency correction, so a cheap-but-urgent b1 batch beats an
    expensive b3 batch whose deadline is nominally earlier than b1's
    deadline plus b1's service time).  ``priority`` trumps slack;
    arrival order (front rid) breaks ties, so equal-slack traffic keeps
    the FIFO no-starvation property.

Custom policies subclass ``Scheduler`` and are passed to
``gcv.serve(..., scheduler=)``.  ``pick`` returning ``None`` means
"dispatch nothing now"; with ``draining=True`` the engine has no more
arrivals coming, so a deferring policy must eventually drain.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

from repro_torch import obs

__all__ = ["Decision", "Scheduler", "FIFOScheduler", "SLOScheduler",
           "resolve_scheduler"]


@dataclasses.dataclass(frozen=True)
class Decision:
    """One scheduling decision: dispatch ``take`` requests of ``task``
    through the ``bucket``-sized runner.  ``slack_ms`` (service-corrected
    slack of the winning batch, ``None`` for deadline-free picks) and
    ``reason`` feed the per-decision ``serve.schedule`` span."""
    task: str
    take: int
    bucket: int
    slack_ms: float | None = None
    reason: str = ""


class Scheduler:
    """Policy interface.  ``pick`` must not pop requests — the engine pops
    exactly ``decision.take`` from the front of ``queues[decision.task]``
    — but admission-side mutation (shedding expired requests via
    ``engine.shed_expired()``) is the management plane's prerogative."""

    name = "base"

    def pick(self, engine, *, draining: bool = False) -> Decision | None:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class FIFOScheduler(Scheduler):
    """Oldest-head-first — the closed-batch schedule as a degenerate
    policy.  Kept logic-identical to the old inline dispatch pick so the
    default engine stays output-identical: serve the task whose *front*
    request has the smallest rid (arrived earliest), coalescing everything
    queued behind it up to ``max_batch``."""

    name = "fifo"

    def pick(self, engine, *, draining: bool = False) -> Decision | None:
        ready = [t for t, q in engine.queues.items() if q]
        if not ready:
            return None
        task = min(ready, key=lambda t: engine.queues[t][0].rid)
        take = min(len(engine.queues[task]), engine.max_batch)
        return Decision(task, take, engine._bucket(take, engine.max_batch),
                        reason="oldest-head-first")


class SLOScheduler(Scheduler):
    """Deadline-goodput scheduling: shed expired work, then EDF corrected
    by the marginal-latency estimate (see module docstring).

    ``shed_expired=False`` keeps expired requests in the queues (they will
    be served late and counted as misses) — useful when late answers still
    have value.
    """

    name = "slo"

    def __init__(self, *, shed_expired: bool = True):
        self.shed_expired = shed_expired

    def pick(self, engine, *, draining: bool = False) -> Decision | None:
        now = obs.now()
        if self.shed_expired:
            engine.shed_expired(now)
        best_key, best = None, None
        for task, q in engine.queues.items():
            if not q:
                continue
            take = min(len(q), engine.max_batch)
            bucket = engine._bucket(take, engine.max_batch)
            est = engine.estimate_batch_seconds(task, bucket)
            window = list(itertools.islice(q, take))
            deadlines = [r.deadline_s for r in window
                         if r.deadline_s is not None]
            slack = min(deadlines) - now - est if deadlines else math.inf
            prio = max(r.priority for r in window)
            key = (-prio, slack, q[0].rid)
            if best_key is None or key < best_key:
                best_key = key
                best = Decision(
                    task, take, bucket,
                    slack_ms=None if slack is math.inf else slack * 1e3,
                    reason="min-slack" if deadlines else "no-deadline")
        return best

    def __repr__(self):
        return f"SLOScheduler(shed_expired={self.shed_expired})"


def resolve_scheduler(spec, *, slo_ms: float | None) -> Scheduler:
    """``None`` picks the policy matching the engine's configuration
    (SLO configured -> SLO-aware, else the FIFO degenerate schedule);
    strings name the built-ins; ``Scheduler`` instances pass through."""
    if spec is None:
        return SLOScheduler() if slo_ms is not None else FIFOScheduler()
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, str):
        policies = {"fifo": FIFOScheduler, "slo": SLOScheduler}
        assert spec in policies, \
            f"unknown scheduler {spec!r} — one of {sorted(policies)}, " \
            f"or a Scheduler instance"
        return policies[spec]()
    raise TypeError(f"scheduler= takes a name or a Scheduler, "
                    f"got {type(spec).__name__}")
