"""The one traffic generator: it reads a mix's parameters from
``bench/traffic/<name>.json`` and drives a serving engine with them.

Keys of a mix (all but ``loop`` optional where the loop does not use them):

  ``loop``                ``"open"`` (arrivals on a schedule, whatever the
                          engine does) or ``"closed"`` (clients that each
                          wait for their answer before they send again);
  ``rate_per_s``          open: the offered rate, fixed for the cell;
  ``deadline_ms``         open: each request's deadline, from its due time;
  ``clients_per_chip``    closed: clients per card of the cell;
  ``max_batch_per_chip``  the engine's ``max_batch`` is this times the
                          cards (rows a card takes in a full batch);
  ``scheduler``           ``"fifo"`` or ``"slo"`` (the engine's policies);
  ``shed_expired``        slo: drop queued requests past their deadline
                          (false: serve them late, counted late);
  ``pipeline_depth``      batches in flight (the engine's starting depth);
  ``pool``                distinct requests drawn from the seed, cycled.

Every seed gets the same work in another order, so that two seeds differ
no more than two runs of one seed: the open loop's gaps are one fixed set
of exponential quantiles at ``rate_per_s`` in one fixed arrangement (its
bursts and lulls), which the seed rotates; the seed also orders the
request pool and draws the requests' contents.  (Gaps shuffled anew for
each seed made the p95 of a 20 s window move by up to 35% from seed to
seed, where two runs of one seed moved by 5-10%.)
"""
from __future__ import annotations

import numpy as np

STREAM_ORDER, STREAM_GAPS = 1, 2
GAPS_ORDER_SEED = 0        # the one arrangement of gaps that seeds rotate


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` (any size of integer)."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def pool_order(n_pool: int, seed: int) -> np.ndarray:
    """The order in which requests take pool entries: a seeded permutation,
    cycled (request ``i`` takes entry ``order[i % n_pool]``)."""
    return rng(seed, STREAM_ORDER).permutation(n_pool)


def arrival_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Open-loop due times in seconds from the window's start: Poisson
    arrivals at ``rate``, as ``round(rate * seconds)`` gaps that are the
    midpoint quantiles of the exponential law, in one fixed arrangement
    (the same for every seed) rotated by a seeded amount.  Their mean is
    within 0.1% of ``1 / rate`` for a few hundred arrivals; any due time
    past the window is dropped."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = rng(GAPS_ORDER_SEED, STREAM_GAPS).permutation(
        -np.log1p(-q) / rate)
    due = np.cumsum(np.roll(gaps, int(rng(seed, STREAM_GAPS).integers(n))))
    return due[due < seconds]


def engine_kwargs(traffic: dict, chips: int) -> dict:
    """``gcv.serve`` keywords that the mix sets."""
    from repro_torch.serve.scheduler import FIFOScheduler, SLOScheduler
    name = traffic.get("scheduler", "fifo")
    if name == "slo":
        sched = SLOScheduler(
            shed_expired=bool(traffic.get("shed_expired", True)))
    elif name == "fifo":
        sched = FIFOScheduler()
    else:
        raise ValueError(f"unknown scheduler {name!r} in the traffic mix")
    kw = {"max_batch": int(traffic["max_batch_per_chip"]) * chips,
          "pipeline_depth": int(traffic.get("pipeline_depth", 2)),
          "scheduler": sched}
    if name == "slo":
        kw["slo_ms"] = float(traffic["deadline_ms"])
    return kw
