"""Micro-batching request engine for the GNN-CV task family.

Port of ``src/repro/serve/gnncv.py``.  The LM
``ServeEngine`` batches homogeneous decode steps over slots; GNN-CV
inference is the opposite shape of problem — each request is one
whole-program execution of a *heterogeneous* task, so the batching axis is
requests-per-compiled-plan, not tokens-per-slot:

  * requests queue per task; a pluggable scheduler (``serve/scheduler.py``)
    picks each next ``(task, take, bucket)`` dispatch — oldest head first
    (``"fifo"``) or by service-corrected deadline slack (``"slo"``) — and
    the engine drains that many requests through the task's batched
    runner (``CompiledModel.batched(N, jit=True)``: one CUDA-graph replay
    per batch);
  * batch sizes are quantized to power-of-two buckets (short batches are
    padded by repeating the tail request), so the runner cache holds at
    most log2(max_batch)+1 runners per task; ``warmup()`` builds and
    captures every (task, bucket) runner before traffic, after which
    ``stats()['runner_misses']`` freezes;
  * serving is **pipelined**.  A dispatch stages its batch into a
    page-locked host slot, then on the engine's one serving stream copies
    it to the card without waiting for earlier batches, replays the
    bucket's graph, copies each output back into the slot's page-locked
    output buffer (one copy per output name) and records a
    ``torch.cuda.Event`` — and returns before the card has run any of it.
    ``harvest()`` waits on the oldest batch's event and slices per request
    on the host; ``poll()`` harvests only batches whose event has passed
    (``event.query()``, the reference's ``jax.Array.is_ready``).  A slot
    returns to its (task, bucket)'s free list only when its batch is
    harvested, so it is never rewritten while a copy may still read it.
    Every replay of a graph and the copies around it run on the one
    serving stream, in order: two in-flight batches of one bucket never
    share a buffer.  ``pipeline_depth`` bounds the in-flight batches
    (depth 1 is the synchronous step); under a configured ``slo_ms`` it
    adapts within ``[1, max_pipeline_depth]``;
  * **variable topology** — a task served with ``graph_buckets=`` compiles
    one plan per node count (virtual tasks ``task@g{size}``); ``submit``
    zero-pads each request's node-indexed inputs to the smallest bucket
    that fits and rejects one above the largest with a ``ValueError`` at
    admission;
  * with ``devices=``/``mesh=`` the engine serves over a 1-D ``data``
    mesh: every bucketed runner shards its batch axis over the mesh's
    entries (each with a replica of the weights, its graphs and a stream
    of its own; ``core/executor.py``), buckets stay powers of two but
    never drop below the device count, and positions are placed
    round-robin (position j on device j % ndev) so pad waste spreads
    evenly — ``stats()['pad_per_device']`` accounts for it per device.
    Each batch takes a block of rows on every device, so the per-device
    in-flight queues advance in lockstep and ``pipeline_depth`` bounds
    each device's queue.  The engine's serving stream lives on the mesh's
    first device; each replica's stream waits on it before its copies and
    replay, and it waits on every replica before the outputs come back.
    A one-device mesh is exactly the one-device engine.

On the CPU (``device="cpu"``) a dispatch runs its batch to the end before
it returns (the plain versions run eagerly), so every batch is ready when
``poll`` looks.  Nothing here falls back: a failed kernel build or launch
inside a batch propagates from ``dispatch``.

``stats()`` reads the engine's own ``obs.MetricsRegistry`` (zero-safe:
percentiles are None until a request has been harvested) plus the process
plan/runner cache counters; with tracing on each dispatch and harvest is a
span, plus one retroactive span per request.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compiler import CompileOptions
from repro_torch.core.executor import stack_inputs
from repro_torch.core.ir import Graph
from repro_torch.core.plan import ExecutionPlan

__all__ = ["GNNCVServeEngine", "TaskRequest"]


@dataclasses.dataclass
class TaskRequest:
    rid: int
    task: str
    inputs: dict                       # per-sample input arrays, unstacked
    result: tuple | None = None        # tuple of np outputs once done
    done: bool = False
    t_submit: float = 0.0              # obs.now() at intake
    t_dispatch: float = 0.0            # obs.now() when its batch launched
    t_done: float = 0.0                # obs.now() when harvested
    deadline_s: float | None = None    # absolute obs.now() deadline
    priority: int = 0                  # higher dispatches first (SLO policy)
    missed_deadline: bool = False      # finished after deadline_s (or shed)
    shed: bool = False                 # dropped unserved (result stays None)


@dataclasses.dataclass
class _BatchInfo:
    """Identity of one in-flight dispatch, carried to harvest (and into
    the trace) so per-request spans can say which batch served them."""
    batch_id: int
    task: str
    bucket: int
    pad: int
    t_dispatch: float
    devices: int = 1
    # row placement under sharding: padded position j sits at stacked row
    # rows[j]; empty tuple = identity (one device)
    rows: tuple = ()
    shard_n: tuple = ()                # real requests per device
    pad_per_dev: tuple = ()            # pad rows per device


@dataclasses.dataclass
class _Slot:
    """Page-locked staging of one in-flight batch on the card: the stacked
    inputs (``name -> tensor``) and, once the first batch through it has
    run, one buffer per output."""
    inputs: dict
    outputs: list | None = None


@dataclasses.dataclass
class _Pending:
    """One dispatched batch: its host outputs, ready once ``event`` has
    passed (no event on the CPU, where they are ready at once), and the
    staging slot to hand back at harvest."""
    outputs: list
    event: torch.cuda.Event | None = None
    slot: _Slot | None = None


class GNNCVServeEngine:
    """Queue heterogeneous task requests, drain them in per-plan batches.

    Constructed by (and from) the ``repro_torch.gcv`` façade: ``models``
    maps task name -> a ``CompiledModel``, a layer ``Graph`` or an
    ``ExecutionPlan``.  Everything not already compiled goes through
    ``gcv.compile`` with this engine's options on its ``device`` (None:
    the card, raising without one) and mesh; pre-compiled models keep
    their own options and must live on that device and have been compiled
    over the *same* mesh — a model sharded differently from the engine's
    dispatch placement would misattribute rows to devices.
    ``devices=``/``mesh=`` select the batch-sharded path (module
    docstring).
    """

    def __init__(self, models=None, *,
                 options: CompileOptions = CompileOptions(),
                 max_batch: int = 8, jit: bool = True,
                 pipeline_depth: int = 2, residency: bool = True,
                 devices=None, mesh=None, slo_ms: float | None = None,
                 scheduler=None, max_pipeline_depth: int | None = None,
                 graph_buckets=None, device=None):
        from repro_torch import gcv             # late: gcv builds engines
        from repro_torch.serve.scheduler import resolve_scheduler
        assert models, "GNNCVServeEngine needs at least one model"
        self.device, self.mesh = gcv._resolve_mesh(devices, mesh, device)
        ndev = self.mesh.size if self.mesh is not None else 1
        self._ndev = ndev
        models = dict(models)
        # graph_buckets maps a task name to the node counts it serves at;
        # the task's ``models`` entry is then a factory n_nodes -> model
        # spec, compiled per size under the virtual task ``task@g{size}``.
        self.graph_buckets: dict[str, list[int]] = {
            t: sorted({int(s) for s in ss})
            for t, ss in dict(graph_buckets or {}).items()}
        for task, sizes in self.graph_buckets.items():
            assert task in models, \
                f"graph_buckets names unknown task {task!r}"
            assert sizes and sizes[0] >= 1, \
                f"task {task!r}: graph bucket sizes must be >= 1, " \
                f"got {sizes}"
            factory = models.pop(task)
            assert callable(factory) \
                and not isinstance(factory, (tuple, Graph, ExecutionPlan,
                                             gcv.CompiledModel)), \
                f"task {task!r} has graph_buckets — its models entry " \
                f"must be a factory n_nodes -> model spec, got " \
                f"{type(factory).__name__}"
            for g in sizes:
                models[f"{task}@g{g}"] = factory(g)
        self.options = options
        assert max_batch >= 1 and max_batch & (max_batch - 1) == 0, \
            f"max_batch must be a power of two, got {max_batch}"
        # every bucket must shard evenly; divisors of a power of two are
        # powers of two, so this also pins the device count to 1, 2, 4, ...
        assert max_batch % ndev == 0, \
            f"max_batch={max_batch} must be divisible by the device " \
            f"count ({ndev}) so every bucket shards evenly"
        assert jit or ndev == 1, \
            "multi-device serving shards through jitted programs — " \
            "jit=False is single-device only"
        assert pipeline_depth >= 1, \
            f"pipeline_depth must be >= 1, got {pipeline_depth}"
        assert slo_ms is None or slo_ms > 0, \
            f"slo_ms must be positive, got {slo_ms}"
        self.max_batch = max_batch
        self.jit = jit
        self.pipeline_depth = pipeline_depth   # configured starting depth
        self.slo_ms = slo_ms
        self.scheduler = resolve_scheduler(scheduler, slo_ms=slo_ms)
        # adaptive-depth ceiling: a fixed-depth engine by default, headroom
        # to deepen once an SLO makes the throughput/sojourn trade
        # measurable
        if max_pipeline_depth is None:
            max_pipeline_depth = pipeline_depth if slo_ms is None \
                else max(pipeline_depth, 4)
        assert max_pipeline_depth >= pipeline_depth, \
            f"max_pipeline_depth={max_pipeline_depth} must be >= " \
            f"pipeline_depth={pipeline_depth}"
        self.max_pipeline_depth = max_pipeline_depth
        self._depth = pipeline_depth           # current adaptive depth
        self.residency = residency
        self.models: dict[str, gcv.CompiledModel] = {}
        for task, model in models.items():
            if isinstance(model, gcv.CompiledModel):
                assert model.device == self.device, \
                    f"task {task!r}: pre-compiled for {model.device}, the " \
                    f"engine serves on {self.device}"
                assert model.mesh == self.mesh, \
                    f"task {task!r}: pre-compiled model mesh " \
                    f"{model.mesh} does not match the engine's " \
                    f"{self.mesh} — compile it with the same devices=/" \
                    f"mesh=, or hand the engine its graph/plan instead"
                self.models[task] = model
            else:
                fn, example = model if isinstance(model, tuple) \
                    else (model, None)
                self.models[task] = gcv.compile(
                    fn, example, options=options, residency=residency,
                    device=self.device, mesh=self.mesh)
        self.plans = {t: m.plan for t, m in self.models.items()}
        self.queues: dict[str, deque] = {t: deque() for t in self.models}
        self._rid = itertools.count()
        self._inflight: deque[tuple[list[TaskRequest], _Pending,
                                    _BatchInfo]] = deque()
        # per-device dispatch queues: every batch takes a block of rows on
        # every device, so each deque mirrors the master _inflight and
        # pipeline_depth bounds each device's queue (== the master's depth)
        self._dev_inflight: list[deque] = [deque() for _ in range(ndev)]
        self._warmed: set[tuple[str, int]] = set()
        # the one serving stream: every replay and the copies around it
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._slots: dict[tuple[str, int], list[_Slot]] = {}
        # Engine-owned instruments — stats() reads these, never its own
        # tallies, so two engines in one process never mix their counts.
        self.metrics = obs.MetricsRegistry()
        self._c_submitted = self.metrics.counter("submitted")
        self._c_completed = self.metrics.counter("completed")
        self._c_dispatches = self.metrics.counter("dispatches")
        self._c_padded = self.metrics.counter("padded")
        self._c_pad_dev = [self.metrics.counter(f"padded.device{d}")
                           for d in range(ndev)]
        # dispatches that returned before the card had finished their batch
        self._c_ahead = self.metrics.counter("dispatch_returned_ahead")
        self._h_sojourn = self.metrics.histogram("sojourn_ms")
        self._h_queue = self.metrics.histogram("queue_ms")
        # short window for depth adaptation: the all-history histogram is
        # sticky (an early overload would depress p95 reactions forever)
        self._h_sojourn_recent = self.metrics.histogram(
            "sojourn_recent_ms", maxlen=256)
        self._c_goodput = self.metrics.counter("goodput")
        self._c_misses = self.metrics.counter("deadline_misses")
        self._c_shed = self.metrics.counter("shed")
        self._c_expired = self.metrics.counter("expired_at_submit")
        self._g_queue = self.metrics.gauge("queue_depth")
        self.metrics.gauge("pipeline_depth").set(self._depth)
        self._plan_cost: dict[str, float] = {}
        self._t_first_dispatch: float | None = None
        self._t_last_harvest: float | None = None

    # ------------------------------------------------- graph-size buckets --
    def _node_inputs(self, task: str) -> list[str]:
        """Input names carrying the graph's node axis: those whose leading
        dimension equals the graph-bucket size in the compiled plan (for
        ``b6-dyn``: ``points (N, 3)`` and ``mask (N,)``).  These are the
        inputs ``_pad_to_graph_bucket`` zero-pads; a model served this way
        takes a validity mask so padded nodes are inert."""
        g0 = self.graph_buckets[task][0]
        shapes = self.plans[f"{task}@g{g0}"].meta["input_shapes"]
        names = [n for n, s in shapes.items() if s and s[0] == g0]
        assert names, \
            f"task {task!r}: no input has the graph-size leading axis"
        return names

    def _pad_to_graph_bucket(self, task: str, inputs: dict
                             ) -> tuple[str, dict]:
        """Route one variable-size request to its graph bucket: read the
        node count off the node-indexed inputs, zero-pad them up to the
        smallest bucket that fits, and return the virtual task key the
        request queues under (a ``graph.build`` span; per-bucket
        ``graph.{task}.g{size}`` counters feed ``stats()``)."""
        sizes = self.graph_buckets[task]
        node_inputs = self._node_inputs(task)
        ns = {int(np.shape(inputs[name])[0])
              for name in node_inputs if name in inputs}
        if len(ns) != 1:
            raise ValueError(
                f"task {task!r}: node-indexed inputs {node_inputs} "
                f"disagree on the node count ({sorted(ns)})")
        n = ns.pop()
        if n < 1:
            raise ValueError(f"task {task!r}: request has {n} nodes")
        if n > sizes[-1]:
            raise ValueError(
                f"task {task!r}: request has {n} nodes but the largest "
                f"graph bucket is {sizes[-1]} (buckets: {sizes}) — "
                f"serve it with a larger graph_buckets entry or split "
                f"the request")
        g = next(s for s in sizes if s >= n)
        with obs.span("graph.build", cat="serve", task=task, n_nodes=n,
                      graph_bucket=g, pad_nodes=g - n):
            if g != n:
                padded = dict(inputs)
                for name in node_inputs:
                    if name not in inputs:
                        continue       # submit reports the missing input
                    v = np.asarray(inputs[name])
                    padded[name] = np.concatenate(
                        [v, np.zeros((g - n,) + v.shape[1:], v.dtype)])
                inputs = padded
        self.metrics.counter(f"graph.{task}.g{g}.submitted").inc()
        if g != n:
            self.metrics.counter(f"graph.{task}.g{g}.pad_nodes").inc(g - n)
        return f"{task}@g{g}", inputs

    # ------------------------------------------------------------ intake --
    def submit(self, task: str, *, deadline_ms: float | None = None,
               priority: int = 0, **inputs) -> TaskRequest:
        """Validated intake: a malformed request is rejected here, where it
        can only hurt its own caller — inside ``dispatch`` it would take a
        whole popped batch down with it.

        ``deadline_ms`` is relative to now (default: the engine's
        ``slo_ms``); ``priority`` breaks scheduling ties under the SLO
        policy (higher first).  A request whose deadline has already
        passed is admission-rejected: returned ``done`` with
        ``result=None``, ``missed_deadline`` set, counted under
        ``expired_at_submit``.  A task with ``graph_buckets`` takes
        variable-size requests (``_pad_to_graph_bucket``); one over the
        largest bucket is a ``ValueError`` here."""
        if task in self.graph_buckets:
            task, inputs = self._pad_to_graph_bucket(task, inputs)
        assert task in self.models, f"unknown task {task!r}"
        plan = self.plans[task]
        missing = set(plan.input_names) - inputs.keys()
        extra = inputs.keys() - set(plan.input_names)
        assert not missing and not extra, \
            f"task {task!r}: missing inputs {sorted(missing)}, " \
            f"unexpected inputs {sorted(extra)}"
        shapes = plan.meta["input_shapes"]
        for name, value in inputs.items():
            got = tuple(np.shape(value))
            want = tuple(shapes[name])
            assert got == want, \
                f"task {task!r}, input {name!r}: expected per-sample " \
                f"shape {want}, got {got}"
        t = obs.now()
        if deadline_ms is None:
            deadline_ms = self.slo_ms
        deadline_s = None if deadline_ms is None else t + deadline_ms / 1e3
        req = TaskRequest(next(self._rid), task, inputs, t_submit=t,
                          deadline_s=deadline_s, priority=priority)
        self._c_submitted.inc()
        self.metrics.counter(f"task.{task}.submitted").inc()
        if deadline_s is not None and deadline_s <= t:
            self._c_expired.inc()
            self._finish_unserved(req, t)
            return req
        self.queues[task].append(req)
        self._g_queue.set(self.pending())
        self.metrics.gauge(f"queue_depth.{task}").set(len(self.queues[task]))
        return req

    def _finish_unserved(self, req: TaskRequest, now: float) -> None:
        """Terminal state for a request dropped without execution (expired
        at submit, or shed from a queue): done, no result, a miss."""
        req.done = True
        req.shed = True
        req.missed_deadline = True
        req.t_done = now
        self._c_misses.inc()
        self.metrics.counter(f"task.{req.task}.deadline_misses").inc()

    def shed_expired(self, now: float | None = None) -> int:
        """Drop queued requests whose deadline has already passed; called
        by the SLO scheduler before each pick.  Returns the number shed."""
        now = obs.now() if now is None else now
        shed = 0
        for task, q in self.queues.items():
            if not q or not any(r.deadline_s is not None
                                and r.deadline_s <= now for r in q):
                continue
            keep: deque = deque()
            for r in q:
                if r.deadline_s is not None and r.deadline_s <= now:
                    self._finish_unserved(r, now)
                    self._c_shed.inc()
                    shed += 1
                else:
                    keep.append(r)
            self.queues[task] = keep
            self.metrics.gauge(f"queue_depth.{task}").set(len(keep))
        if shed:
            self._g_queue.set(self.pending())
        return shed

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def inflight(self) -> int:
        return sum(len(reqs) for reqs, _, _ in self._inflight)

    def inflight_per_device(self) -> list[int]:
        """In-flight batches per device track (lockstep: each batch takes
        rows on every device, so these only differ transiently)."""
        return [len(dq) for dq in self._dev_inflight]

    def stats(self) -> dict:
        """One read over the engine's metrics registry plus the process
        plan/runner-cache counters.  Always safe: before the first harvest
        the percentiles and rates are None and every counter is zero.
        After ``warmup`` a healthy engine shows ``runner_hits`` growing and
        ``runner_misses`` frozen."""
        from repro_torch.core.runtime.cache import cache_stats
        completed = self._c_completed.value
        elapsed = (self._t_last_harvest - self._t_first_dispatch
                   if completed and self._t_first_dispatch is not None
                   and self._t_last_harvest is not None else None)
        per_task = {}
        for task in self.models:
            done = self.metrics.counter(f"task.{task}.completed").value
            per_task[task] = {
                "submitted": self.metrics.counter(
                    f"task.{task}.submitted").value,
                "completed": done,
                "deadline_misses": self.metrics.counter(
                    f"task.{task}.deadline_misses").value,
                "req_per_s": done / elapsed if elapsed else None,
            }
        self.metrics.gauge("pending").set(self.pending())
        self.metrics.gauge("inflight").set(self.inflight())
        self._g_queue.set(self.pending())
        goodput = self._c_goodput.value
        misses = self._c_misses.value
        # every terminal request is goodput or a miss (shed and expired at
        # submit are misses), so the miss rate is over all finished work
        finished = goodput + misses
        graph_stats = {
            task: {g: {
                "submitted": self.metrics.counter(
                    f"graph.{task}.g{g}.submitted").value,
                "pad_nodes": self.metrics.counter(
                    f"graph.{task}.g{g}.pad_nodes").value,
            } for g in sizes}
            for task, sizes in self.graph_buckets.items()}
        return {"completed": completed, "steps": self._c_dispatches.value,
                "graph_buckets": graph_stats,
                "submitted": self._c_submitted.value,
                "pending": self.pending(), "inflight": self.inflight(),
                "tasks": len(self.models), "warmed": len(self._warmed),
                "padded": self._c_padded.value,
                "devices": self._ndev,
                "pad_per_device": [c.value for c in self._c_pad_dev],
                "inflight_per_device": self.inflight_per_device(),
                "scheduler": self.scheduler.name,
                "slo_ms": self.slo_ms,
                "pipeline_depth": self._depth,
                "max_pipeline_depth": self.max_pipeline_depth,
                "goodput": goodput,
                "deadline_misses": misses,
                "shed": self._c_shed.value,
                "expired_at_submit": self._c_expired.value,
                "deadline_miss_rate": (misses / finished if finished
                                       else None),
                "goodput_req_per_s": (goodput / elapsed if elapsed
                                      else None),
                "p50_sojourn_ms": self._h_sojourn.percentile(50),
                "p95_sojourn_ms": self._h_sojourn.percentile(95),
                "p50_queue_ms": self._h_queue.percentile(50),
                "p95_queue_ms": self._h_queue.percentile(95),
                "req_per_s": (completed / elapsed if elapsed else None),
                "per_task": per_task,
                **cache_stats()}

    def _bucket(self, n: int, cap: int) -> int:
        b = self._ndev            # floor: at least one row per device
        while b < n and b < cap:
            b *= 2
        return min(b, cap)

    def buckets(self) -> list[int]:
        """Every batch size the engine can dispatch: powers of two from
        the device count (each device needs at least one row) up to
        ``max_batch``."""
        out, b = [], self._ndev
        while b <= self.max_batch:
            out.append(b)
            b *= 2
        return out

    # --------------------------------------------------------- estimation --
    def _plan_cost_seconds(self, task: str) -> float:
        """Per-sample cost of one task: the Step-4b seconds of every op's
        chosen kernel (measured where the plan was compiled in measured
        mode, the H100 model's prediction otherwise), summed over the plan.
        The scheduler's cold-start estimate; clamped positive."""
        cached = self._plan_cost.get(task)
        if cached is None:
            total = 0.0
            for c in self.plans[task].meta.get("kernel_choices",
                                               {}).values():
                src = c.get("measured_s") or c.get("predicted_s") or {}
                total += src.get(c.get("kernel"), 0.0)
            cached = self._plan_cost[task] = max(total, 1e-9)
        return cached

    def estimate_batch_seconds(self, task: str, bucket: int) -> float:
        """Marginal-latency estimate for one (task, bucket) dispatch: the
        recent mean of that bucket's measured service times once it has
        served traffic, the plan cost scaled by the bucket before that."""
        h = self.metrics.histogram(f"service_ms.{task}.b{bucket}")
        recent = h.recent_mean(32)
        if recent is not None:
            return recent / 1e3
        return self._plan_cost_seconds(task) * bucket

    def _adapt_depth(self) -> int:
        """One adaptive-depth step, bounded to [1, max_pipeline_depth]:
        deepen while the backlog outgrows the in-flight window; under an
        SLO, shrink when recent p95 sojourn nears it and refuse to deepen
        past half of it.  Fixed-depth engines never move."""
        if self.max_pipeline_depth > 1:
            grow = self.pending() > self._depth * self.max_batch
            p95 = self._h_sojourn_recent.percentile(95)
            if self.slo_ms is not None and p95 is not None \
                    and p95 >= 0.8 * self.slo_ms:
                self._depth = max(1, self._depth - 1)
            elif grow and (self.slo_ms is None or p95 is None
                           or p95 < 0.5 * self.slo_ms):
                self._depth = min(self.max_pipeline_depth, self._depth + 1)
            self.metrics.gauge("pipeline_depth").set(self._depth)
        return self._depth

    def _runner(self, task: str, bucket: int):
        return self.models[task].batched(bucket, jit=self.jit)

    @staticmethod
    def _stack(samples: list[dict]) -> dict:
        """Batch assembly off the card (host-side ``np.stack``)."""
        return stack_inputs(samples)

    # ----------------------------------------------------- staging slots --
    def _take_slot(self, task: str, bucket: int) -> _Slot:
        """A free page-locked staging slot of ``(task, bucket)``, a new one
        when every slot is in flight."""
        free = self._slots.setdefault((task, bucket), [])
        if free:
            return free.pop()
        specs = self._runner(task, bucket).input_specs()
        return _Slot({name: torch.empty(shape, dtype=dtype, pin_memory=True)
                      for name, (shape, dtype) in specs.items()})

    def _stage(self, samples: list[dict], slot: _Slot) -> None:
        """Stack the batch into the slot's page-locked inputs."""
        for name, buf in slot.inputs.items():
            np.stack([np.asarray(s[name]) for s in samples],
                     out=buf.numpy(), casting="same_kind")

    # ------------------------------------------------------------ warmup --
    def warmup(self, tasks=None, buckets=None) -> set[tuple[str, int]]:
        """Build and capture every (task, bucket) runner before traffic
        arrives, and give each (task, bucket) one staging slot on the card.

        Each runner is built (the only ``runner_misses`` a healthy server
        records) and its request captured as a CUDA graph from the plan's
        recorded input shapes (``run.aot_compile()``), so no live request
        pays a build or a capture.  Returns the (task, bucket) pairs now
        captured; on the CPU (nothing to capture) the set stays empty.
        """
        tasks = list(self.models) if tasks is None else list(tasks)
        buckets = self.buckets() if buckets is None else list(buckets)
        for task in tasks:
            assert task in self.models, f"unknown task {task!r}"
            for bucket in buckets:
                with obs.span("serve.warmup", cat="serve", task=task,
                              bucket=bucket):
                    run = self._runner(task, bucket)
                    if run.aot_compile() is not None:
                        self._warmed.add((task, bucket))
                    if self._stream is not None \
                            and not self._slots.get((task, bucket)):
                        self._slots.setdefault((task, bucket), []).append(
                            self._take_slot(task, bucket))
        return set(self._warmed)

    # ---------------------------------------------------------- dispatch --
    def dispatch(self, *, draining: bool = False) -> int:
        """Launch one batch without waiting for its results; returns the
        number of requests dispatched (0 when the scheduler has nothing to
        run).

        *What* to launch is the scheduler's decision (one ``Decision`` per
        call, traced as a ``serve.schedule`` span).  On the card the batch
        is staged, copied, replayed and copied back on the serving stream
        behind the batches already in flight, and an event marks its end
        (module docstring); the host returns as soon as it is enqueued.

        Under a mesh, requests are placed round-robin across the device
        shards: padded position ``j`` lands on device ``j % ndev``, and
        since the runner splits the stacked batch into contiguous blocks of
        ``bucket // ndev`` rows, ``j``'s stacked row is ``(j % ndev) *
        (bucket // ndev) + j // ndev``.  Pad positions (``take..bucket-1``)
        thereby spread (near-)evenly across devices."""
        with obs.span("serve.schedule", cat="serve",
                      policy=self.scheduler.name, pending=self.pending(),
                      inflight=len(self._inflight),
                      depth=self._depth) as sp:
            d = self.scheduler.pick(self, draining=draining)
            if d is not None:
                sp.set(task=d.task, take=d.take, bucket=d.bucket,
                       reason=d.reason)
                if d.slack_ms is not None:
                    sp.set(slack_ms=round(d.slack_ms, 3))
        if d is None:
            return 0
        task, take, bucket = d.task, d.take, d.bucket
        queue = self.queues[task]
        assert 1 <= take <= len(queue) and take <= bucket <= self.max_batch, \
            f"scheduler decision {d} invalid for queue of {len(queue)}"
        reqs = [queue.popleft() for _ in range(take)]
        self._g_queue.set(self.pending())
        self.metrics.gauge(f"queue_depth.{task}").set(len(queue))
        padded = reqs + [reqs[-1]] * (bucket - take)
        ndev = self._ndev
        rows = tuple((j % ndev) * (bucket // ndev) + j // ndev
                     for j in range(bucket))      # identity when ndev == 1
        samples: list = [None] * bucket
        for j, r in enumerate(rows):
            samples[r] = padded[j].inputs
        shard_n = tuple(sum(1 for j in range(take) if j % ndev == d)
                        for d in range(ndev))
        pad_per_dev = tuple(sum(1 for j in range(take, bucket)
                                if j % ndev == d) for d in range(ndev))
        t0 = obs.now()
        info = _BatchInfo(self._c_dispatches.value, task, bucket,
                          bucket - take, t0, devices=ndev, rows=rows,
                          shard_n=shard_n, pad_per_dev=pad_per_dev)
        run = self._runner(task, bucket)
        if self._stream is None:
            outs = run(**self._stack(samples))
            pending = _Pending([o.numpy() for o in outs])
        else:
            slot = self._take_slot(task, bucket)
            self._stage(samples, slot)
            with torch.cuda.stream(self._stream):
                outs = run(**slot.inputs)
                if slot.outputs is None:
                    slot.outputs = [torch.empty(o.shape, dtype=o.dtype,
                                                pin_memory=True)
                                    for o in outs]
                for host, o in zip(slot.outputs, outs):
                    host.copy_(o, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            if not event.query():
                self._c_ahead.inc()
            pending = _Pending([h.numpy() for h in slot.outputs], event,
                               slot)
        t1 = obs.now()
        if obs.enabled():
            # one retroactive dispatch span per device track (exactly one
            # on a one-device engine): the global batch identity plus this
            # shard's real-row/pad split
            for d in range(ndev):
                obs.complete("serve.dispatch", t0, t1, cat="serve",
                             task=task, bucket=bucket,
                             batch_id=info.batch_id, n=take, pad=info.pad,
                             device=d, shard_n=shard_n[d],
                             shard_pad=pad_per_dev[d])
        if self._t_first_dispatch is None:
            self._t_first_dispatch = info.t_dispatch
        for r in reqs:
            r.t_dispatch = info.t_dispatch
        self._inflight.append((reqs, pending, info))
        for dq in self._dev_inflight:
            dq.append(info)
        self._c_dispatches.inc()
        self._c_padded.inc(info.pad)
        for d in range(ndev):
            if pad_per_dev[d]:
                self._c_pad_dev[d].inc(pad_per_dev[d])
        return len(reqs)

    def harvest(self) -> int:
        """Finish the oldest in-flight batch (waits until the card has run
        it); returns requests completed, 0 if nothing in flight.  Its
        outputs are already on the host, one copy per output name: each
        request's result is a copy of its row, so results never pin the
        staging slot, which goes back to its free list."""
        if not self._inflight:
            return 0
        reqs, pending, info = self._inflight.popleft()
        for dq in self._dev_inflight:
            if dq:
                dq.popleft()
        t0 = obs.now()
        if pending.event is not None:
            pending.event.synchronize()
        done = obs.now()
        traced = obs.enabled()
        if traced:
            # one retroactive harvest span per device track (exactly one on
            # a one-device engine)
            for d in range(info.devices):
                obs.complete("serve.harvest", t0, done, cat="serve",
                             task=info.task, batch_id=info.batch_id,
                             bucket=info.bucket, n=len(reqs), device=d,
                             shard_n=(info.shard_n[d] if info.shard_n
                                      else len(reqs)))
        # measured service time of this (task, bucket) — the scheduler's
        # warm estimate (estimate_batch_seconds) reads its recent mean
        self.metrics.histogram(
            f"service_ms.{info.task}.b{info.bucket}").observe(
            (done - info.t_dispatch) * 1e3)
        rows = info.rows
        for i, req in enumerate(reqs):
            row = rows[i] if rows else i    # undo the shard placement
            req.result = tuple(np.array(m[row]) for m in pending.outputs)
            req.done = True
            req.t_done = done
            sojourn_ms = (done - req.t_submit) * 1e3
            self._h_sojourn.observe(sojourn_ms)
            self._h_sojourn_recent.observe(sojourn_ms)
            self._h_queue.observe((req.t_dispatch - req.t_submit) * 1e3)
            self.metrics.counter(f"task.{req.task}.completed").inc()
            if req.deadline_s is not None and done > req.deadline_s:
                req.missed_deadline = True
                self._c_misses.inc()
                self.metrics.counter(
                    f"task.{req.task}.deadline_misses").inc()
            else:
                self._c_goodput.inc()   # deadline-free completions count
            if traced:
                obs.complete("request", req.t_submit, done, cat="serve",
                             rid=req.rid, task=req.task,
                             batch_id=info.batch_id, bucket=info.bucket,
                             pad=info.pad, device=i % info.devices,
                             queued_ms=round(
                                 (req.t_dispatch - req.t_submit) * 1e3, 3))
        if pending.slot is not None:
            self._slots[(info.task, info.bucket)].append(pending.slot)
        self._c_completed.inc(len(reqs))
        self._t_last_harvest = done
        return len(reqs)

    # -------------------------------------------------------------- step --
    def step(self) -> int:
        """Synchronous serving step (dispatch one batch, harvest everything
        in flight); returns requests dispatched."""
        n = self.dispatch()
        while self._inflight:
            self.harvest()
        return n

    def run(self, max_steps: int = 10_000) -> int:
        """Drain every queue (the closed-batch path); returns requests
        served.  Keeps up to the current adaptive depth of batches in
        flight, so staging the next batch overlaps the card running the
        previous one."""
        served = 0
        for _ in range(max_steps):
            n = self.dispatch(draining=True)
            if n == 0 and not self._inflight:
                break          # dispatch()==0 means every queue is empty
            if n == 0 or max(len(dq) for dq in self._dev_inflight) \
                    >= self._depth:
                served += self.harvest()
                self._adapt_depth()
        while self._inflight:
            served += self.harvest()
        return served

    # -------------------------------------------------------- stream pump --
    def _oldest_ready(self) -> bool:
        """True when the oldest in-flight batch has finished on the card —
        harvesting it will not wait (``event.query()``)."""
        if not self._inflight:
            return False
        event = self._inflight[0][1].event
        return event is None or event.query()

    def poll(self, *, draining: bool = False) -> tuple[int, int]:
        """One non-blocking pump of the continuous-batching loop; returns
        ``(dispatched, harvested)`` request counts.

        Harvests every in-flight batch the card has already finished,
        dispatches while the scheduler has work and the in-flight window
        has room (the current adaptive depth), and only waits on the
        oldest batch when the window is full (or the stream is draining)
        with nothing else to do.  One ``_adapt_depth`` step per call."""
        harvested = 0
        while self._oldest_ready():
            harvested += self.harvest()
        dispatched = 0
        while max(len(dq) for dq in self._dev_inflight) < self._depth:
            n = self.dispatch(draining=draining)
            if n == 0:
                break
            dispatched += n
        if not dispatched and not harvested and self._inflight \
                and (draining or
                     max(len(dq) for dq in self._dev_inflight)
                     >= self._depth):
            harvested += self.harvest()
        self._adapt_depth()
        return dispatched, harvested

    def stream(self, arrivals, *, max_wall_s: float | None = None) -> list:
        """Replay an open-loop arrival schedule against the wall clock;
        returns one ``TaskRequest`` per arrival (all terminal: served, or
        shed with ``result=None``).

        ``arrivals`` is an iterable of ``(at_s, task, inputs)`` tuples —
        optionally ``(at_s, task, inputs, deadline_ms)`` or
        ``(..., deadline_ms, priority)`` — with ``at_s`` relative to the
        stream start.  Arrivals are not gated on service; ``submit``
        happens when the clock reaches ``at_s``, the loop pumps ``poll()``
        between arrivals, and returns once every request is terminal (or
        ``max_wall_s`` elapses)."""
        sched = sorted(arrivals, key=lambda a: a[0])
        reqs: list[TaskRequest] = []
        t0 = obs.now()
        i, n = 0, len(sched)
        while True:
            rel = obs.now() - t0
            while i < n and sched[i][0] <= rel:
                at, task, inputs, *rest = sched[i]
                deadline_ms = rest[0] if len(rest) >= 1 else None
                priority = rest[1] if len(rest) >= 2 else 0
                reqs.append(self.submit(task, deadline_ms=deadline_ms,
                                        priority=priority, **inputs))
                i += 1
            draining = i >= n
            dispatched, harvested = self.poll(draining=draining)
            if draining and not self.pending() and not self._inflight:
                break
            if max_wall_s is not None and obs.now() - t0 > max_wall_s:
                break
            if not dispatched and not harvested and i < n:
                wait = sched[i][0] - (obs.now() - t0)
                if wait > 0:           # idle until the next arrival
                    time.sleep(min(wait, 1e-3))
        return reqs
