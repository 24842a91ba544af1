"""The port's GNN-CV serving engine (``gcv.serve``) against the reference's,
on the CPU.

- Fed the same requests in the same order, the two engines make the same
  dispatch sequence ``(task, take, bucket)`` and serve outputs within the
  bounds ``tests/test_torch_batched.py`` holds batched runners to
  (``max|Δ| <= 1e-5 · max|ref|`` for b1, ``1e-6`` for b4, ``3e-7`` for
  b6): b4, b6 and b1 at their small configs, the port's plans carrying
  the reference's parameters (``load_weights``), the reference's batched
  runners per op (``jit=False``, as the batched tests run it).
- The SLO scheduler's decisions on a fake engine state equal the
  reference's exactly, shed lists included, and so do the FIFO policy's.
- Shedding, adaptive depth (grow under a backlog, shrink near the SLO)
  and the ``stats()`` keys equal the reference's under one injected
  clock; graph buckets as in ``tests/test_serve_dynamic.py`` (routing,
  padded == pre-padded output, bounded runners, pad accounting, the
  admission error); ``warmup=True`` freezes ``runner_misses``.

No verdict reads the wall clock: the clock is injected
(``obs.now``) wherever deadlines or sojourns decide, and ``poll`` and
``dispatch`` are driven by hand.
"""
import functools
import itertools
import os
import sys
import types
from collections import deque

import numpy as np
import pytest
import torch

from repro import gcv as ref_gcv
from repro import obs as ref_obs
from repro.core import CompileOptions as RefOptions
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.gnncv.jax_tasks import build_traced_task
from repro.gnncv.tasks import build_task as ref_build_task
from repro.serve.scheduler import FIFOScheduler as RefFIFO
from repro.serve.scheduler import SLOScheduler as RefSLO
from repro_torch import gcv, obs
from repro_torch.core import CompileOptions, compile_graph
from repro_torch.core.runtime.cache import cache_stats, clear_caches
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_dynamic_task, build_task
from repro_torch.serve import (FIFOScheduler, GNNCVServeEngine,
                               SLOScheduler, TaskRequest, resolve_scheduler)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_dynamic import dyn_inputs  # noqa: E402
from test_torch_runtime import exported  # noqa: E402

CPU = "cpu"
TASKS = ("b4", "b6", "b1")
RTOL = {"b1": 1e-5, "b4": 1e-6, "b6": 3e-7, "b6-dyn": 3e-7}
OPTS = CompileOptions(kernels="cuda")
REF_OPTS = RefOptions(target="fpga", kernels="xla")
SIZES = [32, 64]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clock(monkeypatch):
    """One injected clock for both packages' ``obs.now``."""
    state = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(obs, "now", lambda: state.t)
    monkeypatch.setattr(ref_obs, "now", lambda: state.t)
    return state


def close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def plans(task, n_points=None):
    """-> (port plan carrying the reference's parameters, reference
    plan) at the small config (b6-dyn: ``n_points`` points)."""
    if task == "b6-dyn":
        ref_graph = build_traced_task(task, small=True, n_points=n_points)
        port_graph = build_dynamic_task(task, small=True, n_points=n_points)
    else:
        ref_graph = ref_build_task(task, small=True)
        port_graph = build_task(task, small=True)
    ref = ref_compile(ref_graph, REF_OPTS)
    plan = compile_graph(port_graph, OPTS)
    load_weights(plan, exported(ref))
    return plan, ref


def engines(tasks=TASKS, **kw):
    """-> (port engine on the CPU, reference engine) over the same
    plans."""
    port = gcv.serve({t: plans(t)[0] for t in tasks}, options=OPTS,
                     device=CPU, **kw)
    ref = ref_gcv.serve({t: plans(t)[1] for t in tasks}, options=REF_OPTS,
                        jit=False, **kw)
    return port, ref


def record_picks(eng) -> list:
    """Wrap the engine's scheduler so every decision is recorded."""
    picks, pick = [], eng.scheduler.pick

    def recorded(engine, *, draining=False):
        d = pick(engine, draining=draining)
        if d is not None:
            picks.append((d.task, d.take, d.bucket))
        return d
    eng.scheduler.pick = recorded
    return picks


# The submissions of the parity runs: (task, count), in order.
PATTERN = [("b4", 3), ("b6", 5), ("b1", 1), ("b4", 2), ("b1", 4),
           ("b6", 8), ("b4", 1)]


def submit_pattern(eng, ref_plans):
    seeds = itertools.count()
    out = []
    for task, n in PATTERN:
        for _ in range(n):
            ins = ref_random_inputs(ref_plans[task], seed=next(seeds))
            out.append(eng.submit(task, **ins))
    return out


# ------------------------------------------------ engine vs the reference --
@pytest.mark.parametrize("scheduler,depth", [("fifo", 1), ("fifo", 2),
                                             ("slo", 2)])
def test_engine_matches_reference_dispatch_and_outputs(scheduler, depth):
    port, ref = engines(max_batch=4, pipeline_depth=depth,
                        scheduler=scheduler)
    ref_plans = {t: plans(t)[1] for t in TASKS}
    picks = (record_picks(port), record_picks(ref))
    mine = submit_pattern(port, ref_plans)
    theirs = submit_pattern(ref, ref_plans)
    assert port.run() == ref.run() == len(mine)
    assert picks[0] == picks[1] and len(picks[0]) > len(TASKS)
    assert {b for _, _, b in picks[0]} == {1, 2, 4}
    for a, b in zip(mine, theirs):
        assert a.task == b.task and a.done and b.done
        for x, y in zip(a.result, b.result):
            assert isinstance(x, np.ndarray)
            close(x, y, RTOL[a.task])
    assert port.stats()["padded"] == ref.stats()["padded"]
    assert port.stats()["steps"] == ref.stats()["steps"]


def test_served_outputs_equal_the_models_batch_1_runs():
    """On the CPU a served batch runs the plain versions per sample, so
    each request equals its own batch-1 run within the port's bound."""
    port, _ = engines(max_batch=4)
    ref_plans = {t: plans(t)[1] for t in TASKS}
    reqs = submit_pattern(port, ref_plans)
    port.run()
    for r in reqs:
        for got, want in zip(r.result, port.models[r.task].run(**r.inputs)):
            close(got, want.numpy(), RTOL[r.task])


# ------------------------------------------------------------ schedulers --
def fake_engine(queues, est, max_batch=8):
    """Queue state as the schedulers see it: per-task deques of requests
    (rid, deadline_s, priority), a bucket rule, a service estimate per
    task and sample, and ``shed_expired`` that records what it drops."""
    eng = types.SimpleNamespace(max_batch=max_batch, shed=[])
    eng.queues = {t: deque(types.SimpleNamespace(rid=rid, deadline_s=dl,
                                                 priority=pr)
                           for rid, dl, pr in reqs)
                  for t, reqs in queues.items()}

    def bucket(n, cap):
        b = 1
        while b < n and b < cap:
            b *= 2
        return min(b, cap)

    def shed_expired(now):
        for t, q in eng.queues.items():
            keep = deque(r for r in q if r.deadline_s is None
                         or r.deadline_s > now)
            eng.shed += [(t, r.rid) for r in q if r not in keep]
            eng.queues[t] = keep
        return len(eng.shed)
    eng._bucket = bucket
    eng.estimate_batch_seconds = lambda t, b: est[t] * b
    eng.shed_expired = shed_expired
    return eng


# (queues: task -> [(rid, deadline_s, priority)], per-sample estimate s)
SCENARIOS = {
    "older-loose-vs-newer-urgent": (
        {"b6": [(0, 9.0, 0), (1, 9.0, 0), (2, 9.0, 0)],
         "b1": [(3, 0.1, 0), (4, 0.1, 0)]}, {"b6": 1e-3, "b1": 1e-3}),
    "service-corrected-slack": (
        {"b3": [(0, 0.020, 0)], "b1": [(1, 0.021, 0)]},
        {"b3": 1e-2, "b1": 1e-4}),
    "priority-trumps-slack": (
        {"b1": [(0, 0.05, 0)], "b6": [(1, 9.0, 5)]},
        {"b1": 1e-3, "b6": 1e-3}),
    "deadline-free-keeps-fifo-order": (
        {"b6": [(2, None, 0)], "b1": [(0, None, 0), (1, None, 0)]},
        {"b6": 1e-3, "b1": 1e-3}),
    "expired-are-shed": (
        {"b6": [(0, 0.001, 0), (1, 0.5, 0)], "b1": [(2, 0.002, 0)]},
        {"b6": 1e-3, "b1": 1e-3}),
    "bucket-quantization": (
        {"b6": [(i, 5.0, 0) for i in range(5)]}, {"b6": 1e-3}),
    "window-capped-at-max-batch": (
        {"b6": [(i, 5.0 - i, 0) for i in range(11)],
         "b1": [(11, 4.0, 1)]}, {"b6": 1e-3, "b1": 1e-3}),
    "all-empty": ({"b6": [], "b1": []}, {"b6": 1e-3, "b1": 1e-3}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_decisions_equal_the_reference(name, clock):
    queues, est = SCENARIOS[name]
    clock.t = 0.01
    for mine_cls, ref_cls in ((SLOScheduler, RefSLO),
                              (FIFOScheduler, RefFIFO)):
        a, b = fake_engine(queues, est), fake_engine(queues, est)
        da, db = mine_cls().pick(a), ref_cls().pick(b)
        assert a.shed == b.shed
        if db is None:
            assert da is None
            continue
        assert (da.task, da.take, da.bucket, da.slack_ms, da.reason) == \
            (db.task, db.take, db.bucket, db.slack_ms, db.reason)


def test_scheduler_resolution_matches_the_reference():
    assert resolve_scheduler(None, slo_ms=None).name == "fifo"
    assert resolve_scheduler(None, slo_ms=5.0).name == "slo"
    assert resolve_scheduler("slo", slo_ms=None).name == "slo"
    keep = SLOScheduler(shed_expired=False)
    assert resolve_scheduler(keep, slo_ms=1.0) is keep
    assert repr(keep) == repr(RefSLO(shed_expired=False))
    with pytest.raises(AssertionError, match="unknown scheduler"):
        resolve_scheduler("lifo", slo_ms=None)
    with pytest.raises(TypeError):
        resolve_scheduler(3, slo_ms=None)


# --------------------------------- shedding, depth, stats (one clock) -----
def test_shedding_adaptive_depth_and_stats_equal_the_reference(clock):
    port, ref = engines(max_batch=4, slo_ms=100.0, pipeline_depth=1,
                        max_pipeline_depth=3)
    assert set(port.stats()) == set(ref.stats())
    ref_plans = {t: plans(t)[1] for t in TASKS}
    trail = []
    for eng in (port, ref):
        clock.t = 0.0
        ins = {t: ref_random_inputs(ref_plans[t], seed=1) for t in TASKS}
        late = [eng.submit("b6", deadline_ms=5, **ins["b6"])
                for _ in range(2)]
        gone = eng.submit("b1", deadline_ms=0, **ins["b1"])
        ok = eng.submit("b4", **ins["b4"])
        clock.t = 0.010                              # past the 5 ms ones
        assert eng.dispatch() == 1 and eng.harvest() == 1
        depths = []
        for _ in range(9):
            eng.submit("b6", **ins["b6"])
        for _ in range(3):                           # backlog: grow
            depths.append(eng._adapt_depth())
        for _ in range(64):                          # p95 near the SLO
            eng._h_sojourn_recent.observe(90.0)
        depths.append(eng._adapt_depth())            # shrink
        trail.append(dict(
            shed=[r.shed for r in late], gone=(gone.shed, gone.done),
            ok=(ok.done, ok.missed_deadline), depths=depths,
            stats={k: v for k, v in eng.stats().items()
                   if k not in ("req_per_s", "goodput_req_per_s")
                   and not k.endswith("_ms")
                   and k not in ("per_task", "graphs", "plans", "runners",
                                 "plan_hits", "plan_misses", "runner_hits",
                                 "runner_misses")}))
        assert eng.run() == 9
    assert trail[0] == trail[1]
    assert trail[0]["depths"] == [2, 3, 3, 2]
    assert trail[0]["stats"]["shed"] == 2
    assert trail[0]["stats"]["expired_at_submit"] == 1
    assert set(port.stats()["per_task"]["b6"]) \
        == set(ref.stats()["per_task"]["b6"])


def test_stats_are_zero_safe_and_name_the_engine():
    port, _ = engines(max_batch=4)
    st = port.stats()
    assert st["completed"] == 0 and st["req_per_s"] is None
    assert st["p50_sojourn_ms"] is None and st["deadline_miss_rate"] is None
    assert (st["devices"], st["scheduler"]) == (1, "fifo")
    assert port.buckets() == [1, 2, 4]


# --------------------------------------------------- poll and stream ------
def test_poll_pumps_by_hand():
    """On the CPU a batch is done when ``dispatch`` returns, so ``poll``
    harvests it at the next call; the window bounds what it dispatches."""
    port, _ = engines(max_batch=2, pipeline_depth=2)
    ref_plans = {t: plans(t)[1] for t in TASKS}
    for t in ("b1", "b6", "b4"):
        for s in range(2):
            port.submit(t, **ref_random_inputs(ref_plans[t], seed=s))
    assert port.poll() == (4, 0)          # two batches fill the window
    assert port.inflight() == 4 and port.pending() == 2
    assert port.poll() == (2, 4)          # both ready: harvest, refill
    assert port.poll(draining=True) == (0, 2)
    assert port.poll(draining=True) == (0, 0)
    assert port.stats()["completed"] == 6


def test_stream_replays_an_open_loop_schedule_on_an_injected_clock(
        clock, monkeypatch):
    """Arrivals on a clock that moves 1 ms per reading (sleeping moves it
    too): every request ends terminal, deadline-free ones all served, one
    whose deadline passes in the queue shed."""
    def tick():
        clock.t += 1e-3
        return clock.t
    monkeypatch.setattr(obs, "now", tick)
    monkeypatch.setattr("time.sleep", lambda s: None)
    port, _ = engines(max_batch=4, scheduler="slo")
    ref_plans = {t: plans(t)[1] for t in TASKS}
    arrivals = [(0.002 * i, TASKS[i % 3],
                 ref_random_inputs(ref_plans[TASKS[i % 3]], seed=i))
                for i in range(12)]
    arrivals.append((0.030, "b6", ref_random_inputs(ref_plans["b6"], 99),
                     1e-6))
    reqs = port.stream(arrivals, max_wall_s=10.0)
    assert len(reqs) == 13 and all(r.done for r in reqs)
    assert sum(r.result is not None for r in reqs) == 12
    assert reqs[-1].shed and reqs[-1].missed_deadline
    st = port.stats()
    assert st["completed"] == 12 and st["deadline_misses"] == 1


# ----------------------------------------------------------- graph buckets --
def dyn_engine(**kw):
    """Port and reference engines over b6-dyn at ``SIZES`` points, the
    port's plans carrying the reference's parameters."""
    port = gcv.serve({"b6-dyn": lambda n: plans("b6-dyn", n)[0]},
                     graph_buckets={"b6-dyn": SIZES}, options=OPTS,
                     device=CPU, max_batch=4, **kw)
    ref = ref_gcv.serve({"b6-dyn": lambda n: plans("b6-dyn", n)[1]},
                        graph_buckets={"b6-dyn": SIZES}, options=REF_OPTS,
                        jit=False, max_batch=4, **kw)
    return port, ref


def dyn_request(n, seed=0):
    return dyn_inputs(n, seed, pad=0)


def test_graph_buckets_route_and_serve_like_the_reference():
    port, ref = dyn_engine()
    reqs = []
    for eng in (port, ref):
        reqs.append({n: eng.submit("b6-dyn", **dyn_request(n, seed=n))
                     for n in (5, 32, 33, 50, 64)})
        assert eng.run() == 5
    for n in (5, 32, 33, 50, 64):
        mine, theirs = reqs[0][n], reqs[1][n]
        assert mine.task == theirs.task == \
            f"b6-dyn@g{32 if n <= 32 else 64}"
        g = int(mine.task.rsplit("@g", 1)[1])
        assert mine.inputs["points"].shape == (g, 3)
        assert int(mine.inputs["mask"].sum()) == n
        close(mine.result[0], theirs.result[0], RTOL["b6-dyn"])
    assert port.stats()["graph_buckets"] == ref.stats()["graph_buckets"]


def test_graph_bucket_padded_request_equals_pre_padded_submission():
    port, _ = dyn_engine()
    inp = dyn_request(40, seed=9)
    r_auto = port.submit("b6-dyn", **inp)
    pre = {k: np.concatenate([v, np.zeros((24,) + v.shape[1:], v.dtype)])
           for k, v in inp.items()}
    r_pre = port.submit("b6-dyn", **pre)
    assert r_auto.task == r_pre.task == "b6-dyn@g64"
    port.run()
    np.testing.assert_array_equal(r_auto.result[0], r_pre.result[0])


def test_graph_bucket_runners_bounded_and_misses_frozen():
    clear_caches()
    eng = gcv.serve(
        {"b6-dyn": lambda n: build_dynamic_task("b6-dyn", small=True,
                                                n_points=n)},
        graph_buckets={"b6-dyn": SIZES}, max_batch=4, device=CPU,
        warmup=True)
    # one runner per (graph bucket, batch bucket), nothing else
    assert cache_stats()["runners"] == len(SIZES) * len(eng.buckets())
    misses = eng.stats()["runner_misses"]
    for s in range(12):
        eng.submit("b6-dyn", **dyn_request(16 + 3 * s, seed=s))
    assert eng.run() == 12
    st = eng.stats()
    assert st["runner_misses"] == misses and st["runner_hits"] > 0
    assert cache_stats()["runners"] == len(SIZES) * len(eng.buckets())


def test_graph_bucket_pad_accounting_equals_the_reference():
    port, ref = dyn_engine()
    for eng in (port, ref):
        for n in (10, 30, 32, 40, 64):
            eng.submit("b6-dyn", **dyn_request(n))
    want = {32: {"submitted": 3, "pad_nodes": 22 + 2},
            64: {"submitted": 2, "pad_nodes": 24}}
    assert port.stats()["graph_buckets"]["b6-dyn"] == want
    assert ref.stats()["graph_buckets"]["b6-dyn"] == want


def test_graph_bucket_admission_error_over_the_largest():
    port, ref = dyn_engine()
    for eng in (port, ref):
        with pytest.raises(ValueError, match="largest graph bucket"):
            eng.submit("b6-dyn", **dyn_request(65))
        with pytest.raises(ValueError, match="disagree"):
            eng.submit("b6-dyn", points=np.zeros((10, 3), np.float32),
                       mask=np.ones(12, np.float32))
    with pytest.raises(AssertionError, match="factory"):
        gcv.serve({"b6-dyn": plans("b6-dyn", 32)[0]},
                  graph_buckets={"b6-dyn": SIZES}, device=CPU)


# ---------------------------------------------------------------- façade --
def test_serve_warmup_freezes_runner_misses():
    clear_caches()
    graphs = {t: build_task(t, small=True) for t in TASKS}
    eng = gcv.serve(graphs, max_batch=4, device=CPU, warmup=True)
    assert isinstance(eng, GNNCVServeEngine)
    # the CPU has nothing to capture, but every runner is built
    assert eng.stats()["warmed"] == 0
    assert cache_stats()["runners"] == len(TASKS) * len(eng.buckets())
    misses = cache_stats()["runner_misses"]
    for s in range(10):
        t = TASKS[s % 3]
        eng.submit(t, **eng.models[t].random_inputs(seed=s))
    assert eng.run() == 10
    assert cache_stats()["runner_misses"] == misses
    assert cache_stats()["runner_hits"] > 0


def test_serve_takes_compiled_models_graphs_and_plans():
    graph = build_task("b6", small=True)
    model = gcv.compile(build_task("b1", small=True), device=CPU)
    plan = compile_graph(build_task("b4", small=True), OPTS)
    eng = gcv.serve({"b6": graph, "b1": model, "b4": plan}, device=CPU,
                    kernels="torch")
    assert eng.models["b1"] is model                 # keeps its own options
    assert eng.models["b6"].plan.meta["kernels_mode"] == "torch"
    assert eng.models["b4"].plan.meta["kernels_mode"] == "torch"
    pair = gcv.serve({"f": (torch.relu, {"x": np.zeros(3, np.float32)})},
                     device=CPU)
    assert pair.models["f"].plan.meta["frontend"] == "tracer"
    with pytest.raises(AssertionError, match="power of two"):
        gcv.serve({"b6": graph}, max_batch=6, device=CPU)
    with pytest.raises(AssertionError, match="unknown task"):
        eng.submit("b9", x=np.zeros(3))
    with pytest.raises(AssertionError, match="missing inputs"):
        eng.submit("b6")
    req = eng.submit("b6", **eng.models["b6"].random_inputs(seed=0))
    assert isinstance(req, TaskRequest) and not req.done
