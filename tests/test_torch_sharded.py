"""Batch-sharded GNN-CV serving on the CPU: the port's ``devices=`` /
``mesh=`` path against the reference's ``tests/test_serve_sharded.py``.

The reference forces eight host devices in a subprocess; the port names
the CPU several times (``["cpu"] * n``: each entry a replica with its own
weights and runners, ``launch/mesh.py``), in process.

- Each of the reference's five tests has its counterpart: a one-device
  mesh is the plain path; served results over 2 and 4 replicas against the
  reference engine's one-device results (its default, jitted) on b1, b2,
  b3-r50, b4, b5, b6 and b7 (small configs, the reference's parameters
  loaded into the port's plans, the reference's request inputs), within
  the port's parity bounds
  (``RTOL``, those of ``tests/test_torch_batched.py``); the engine's
  bucket floor, round-robin pads ``[0, 1, 1, 1]``, per-device in-flight
  queues and frozen runner misses; one dispatch and harvest span per
  device on tracks ``1000 + d``; the replicated weight bytes.
- The port against itself: under ``kernels="torch"`` a batch equals its
  samples bit for bit on the CPU (``test_torch_batched.py``), so served
  outputs over 2 and 4 replicas equal the one-device engine's bit for bit
  (b4, b5, b6, b6-dyn).
- The runner's contract: the reference's assertions, contiguous blocks
  of rows per replica, a mesh in the runner cache's key, ``swap_weights``
  writing every replica, a pre-compiled model's mesh matching the
  engine's, and a kernel launch refused when its tensors' card is not the
  current device.
"""
import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro import gcv as ref_gcv
from repro.core import CompileOptions as RefOptions
from repro.core import compile_graph as ref_compile
from repro.gnncv.jax_tasks import build_traced_task as ref_build_traced
from repro.gnncv.tasks import build_task as ref_build_task
from repro.gnncv.tasks import request_inputs
from repro_torch import gcv
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.runtime.cache import cache_stats, cached_runner
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_dynamic_task, build_task
from repro_torch.gnncv.torch_tasks import build_traced_task
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_data_mesh

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_dynamic import dyn_inputs  # noqa: E402
from test_torch_frontend_parity import by_position  # noqa: E402
from test_torch_runtime import exported  # noqa: E402

CPU = "cpu"
OPTS = CompileOptions(kernels="cuda")
PLAIN = CompileOptions(kernels="torch")
REF_OPTS = RefOptions(target="fpga", kernels="xla")
TASKS = ("b1", "b2", "b3-r50", "b4", "b5", "b6", "b7")
RTOL = {"b1": 1e-5, "b2": 1e-5, "b3-r50": 1e-5, "b4": 1e-6, "b7": 1e-5}
RTOL_REST = 3e-7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(n: int) -> list[str]:
    return [CPU] * n


def close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def plans(task):
    """-> (port plan carrying the reference's parameters, reference plan)
    at the small config."""
    if task == "b7":
        ref = ref_compile(ref_build_traced(task, small=True), REF_OPTS)
        plan = compile_graph(build_traced_task(task, small=True, seed=3),
                             OPTS)
        load_weights(plan, by_position(plan, ref))
        return plan, ref
    ref = ref_compile(ref_build_task(task, small=True), REF_OPTS)
    plan = compile_graph(build_task(task, small=True), OPTS)
    load_weights(plan, exported(ref))
    return plan, ref


@functools.lru_cache(maxsize=None)
def graph(task):
    if task == "b6-dyn":
        return build_dynamic_task(task, small=True)
    return build_task(task, small=True)


def submit_all(eng, inputs) -> list:
    return [eng.submit(task, **ins) for task, ins in inputs]


# ----------------------------------------------------- in-process guards --
def test_compile_devices_1_falls_back_to_single_device():
    """A one-device mesh resolves to the plain single-device runner path
    (mesh None), whether named by count, by sequence or as a mesh."""
    for kw in (dict(devices=1), dict(devices=cpus(1)),
               dict(mesh=make_data_mesh(cpus(1)))):
        cm = gcv.compile(graph("b6"), device=CPU, **kw)
        assert cm.mesh is None and cm.device == torch.device(CPU)
        assert cm.stats()["devices"] == 1
        assert cm.batched(2).mesh is None


# ----------------------------------------------------- against the JAX ----
def test_sharded_parity_all_tasks_devices_2_4():
    """Per-request results served over 2 and 4 replicas match the
    reference engine's one-device results within the port's bounds,
    across b1-b7."""
    inputs = [(t, request_inputs(plans(t)[1], seed=s))
              for t in TASKS for s in range(2)]
    ref = ref_gcv.serve({t: plans(t)[1] for t in TASKS}, options=REF_OPTS,
                        max_batch=8)
    want = submit_all(ref, inputs)
    assert ref.run() == len(want)
    for ndev in (2, 4):
        eng = gcv.serve({t: plans(t)[0] for t in TASKS}, options=OPTS,
                        max_batch=8, devices=cpus(ndev))
        got = submit_all(eng, inputs)
        assert eng.run() == len(got)
        assert eng.stats()["devices"] == ndev
        for a, b in zip(want, got):
            assert a.task == b.task
            for x, y in zip(a.result, b.result):
                close(y, x, RTOL.get(a.task, RTOL_REST))


# ------------------------------------------------------ against itself ----
def test_sharded_equals_one_device_bit_for_bit():
    tasks = ("b4", "b5", "b6", "b6-dyn")
    models = {t: graph(t) for t in tasks}
    rng = np.random.default_rng(0)

    def request(task, seed):
        if task == "b6-dyn":
            return dyn_inputs(one.plans[task].meta["input_shapes"][
                "points"][0], seed)
        return one.models[task].random_inputs(seed=seed)

    one = gcv.serve(models, options=PLAIN, max_batch=4, device=CPU)
    inputs = [(t, request(t, int(s))) for t in tasks
              for s in rng.integers(1000, size=3)]
    base = submit_all(one, inputs)
    assert one.run() == len(base)
    for ndev in (2, 4):
        eng = gcv.serve(models, options=PLAIN, max_batch=4,
                        devices=cpus(ndev))
        got = submit_all(eng, inputs)
        assert eng.run() == len(got)
        for a, b in zip(base, got):
            for x, y in zip(a.result, b.result):
                assert np.array_equal(x, y), (a.task, ndev)


# ------------------------------------------------------------ the engine --
def test_sharded_engine_pipelining_pads_and_frozen_misses():
    """devices=4 engine: bucket floor at the device count, round-robin pad
    accounting, per-device in-flight queues bounded by pipeline_depth,
    and runner_misses frozen under mixed traffic after warmup."""
    graphs = {t: graph(t) for t in ("b4", "b6")}
    # engine guards: every bucket must shard evenly, and sharding needs
    # graph runners
    with pytest.raises(AssertionError, match="divisible"):
        gcv.serve(graphs, max_batch=2, devices=cpus(4))
    with pytest.raises(AssertionError, match="single-device"):
        gcv.serve(graphs, max_batch=8, devices=cpus(4), jit=False)
    with pytest.raises(AssertionError, match="not both"):
        gcv.serve(graphs, devices=cpus(2), mesh=make_data_mesh(cpus(2)))

    eng = gcv.serve(graphs, max_batch=8, devices=cpus(4), pipeline_depth=2)
    assert eng.buckets() == [4, 8]
    eng.warmup()                     # builds every runner (no graphs here)
    pre = eng.stats()["runner_misses"]
    for task in graphs:
        for b in (4, 8):
            run = eng.models[task].batched(b, jit=True)
            assert run.mesh.size == 4 and len(run.replicas) == 4
            assert all(r.input_specs()[n][0][0] == b // 4
                       for r in run.replicas for n in r.input_specs())

    # 5 requests -> bucket 8, 3 pads spread round-robin over devices
    for s in range(5):
        eng.submit("b4", **eng.models["b4"].random_inputs(seed=s))
    assert eng.dispatch() == 5
    assert eng.inflight_per_device() == [1, 1, 1, 1]
    assert eng.harvest() == 5
    assert eng.inflight_per_device() == [0, 0, 0, 0]
    s = eng.stats()
    # positions 5, 6, 7 of the 8-bucket pad devices 1, 2, 3
    assert s["pad_per_device"] == [0, 1, 1, 1], s["pad_per_device"]
    assert s["padded"] == 3

    # pipelined mixed traffic: depth bounds each device queue
    depths = []
    real = eng.dispatch

    def watched(**kw):
        n = real(**kw)
        depths.append(max(eng.inflight_per_device()))
        return n
    eng.dispatch = watched
    for seed in range(16):
        task = ("b4", "b6")[seed % 2]
        eng.submit(task, **eng.models[task].random_inputs(seed=seed))
    assert eng.run() == 16
    assert max(depths) == 2
    s = eng.stats()
    assert s["runner_misses"] == pre, "live traffic built a runner"
    assert sum(s["pad_per_device"]) == s["padded"]


def test_round_robin_rows_are_undone_at_harvest():
    """Position j sits at stacked row (j % ndev) * (bucket // ndev) + j //
    ndev; each request gets its own row back (checked with a plan whose
    output is its input, so a misplaced row shows)."""
    eng = gcv.serve({"b6": graph("b6")}, options=PLAIN, max_batch=8,
                    devices=cpus(4))
    seen = []
    real = eng._stack

    def stack(samples):
        seen.append([s["points"][0, 0] for s in samples])
        return real(samples)
    eng._stack = stack
    reqs = [eng.submit("b6", **eng.models["b6"].random_inputs(seed=s))
            for s in range(6)]
    assert eng.run() == 6
    ids = [r.inputs["points"][0, 0] for r in reqs]
    pad = ids[-1]
    assert seen == [[ids[0], ids[4], ids[1], ids[5], ids[2], pad, ids[3],
                     pad]]
    one = gcv.compile(graph("b6"), options=PLAIN, device=CPU)
    for r in reqs:
        for x, y in zip(r.result, one.run(**r.inputs)):
            assert np.array_equal(x, y.numpy())


def test_sharded_trace_has_per_device_tracks(tmp_path):
    """Every dispatch/harvest emits one span per device; the Chrome export
    routes them to per-device tids with thread_name metadata."""
    path = tmp_path / "trace_sharded.json"
    with gcv.trace_to(str(path)):
        eng = gcv.serve({"b6": graph("b6")}, max_batch=4, devices=cpus(2),
                        warmup=True)
        for s in range(3):
            eng.submit("b6", **eng.models["b6"].random_inputs(seed=s))
        assert eng.run() == 3

    doc = json.loads(path.read_text())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    disp = [e for e in evs if e["name"] == "serve.dispatch"]
    harv = [e for e in evs if e["name"] == "serve.harvest"]
    reqs = [e for e in evs if e["name"] == "request"]
    assert len(disp) == 2 and len(harv) == 2   # 1 batch x 2 devices
    assert {e["args"]["device"] for e in disp} == {0, 1}
    assert sorted(e["tid"] for e in disp) == [1000, 1001]
    # global batch identity identical on both tracks; shard split sums to
    # the bucket
    assert all(e["args"]["bucket"] == 4 and e["args"]["n"] == 3
               and e["args"]["pad"] == 1 for e in disp)
    assert sum(e["args"]["shard_n"] + e["args"]["shard_pad"]
               for e in disp) == 4
    assert sorted(e["args"]["shard_n"] for e in harv) == [1, 2]
    assert len(reqs) == 3
    assert [e["args"]["device"] for e in sorted(
        reqs, key=lambda e: e["args"]["rid"])] == [0, 1, 0]
    meta = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert meta[1000] == "device 0" and meta[1001] == "device 1"


def test_sharded_residency_replicates_per_device():
    """Weights upload once per device: the replicated store reports
    ndev x the single-device footprint, and stats() splits it."""
    g = build_task("b1", small=True)
    one = gcv.compile(g, device=CPU, devices=1)
    four = gcv.compile(g, devices=cpus(4))
    assert four.stats()["resident_bytes"] == \
        4 * four.stats()["resident_bytes_per_device"]  # sized, no runner
    one.batched(4)
    four.batched(4)
    s1, s4 = one.stats(), four.stats()
    assert s4["devices"] == 4
    assert s4["resident_bytes_per_device"] == s1["resident_bytes"]
    assert s4["resident_bytes"] == 4 * s1["resident_bytes"]
    run = four.batched(4)
    assert run.mesh is not None and run.mesh.size == 4
    stores = run.resident.stores()
    assert run.resident.replicas == 4 and len(stores) == 4
    ptrs = {t.data_ptr() for s in stores for t in s.arrays.values()}
    assert len(ptrs) == 4 * len(stores[0].arrays)   # a buffer each
    for s, rep in zip(stores, run.replicas):
        assert rep.resident is s and s.slots == stores[0].slots
        for ref, t in s.arrays.items():
            assert torch.equal(t, stores[0].arrays[ref])


# ------------------------------------------------------ the runner itself --
def test_mesh_runner_contract():
    plan = compile_graph(graph("b4"), PLAIN)
    mesh = make_data_mesh(cpus(2))
    with pytest.raises(AssertionError, match="batch=N"):
        build_runner(plan, mesh=mesh)
    with pytest.raises(AssertionError, match="divisible"):
        build_runner(plan, batch=3, mesh=mesh)
    with pytest.raises(AssertionError, match="jit=False"):
        build_runner(plan, batch=2, jit=False, mesh=mesh)
    with pytest.raises(AssertionError, match="first entry"):
        build_runner(plan, batch=2, mesh=make_data_mesh(["meta", CPU]),
                     device=CPU)
    with pytest.raises(AssertionError, match="first entry"):
        gcv.compile(graph("b4"), device="meta", devices=cpus(2))
    one = build_runner(plan, batch=2, mesh=make_data_mesh(cpus(1)))
    assert one.mesh is None and one.device == torch.device(CPU)
    run = build_runner(plan, batch=4, mesh=mesh)
    assert run.mesh == mesh and run.device == torch.device(CPU)
    assert run.input_specs()["skeleton"][0][0] == 4
    samples = [gcv.compile(plan, device=CPU).random_inputs(seed=s)
               for s in range(4)]
    out = run(**gcv.stack_inputs(samples))[0]
    plain = build_runner(plan, device=CPU, batch=2)
    assert torch.equal(out[:2], plain(**gcv.stack_inputs(samples[:2]))[0])
    assert torch.equal(out[2:], plain(**gcv.stack_inputs(samples[2:]))[0])
    with pytest.raises(AssertionError, match="leading batch axis 4"):
        run(**gcv.stack_inputs(samples[:2]))


def test_equal_meshes_share_a_runner_cache_entry():
    g = build_task("b5", small=True)
    misses = cache_stats()["runner_misses"]
    a = cached_runner(g, PLAIN, batch=4, jit=True,
                      mesh=make_data_mesh(cpus(2)))
    b = cached_runner(g, PLAIN, batch=4, jit=True,
                      mesh=make_data_mesh([torch.device(CPU)] * 2))
    c = cached_runner(g, PLAIN, batch=4, jit=True,
                      mesh=make_data_mesh(cpus(4)))
    assert a is b and a is not c
    assert cache_stats()["runner_misses"] == misses + 2


def test_swap_weights_writes_every_replica():
    model = gcv.compile(build_task("b6", small=True), options=PLAIN,
                        devices=cpus(2))
    samples = [model.random_inputs(seed=s) for s in range(4)]
    stacked = gcv.stack_inputs(samples)
    before = model.batched(4)(**stacked)[0]
    op = next(o for o in model.plan.ops if "w" in o.weights)
    w = np.asarray(op.weights["w"]) * 2
    model.swap_weights({op.name: {"w": w}})       # goes private
    run = model.batched(4)
    after = run(**stacked)[0]
    assert not torch.equal(before, after)
    model.swap_weights({op.name: {"w": w * 0.5}})  # in place, every replica
    for store in run.resident.stores():
        assert torch.equal(store.get(op, "w"), torch.from_numpy(w * 0.5))
    assert torch.equal(run(**stacked)[0], before)


def test_precompiled_model_mesh_must_match_the_engine():
    two = gcv.compile(graph("b4"), devices=cpus(2))
    eng = gcv.serve({"b4": two}, devices=cpus(2), max_batch=4)
    assert eng.models["b4"] is two and eng.stats()["devices"] == 2
    with pytest.raises(AssertionError, match="mesh"):
        gcv.serve({"b4": two}, device=CPU, max_batch=4)
    with pytest.raises(AssertionError, match="mesh"):
        gcv.serve({"b4": gcv.compile(graph("b4"), device=CPU)},
                  devices=cpus(2), max_batch=4)


def test_a_launch_off_the_current_device_raises(monkeypatch):
    """A kernel launches on the current device's context: an operand on
    another card must raise before the launch, never run there."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    on_one = types.SimpleNamespace(get_device=lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:1 but cuda:0"):
        _build.stream_of(on_one, "ddmm")
    with pytest.raises(RuntimeError, match="shift_conv2d"):
        _build.on_current_device("shift_conv2d", on_one)
    on_zero = types.SimpleNamespace(get_device=lambda: 0)
    assert _build.on_current_device("knn", on_zero) == 0
