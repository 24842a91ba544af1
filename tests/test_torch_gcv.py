"""The port's ``gcv`` façade, runner cache and per-op profile, on the CPU.

Counterparts of ``tests/test_gcv_api.py`` for a ``Graph`` or an
``ExecutionPlan`` (its callable and tracing cases are in
``tests/test_torch_frontend.py``, its sharding cases wait for ROADMAP
queue 1 item 6; serving is ``tests/test_torch_serve.py``): the
façade equals ``build_runner`` on the same plan bit for bit, per sample
and batched, and the port's façade
matches the reference's on the same task within the port's per-task
bounds (``max|Δ| <= 1e-5 · max|ref|`` for b1-b3, deep fp32 chains summed
in another order; ``1e-6`` for b4, whose reference batch drifts 3.3e-7
from its per-sample run; ``3e-7`` for b5 and b6).  On the CPU there are no
CUDA graphs: warming up captures nothing, and the cache's miss counter
still freezes after the runners are built.
"""
import functools
import json

import numpy as np
import pytest
import torch

from repro import gcv as ref_gcv
from repro.core import CompileOptions as RefOptions
from repro.core.executor import stack_inputs as ref_stack_inputs
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch import gcv
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs, stack_inputs
from repro_torch.core.ir import Graph, GraphBuilder
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.runtime.cache import cache_stats, clear_caches
from repro_torch.gnncv.tasks import build_task
from repro_torch.launch.mesh import make_data_mesh

OPTS = CompileOptions(target="fpga")
REF_OPTS = RefOptions(target="fpga", kernels="pallas")
SEED = 7
TASKS = ["b1", "b2", "b3-r50", "b4", "b5", "b6"]
RTOL = {"b1": 1e-5, "b2": 1e-5, "b3-r50": 1e-5, "b4": 1e-6}
RTOL_REST = 3e-7
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _graph(task) -> Graph:
    return build_task(task, small=True)


@functools.lru_cache(maxsize=None)
def _plain_plan(task) -> ExecutionPlan:
    return compile_graph(_graph(task), OPTS)


@functools.lru_cache(maxsize=None)
def _ref_model(task):
    return ref_gcv.compile(ref_build_task(task, small=True),
                           options=REF_OPTS)


# --------------------------------------------------- six-task parity ----
@pytest.mark.parametrize("task", TASKS)
def test_gcv_compile_matches_build_runner_and_reference_per_sample(task):
    model = gcv.compile(_graph(task), options=OPTS, device=CPU)
    ins = random_inputs(model.plan, seed=SEED)
    legacy = build_runner(_plain_plan(task), device=CPU)(**ins)
    new = model.run(**ins)
    assert len(new) == len(legacy)
    for a, b in zip(new, legacy):
        assert torch.equal(a, b)
    for a, r in zip(new, _ref_model(task).run(**ins)):
        close(a.numpy(), np.asarray(r), RTOL.get(task, RTOL_REST))


@pytest.mark.parametrize("task", TASKS)
def test_gcv_compile_matches_build_runner_and_reference_batched(task):
    model = gcv.compile(_graph(task), options=OPTS, batch=2, device=CPU)
    samples = [random_inputs(model.plan, seed=s) for s in range(2)]
    stacked = stack_inputs(samples)
    legacy = build_runner(_plain_plan(task), device=CPU, batch=2)(**stacked)
    via_run = model.run(**stacked)
    via_batched = model.batched(2)(**stacked)
    theirs = _ref_model(task).batched(2)(**ref_stack_inputs(samples))
    for a, b, c, r in zip(via_run, legacy, via_batched, theirs):
        assert torch.equal(a, b) and torch.equal(a, c)
        close(a.numpy(), np.asarray(r), RTOL.get(task, RTOL_REST))


# ------------------------------------------------- input-type dispatch ----
def test_compile_accepts_execution_plan():
    plan = compile_graph(_graph("b6"), OPTS)
    model = gcv.compile(plan, device=CPU)
    assert model.plan is plan and model.graph is None
    ins = random_inputs(plan, seed=SEED)
    for a, b in zip(model.run(**ins), build_runner(plan, device=CPU)(**ins)):
        assert torch.equal(a, b)
    assert "ExecutionPlan" in model.lint()       # nothing to lint, says so


def test_compile_rebinds_a_plans_kernels():
    plan = compile_graph(_graph("b4"), CompileOptions(kernels="torch"))
    model = gcv.compile(plan, kernels="cuda", device=CPU)
    assert model.plan.meta["kernels_mode"] == "cuda"
    assert "cuda_ell_spdmm" in model.plan.kernel_counts()


def test_compile_rejects_examples_callables_and_others():
    with pytest.raises(AssertionError, match="example_inputs"):
        gcv.compile(_graph("b6"), {"points": np.zeros((64, 3))}, device=CPU)
    with pytest.raises(AssertionError, match="already compiled"):
        gcv.compile(_plain_plan("b6"), {"points": np.zeros((64, 3))},
                    device=CPU)
    with pytest.raises(AssertionError, match="requires example_inputs"):
        gcv.compile(lambda x: x)
    with pytest.raises(AssertionError, match="cannot compile"):
        gcv.compile(42)


def test_compile_options_as_keywords():
    model = gcv.compile(_graph("b6"), target="fpga", sparsity_aware=False,
                        device=CPU)
    assert model.options == CompileOptions(target="fpga",
                                           sparsity_aware=False)
    assert model.plan.meta["sparsity_aware"] is False
    with pytest.raises(AssertionError, match="not both"):
        gcv.compile(_graph("b6"), options=OPTS, target="fpga", device=CPU)


def test_kernels_default_to_cuda_and_auto_waits_for_item_3():
    """Kept under its earlier name.  Checks that the default stays
    ``"cuda"`` and that ``auto`` and ``measured`` now compile (off the card
    they bind every twin, as ``"torch"`` does)."""
    assert gcv.compile(_graph("b4"), device=CPU).plan.meta[
        "kernels_mode"] == "cuda"
    plain = gcv.compile(build_task("b4", small=True), kernels="torch",
                        device=CPU).plan.kernel_counts()
    for mode in ("auto", "measured"):
        model = gcv.compile(build_task("b4", small=True), kernels=mode,
                            device=CPU)
        assert model.plan.meta["kernels_mode"] == mode
        if mode == "auto":
            assert model.plan.kernel_counts() == plain
        assert not any(k.startswith("cuda_")
                       for k in model.plan.kernel_counts())


def test_more_than_one_device_and_serve_wait_for_item_6():
    """Kept under its earlier name, from when more than one device raised
    for ROADMAP item 6.  Now ``devices=2`` on a host without a card warns
    and degrades to its one device (the CPU, asked for by ``device=``),
    ``device=None`` still means the card, a malformed ``mesh=`` and a
    ``device=`` off the mesh are refused, and one device is the
    single-device path (``tests/test_torch_sharded.py`` serves over
    several)."""
    for build in (lambda **kw: gcv.compile(_graph("b6"), **kw),
                  lambda **kw: gcv.serve({"b6": _graph("b6")}, **kw)):
        with pytest.warns(UserWarning, match="requested 2 devices but "
                                             "only 1 exist"):
            made = build(device=CPU, devices=2)
        assert made.mesh is None and made.stats()["devices"] == 1
        assert made.device == torch.device(CPU)
        with pytest.warns(UserWarning), \
                pytest.raises(RuntimeError, match="device='cpu'"):
            build(devices=2)
        with pytest.raises(AssertionError, match="Mesh"):
            build(device=CPU, mesh=["cpu", "cpu"])
        with pytest.raises(AssertionError, match="not both"):
            build(device=CPU, devices=2, mesh=make_data_mesh([CPU] * 2))
        with pytest.raises(AssertionError, match="first entry"):
            build(device="meta", devices=[CPU] * 2)
        one = build(device=CPU, devices=1)
        assert one.stats()["devices"] == 1 and one.device.type == "cpu"


def test_device_none_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gcv.compile(_graph("b6"))


# ------------------------------------------------------ lifecycle ----------
def test_warmup_captures_nothing_on_the_cpu_and_freezes_misses():
    clear_caches()
    model = gcv.compile(_graph("b6"), options=OPTS, device=CPU)
    assert model.warmup() == set()
    assert model.warmup(batches=[1, 2]) == set()
    assert model.aot_compile() is None
    misses = cache_stats()["runner_misses"]
    assert misses == 3                # per-sample; batches 1 and 2, jit=True
    run = model.batched(2, jit=True)
    samples = [random_inputs(model.plan, seed=s) for s in range(2)]
    for _ in range(3):
        run(**stack_inputs(samples))
        model.run(**samples[0])
    assert cache_stats()["runner_misses"] == misses
    assert run.trace_count() == 0 and model.stats()["captures"] == 0


def _swap_model():
    b = GraphBuilder("swap_me")
    rng = np.random.default_rng(0)
    x = b.input((4, 8), name="x")
    w1 = rng.standard_normal((8, 8)).astype(np.float32)
    w2 = rng.standard_normal((8, 2)).astype(np.float32)
    h = b.linear(x, w1, name="l1")
    h = b.act(h, "relu")
    h = b.linear(h, w2, name="l2")
    samples = [{"x": rng.standard_normal((4, 8)).astype(np.float32)}
               for _ in range(2)]
    return gcv.compile(b.output(h), options=OPTS, device=CPU), w1, w2, \
        samples


def test_swap_weights_in_place_without_recapture():
    model, w1, w2, samples = _swap_model()
    stacked = stack_inputs(samples)
    before = model.batched(2, jit=True)(**stacked)[0]
    model.swap_weights({"l1": {"w": w1 * 2.0}})   # first swap: goes private
    run = model.batched(2, jit=True)
    assert not torch.equal(before, run(**stacked)[0])
    l1 = next(op for op in model.plan.ops if op.name == "l1")
    ptr = run.resident.get(l1, "w").data_ptr()
    model.swap_weights({"l1": {"w": w1}})         # second swap: in place
    assert model.batched(2, jit=True) is run
    assert run.resident.get(l1, "w").data_ptr() == ptr
    assert torch.equal(run(**stacked)[0], before)
    assert run.trace_count() == 0
    one = model.run(**samples[0])[0]
    ref = gcv.compile(model.plan, device=CPU).run(**samples[0])[0]
    assert torch.equal(one, ref)
    model.swap_weights({("l2", "w"): w2 * 3.0})   # flat-key spelling
    assert not torch.equal(one, model.run(**samples[0])[0])
    assert model.stats()["swapped_slots"] == 2


def test_swap_weights_does_not_leak_into_shared_cache():
    clear_caches()
    g = _graph("b6")
    a = gcv.compile(g, options=OPTS, device=CPU)
    other = gcv.compile(g, options=OPTS, device=CPU)
    ins = random_inputs(a.plan, seed=SEED)
    stacked = stack_inputs([ins, ins])
    ref = other.batched(2, jit=True)(**stacked)[0]
    target = next(op for op in a.plan.ops
                  if op.weights.get("w") is not None)
    a.swap_weights({target.name: {"w": np.asarray(target.weights["w"]) * 5}})
    assert not torch.equal(ref, a.batched(2, jit=True)(**stacked)[0])
    assert torch.equal(ref, other.batched(2, jit=True)(**stacked)[0])


def test_swap_weights_rejects_unknown_slots_and_no_residency():
    model = gcv.compile(_graph("b6"), options=OPTS, device=CPU)
    with pytest.raises(AssertionError, match="unknown weight slots"):
        model.swap_weights({"nope": {"w": np.zeros(1, np.float32)}})
    off = gcv.compile(_graph("b6"), options=OPTS, residency=False,
                      device=CPU)
    with pytest.raises(AssertionError, match="residency"):
        off.swap_weights({"anything": {"w": np.zeros(1, np.float32)}})


def test_input_specs_and_stats_and_lint():
    model = gcv.compile(_graph("b6"), options=OPTS, device=CPU)
    assert model.input_specs == {"points": ((64, 3), torch.float32)}
    s = model.stats()
    assert s["frontend"] == "builder" and s["ops"] == len(model.plan.ops)
    assert s["resident_bytes"] == s["param_bytes"] > 0
    assert "value_deduped_bytes" in s
    assert s["peak_live_bytes"] == model.plan.peak_live_bytes()
    assert s["device"] == "cpu" and s["cache"]["plans"] >= 1
    text = model.lint()
    assert "GraphBuilder" in text and "kernel choices for" in text
    assert all(op.name in text for op in model.plan.ops)


def test_compiled_model_uses_shared_plan_and_runner_cache():
    clear_caches()
    g = _graph("b6")
    m1 = gcv.compile(g, options=OPTS, device=CPU)
    m2 = gcv.compile(g, options=OPTS, device=CPU)
    assert m1.plan is m2.plan
    assert m1.batched(2, jit=True) is m2.batched(2, jit=True)
    stats = cache_stats()
    assert stats["runner_misses"] == 1 and stats["runner_hits"] == 1
    assert stats["plan_misses"] == 1


def test_runner_cache_keys_on_device():
    from repro_torch.core.runtime import cache
    clear_caches()
    g = _graph("b4")
    run = cache.cached_runner(g, OPTS, device=CPU)
    assert cache.cached_runner(g, OPTS, device=torch.device("cpu")) is run
    assert run.device == torch.device("cpu")
    (key,) = cache._RUNNERS[g]
    assert torch.device("cpu") in key


def test_gcv_random_inputs_match_specs():
    model = gcv.compile(_graph("b4"), options=OPTS, batch=3, device=CPU)
    ins = model.random_inputs(seed=0)
    assert ins["skeleton"].shape[0] == 3
    per_sample = model.random_inputs(seed=0, batch=None)
    assert per_sample["skeleton"].shape == model.input_specs["skeleton"][0]


# ------------------------------------------------- profile and tracing ----
def test_profile_report_times_every_op_and_predicts_nothing():
    """Kept under its earlier name.  Checks that every op now records
    its bound kernel's prediction, and that off the card only the twins
    can be timed, so no op has two measurable rivals and the agreement
    rate stays None."""
    model = gcv.compile(_graph("b4"), options=OPTS, device=CPU)
    prof = model.profile(repeats=1)
    assert list(prof) == [op.name for op in model.plan.ops]
    choices = model.plan.meta["kernel_choices"]
    assert all(r["s"] > 0 and r["predicted_s"]
               == choices[name]["predicted_s"][r["kernel"]]
               for name, r in prof.items())
    report = model.profile_report(repeats=1)
    assert report["agreement"] == {"agree": 0, "considered": 0,
                                   "rate": None}
    assert report["backend"] == "cpu" and len(report["rows"]) == len(prof)
    assert "no op with two measurable candidates" in report["text"]


def test_trace_to_writes_the_runner_spans(tmp_path):
    path = tmp_path / "trace.json"
    with gcv.trace_to(str(path)):
        model = gcv.compile(build_task("b6", small=True), telemetry=True,
                            device=CPU)
        model.warmup()
        model.run(**model.random_inputs())
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"compile", "build_runner", "residency.upload"} <= names
