"""Traced tasks (``repro_torch.gnncv.torch_tasks``) against the port's
builder plans and the JAX reference's traced plans, on the CPU, at
``TRACED_SMALL_CONFIGS``.

Counterpart of ``tests/test_frontend_parity.py`` and the traced cases of
``test_dynamic_graphs.py``:

- b1-b6, b3-r101 and b6-dyn: the traced plan equals the port's builder
  plan **up to names** (``core.plan.differences_up_to_names``) — the same
  ops in the same order, kinds, primitives, kernels, attrs (a fused
  residual names its op's counterpart; a softmax axis is read modulo the
  rank, the builder spells ``-1`` where the tracer, like the reference's,
  spells ``1``), wiring, shapes, liveness, tiles and costs, the same ELL
  conversions, weights bit for bit — and the two plans' outputs are equal
  bit for bit.  Portions are not
  compared here: the builder tags them per section, the tracer by layer
  kind, as the reference's does;
- all ten tasks: the traced plan equals the reference's
  ``build_traced_task`` plan up to names, portions included, under both
  kernel-mode pairs (``xla``/``torch``, ``pallas``/``cuda``); with the
  reference's parameters carried across by op position
  (``load_weights``), the outputs are within ``1e-5 · max|ref|``;
- every task's plan runs to its torch function's direct result;
- b7-dyn equals its ``precomputed_graph`` twin bit for bit, and b6, b7 and
  b7-dyn serve batched (batch 3 == three batch-1 runs, bit for bit, under
  ``kernels="torch"``, whose batches loop per sample on the CPU), also
  through ``gcv.serve``.
"""
import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.gnncv.jax_tasks import build_traced_task as ref_build_traced
from repro_torch import gcv
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs, stack_inputs
from repro_torch.core.plan import differences_up_to_names
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import TASKS as BUILDER_TASKS
from repro_torch.gnncv.tasks import build_dynamic_task, build_task
from repro_torch.gnncv.torch_tasks import (TRACED_SMALL_CONFIGS,
                                           TRACED_TASKS, build_traced_task)
from repro_torch.kernels.ref import conv2d_ref, knn_ref

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_compiler import port_kernel  # noqa: E402
from test_torch_dynamic import dyn_inputs  # noqa: E402
from test_torch_runtime import exported  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
SEED = 7
TASKS = ["b1", "b2", "b3-r50", "b3-r101", "b4", "b5", "b6", "b6-dyn", "b7",
         "b7-dyn"]
WITH_BUILDER = TASKS[:8]
MODES = [("xla", "torch"), ("pallas", "cuda")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def traced_graph(task):
    return build_traced_task(task, small=True)


@functools.lru_cache(maxsize=None)
def traced_plan(task, mode="cuda"):
    return compile_graph(traced_graph(task),
                         CompileOptions(target="fpga", kernels=mode))


@functools.lru_cache(maxsize=None)
def builder_plan(task):
    g = build_dynamic_task(task, small=True) if task == "b6-dyn" else \
        build_task(task, small=True)
    return compile_graph(g, CompileOptions(target="fpga"))


@functools.lru_cache(maxsize=None)
def ref_plan(task, mode="pallas"):
    return ref_compile(ref_build_traced(task, small=True),
                       RefOptions(target="fpga", kernels=mode))


def inputs_for(plan, task, seed=SEED):
    if task == "b6-dyn":
        return dyn_inputs(plan.meta["input_shapes"]["points"][0], seed)
    return random_inputs(plan, seed=seed)


def assert_same_plan_up_to_names(port, other, *, portions=True,
                                 kernel=lambda k: k):
    diffs = differences_up_to_names(port, other, portions=portions,
                                    kernel=kernel)
    assert not diffs, diffs[:8]


def _bump_weight(plan):
    op = next(o for o in plan.ops if "w" in o.weights)
    w = np.array(op.weights["w"])
    w.flat[0] = np.nextafter(w.flat[0], np.float32(np.inf))
    op.weights["w"] = w


def _rewire(plan):
    op = plan.ops[-1]
    op.inputs = (plan.ops[0].name,) + tuple(op.inputs[1:])


PERTURBATIONS = {
    "weight one ulp": _bump_weight,
    "kernel": lambda p: setattr(p.ops[0], "kernel", "torch_dense"),
    "fused act": lambda p: p.ops[0].attrs.update(fused_act=None),
    "wiring": _rewire,
    "shape": lambda p: setattr(p.ops[-1], "out_shape", (41,)),
    "frees": lambda p: setattr(p.ops[0], "frees",
                               () if p.ops[0].frees else ("points",)),
    "portion": lambda p: setattr(p.ops[0], "portion", "cnn"),
}


@pytest.mark.parametrize("what", sorted(PERTURBATIONS))
def test_plan_comparison_catches_each_difference(what):
    """``differences_up_to_names`` sees each kind of change it claims to
    compare (and nothing in a renamed copy)."""
    plan = traced_plan("b6")
    renamed = copy.deepcopy(plan)
    names = {op.name: f"op{i}" for i, op in enumerate(renamed.ops)}
    for op in renamed.ops:
        op.name = names[op.name]
        op.inputs = tuple(names.get(i, i) for i in op.inputs)
        op.frees = tuple(names.get(f, f) for f in op.frees)
    renamed.outputs = [names[o] for o in renamed.outputs]
    assert differences_up_to_names(plan, renamed) == []
    PERTURBATIONS[what](renamed)
    assert differences_up_to_names(plan, renamed)


def by_position(port, ref) -> dict:
    """The reference plan's parameters keyed by the port op at the same
    position (traced names differ), after checking kinds and shapes."""
    out = {}
    params = exported(ref)
    for p, r in zip(port.ops, ref.ops):
        assert (p.kind, tuple(p.out_shape)) == (r.kind, tuple(r.out_shape))
        if r.name in params:
            out[p.name] = params[r.name]
    return out


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


# --------------------------------------------- traced vs the port's builder
@pytest.mark.parametrize("task", WITH_BUILDER)
def test_traced_plan_equals_builder_plan_up_to_names(task):
    assert traced_graph(task).meta["frontend"] == "tracer"
    assert traced_plan(task).meta["frontend"] == "tracer"
    assert_same_plan_up_to_names(traced_plan(task), builder_plan(task),
                                 portions=False)


@pytest.mark.parametrize("task", WITH_BUILDER)
def test_traced_outputs_equal_builder_outputs_bit_for_bit(task):
    ins = inputs_for(builder_plan(task), task)
    mine = build_runner(traced_plan(task), device=CPU)(**ins)
    theirs = build_runner(builder_plan(task), device=CPU)(**ins)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)


# ------------------------------------------ traced vs the reference's trace
@pytest.mark.parametrize("ref_mode,port_mode", MODES)
@pytest.mark.parametrize("task", TASKS)
def test_traced_plan_equals_reference_traced_plan(task, ref_mode, port_mode):
    assert_same_plan_up_to_names(traced_plan(task, port_mode),
                                 ref_plan(task, ref_mode),
                                 kernel=port_kernel)


@pytest.mark.parametrize("task", TASKS)
def test_traced_outputs_match_the_reference(task):
    """Within 1e-5 of max|ref| (fp32 sums in another order), with the
    reference's parameters loaded into the port's plan by position."""
    ref = ref_plan(task)
    plan = compile_graph(build_traced_task(task, small=True, seed=3),
                         CompileOptions(target="fpga"))
    load_weights(plan, by_position(plan, ref))
    assert_same_plan_up_to_names(plan, ref, kernel=port_kernel)
    for seed in (0, 5):
        ins = inputs_for(plan, task, seed)
        got = build_runner(plan, device=CPU)(**ins)[0]
        close(got.numpy(), np.asarray(ref_build_runner(ref)(**ins)[0]))


@pytest.mark.parametrize("task", TASKS)
def test_traced_plan_runs_to_the_functions_direct_result(task):
    fn, _ = TRACED_TASKS[task](**TRACED_SMALL_CONFIGS[task])
    ins = inputs_for(traced_plan(task), task)
    got = build_runner(traced_plan(task), device=CPU)(**ins)[0]
    want = fn(**{k: torch.from_numpy(v) for k, v in ins.items()})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ b7 / b7-dyn
def test_b7_exists_only_as_a_traced_model():
    assert "b7" in TRACED_TASKS and "b7" not in BUILDER_TASKS
    assert "b7-dyn" in TRACED_TASKS


def test_b7_compiles_with_sparse_patch_graph_aggregation():
    g = traced_graph("b7")
    stats = g.stats()
    assert stats["mp"] == 2 and stats["dm"] == 1 and stats["conv"] == 1
    prims = traced_plan("b7").primitive_counts()
    assert prims.get("SpDMM", 0) >= 2
    conv = next(op for op in traced_plan("b7").ops if op.kind == "conv")
    # a conv bound to cuda_ddmm runs the shift-conv kernel
    assert conv.kernel == "cuda_ddmm" and conv.attrs["stride"] == (8, 8)


def test_b7_dyn_idiom_canonicalizes_without_leftovers():
    g = traced_graph("b7-dyn")
    stats = g.stats()
    assert stats["knn_graph"] == 1
    assert stats["mp"] == TRACED_SMALL_CONFIGS["b7-dyn"]["blocks"]
    assert "vip" not in stats
    layer = next(l for l in g.layers.values() if l.kind == "knn_graph")
    assert layer.params["k"] == TRACED_SMALL_CONFIGS["b7-dyn"]["knn"]
    assert not layer.params.get("self_loops")
    nodes = g.meta["aten_nodes"][layer.name]
    assert any(s.startswith("aten.sort.stable") for s in nodes), nodes
    assert traced_plan("b7-dyn").ops[2].kernel == "cuda_knn"


def test_b7_dyn_equals_its_precomputed_twin_bit_for_bit():
    """The traced dynamic graph and the same model with the graph baked in
    as a constant COO (indices replayed from the patch embedding the plan
    computes: the plain conv, then ``knn_ref``) give the same logits."""
    cfg = dict(TRACED_SMALL_CONFIGS["b7-dyn"])
    image = inputs_for(traced_plan("b7-dyn"), "b7-dyn")["image"]
    conv = next(op for op in traced_plan("b7-dyn").ops if op.kind == "conv")
    h = conv2d_ref(torch.from_numpy(image), torch.from_numpy(
        conv.weights["w"]), stride=cfg["patch"], padding="SAME")
    idx = knn_ref(h.reshape(cfg["dim"], -1).T, cfg["knn"])
    pre = compile_graph(build_traced_task(
        "b7-dyn", small=True, precomputed_graph=idx.numpy()))
    assert "knn_graph" not in [op.kind for op in pre.ops]
    dyn = build_runner(traced_plan("b7-dyn"), device=CPU)(image=image)[0]
    assert torch.equal(dyn, build_runner(pre, device=CPU)(image=image)[0])


@pytest.mark.parametrize("task", ["b6", "b7", "b7-dyn"])
def test_traced_plan_serves_batched(task):
    """Under ``kernels="torch"`` the batch loops the plain versions per
    sample, so it equals the batch-1 runs bit for bit on the CPU (the
    card holds the kernels' batches to that, ``test_torch_cuda.py``)."""
    plan = traced_plan(task, "torch")
    samples = [random_inputs(plan, seed=s) for s in range(3)]
    one = build_runner(plan, batch=1, device=CPU)
    single = [one(**stack_inputs([s]))[0][0] for s in samples]
    batched = build_runner(plan, batch=3, device=CPU)(
        **stack_inputs(samples))[0]
    for i, want in enumerate(single):
        assert torch.equal(batched[i], want)


def test_gcv_serves_b7_and_b7_dyn_pairs_like_batch_1_runs():
    pairs = {t: TRACED_TASKS[t](**TRACED_SMALL_CONFIGS[t])
             for t in ("b7", "b7-dyn")}
    eng = gcv.serve(pairs, max_batch=4, device=CPU, kernels="torch")
    reqs = []
    for s in range(6):
        task = ("b7", "b7-dyn")[s % 2]
        reqs.append(eng.submit(task, **eng.models[task].random_inputs(
            seed=s)))
    assert eng.run() == 6
    for r in reqs:
        want = eng.models[r.task].run(**r.inputs)[0]
        assert torch.equal(torch.as_tensor(r.result[0]), want)
