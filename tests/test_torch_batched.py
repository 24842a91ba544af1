"""The port's batched runners and device-resident weight store against the
JAX reference, on the CPU.

- ``build_runner(plan, device="cpu", batch=3)`` against the reference's
  ``build_runner(plan_ref, batch=3, jit=False)`` on b1, b2, b3-r50/r101,
  b4, b5, b6, b6-dyn and the masked VIP (small configs, the same seeded
  numpy inputs, parameters carried across with ``load_weights``):
  ``max|Δ| <= 1e-5 · max|ref|`` for b1-b3 and the VIP (deep fp32 conv and
  affinity chains summed in another order), ``1e-6`` for b4 (the
  reference's own batched program differs from its per-sample one by
  3.3e-7 there: its vmapped convs run as one GEMM), ``3e-7`` for the rest.
  Each batched sample also against the port's own per-sample run, within
  the same bounds, but ``3e-7`` for b4 (the port's batch drifts 1.6e-7
  there): on the CPU the kernels' plain versions (MKL, oneDNN) may sum in
  another order at another batch size.  On the card the batch is held
  to the per-sample run bit for bit (``tests/test_torch_cuda.py``).
- The store's counts equal the reference's ``collect_params(plan,
  device=False)`` on every task: arrays, bytes, bytes folded by content,
  ``plan_param_bytes``.  Counterparts of ``tests/test_residency.py``'s
  dedup (identity, content, per-op ELL copies, a shared adjacency, ELL
  superseding the dense operand) and swap cases (in place, un-aliasing,
  refusing a shape change).
- COO sums in a fixed order: the row order's layout, and the sum equal to
  the reference's ``jax.ops.segment_sum`` within 1e-6 of max|out|.
- Runner basics: ``jit=True`` on the CPU runs eagerly, ``aot_compile()``
  is None, a batched runner refuses a missing or wrong batch axis,
  ``stack_inputs`` stacks on the host, a malformed ``mesh=`` is refused.
"""
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.core.executor import stack_inputs as ref_stack_inputs
from repro.core.ir import GraphBuilder as RefBuilder
from repro.core.runtime.residency import collect_params as ref_collect
from repro.core.runtime.residency import plan_param_bytes as ref_param_bytes
from repro.gnncv.jax_tasks import build_traced_task
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs, stack_inputs
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.plan import ExecutionPlan, MatOp
from repro_torch.core.runtime import run_op
from repro_torch.core.runtime.elementwise import segment_sum
from repro_torch.core.runtime.residency import (collect_params, ell_pair,
                                                host_row_order, opt_weight,
                                                plan_param_bytes, row_order,
                                                weight)
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_dynamic_task, build_task
from repro_torch.launch.mesh import Mesh, make_data_mesh

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cuda import vip_masked_graph  # noqa: E402
from test_torch_dynamic import dyn_inputs  # noqa: E402
from test_torch_runtime import exported  # noqa: E402

TASKS = ["b1", "b2", "b3-r50", "b3-r101", "b4", "b5", "b6", "b6-dyn",
         "vip-masked"]
RTOL = {"b1": 1e-5, "b2": 1e-5, "b3-r50": 1e-5, "b3-r101": 1e-5,
        "vip-masked": 1e-5, "b4": 1e-6}
RTOL_REST = 3e-7
SELF_RTOL = {**RTOL, "b4": RTOL_REST}       # batch against per-sample
COO_RTOL = 1e-6
BATCH = 3
VIP = dict(side=8, feat=16, win=3)


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


def graphs(task):
    """-> (port graph, reference graph) of one task at its small config."""
    if task == "b6-dyn":
        return (build_dynamic_task(task, small=True),
                build_traced_task(task, small=True))
    if task == "vip-masked":
        return (vip_masked_graph(GraphBuilder, **VIP),
                vip_masked_graph(RefBuilder, **VIP))
    return build_task(task, small=True), ref_build_task(task, small=True)


@functools.lru_cache(maxsize=None)
def plans(task, ref_mode="pallas", port_mode="cuda"):
    """-> (port plan carrying the reference's parameters, reference plan)."""
    port_graph, ref_graph = graphs(task)
    ref = ref_compile(ref_graph, RefOptions(target="fpga", kernels=ref_mode))
    plan = compile_graph(port_graph, CompileOptions(kernels=port_mode))
    load_weights(plan, exported(ref))
    return plan, ref


def samples(task, ref, n=BATCH):
    if task == "b6-dyn":
        return [dyn_inputs(ref.meta["input_shapes"]["points"][0], seed)
                for seed in range(n)]
    if task == "vip-masked":
        rng = np.random.default_rng(2)
        return [{"nodes": (rng.standard_normal((64, 16)) * 0.25).astype(
            np.float32)} for _ in range(n)]
    return [ref_random_inputs(ref, seed=seed) for seed in range(n)]


# ------------------------------------------------ batched vs reference ----
@pytest.mark.parametrize("task", TASKS)
def test_batched_runner_matches_reference_batched_runner(task):
    plan, ref = plans(task)
    ins = samples(task, ref)
    got = build_runner(plan, device="cpu", batch=BATCH)(**stack_inputs(ins))
    want = ref_build_runner(ref, batch=BATCH, jit=False)(
        **ref_stack_inputs(ins))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == BATCH and torch.isfinite(g).all()
        close(g.numpy(), np.asarray(w), RTOL.get(task, RTOL_REST))


@pytest.mark.parametrize("task", TASKS)
def test_batched_samples_match_per_sample_runs(task):
    plan, ref = plans(task)
    ins = samples(task, ref)
    batched = build_runner(plan, device="cpu", batch=BATCH)(
        **stack_inputs(ins))
    one = build_runner(plan, device="cpu")
    for i, sample in enumerate(ins):
        for b, s in zip(batched, one(**sample)):
            close(b[i].numpy(), s.numpy(), SELF_RTOL.get(task, RTOL_REST))


@pytest.mark.parametrize("task", ["b4", "b6", "b5", "b6-dyn"])
def test_plain_plan_batch_loops_per_sample_bit_for_bit(task):
    """Under ``kernels="torch"`` no op has a native batching rule that
    computes (the plain versions loop per sample), so the batch is the
    per-sample runs bit for bit, even on the CPU."""
    plan, ref = plans(task, "xla", "torch")
    ins = samples(task, ref)
    batched = build_runner(plan, device="cpu", batch=BATCH)(
        **stack_inputs(ins))
    one = build_runner(plan, device="cpu")
    for i, sample in enumerate(ins):
        for b, s in zip(batched, one(**sample)):
            assert torch.equal(b[i], s)


# ------------------------------------------------ residency vs reference --
@pytest.mark.parametrize("ref_mode,port_mode", [("xla", "torch"),
                                                ("pallas", "cuda")])
@pytest.mark.parametrize("task", TASKS)
def test_store_counts_match_reference(task, ref_mode, port_mode):
    """Each package's own plan (``load_weights`` copies every array, which
    would break ``GraphBuilder``'s sharing by identity)."""
    port_graph, ref_graph = graphs(task)
    ref = ref_compile(ref_graph, RefOptions(target="fpga", kernels=ref_mode))
    plan = compile_graph(port_graph, CompileOptions(kernels=port_mode))
    ours, theirs = collect_params(plan, "cpu"), ref_collect(ref,
                                                            device=False)
    assert len(ours.arrays) == len(theirs.arrays)
    assert len(ours.slots) == len(theirs.slots)
    assert ours.nbytes() == theirs.nbytes() > 0
    assert ours.value_dedup_bytes == theirs.value_dedup_bytes
    assert plan_param_bytes(plan) == ref_param_bytes(ref) == ours.nbytes()


def _shared_plan(a, b=None, c=None):
    ops = [MatOp("a", "mm", ("x",), weights={"w": a},
                 attrs={"weight_side": "right"}, out_shape=(4, 4),
                 kernel="torch_dense"),
           MatOp("b", "mm", ("a",), weights={"w": a if b is None else b},
                 attrs={"weight_side": "right"}, out_shape=(4, 4),
                 kernel="torch_dense")]
    if c is not None:
        ops.append(MatOp("c", "mm", ("b",), weights={"w": c},
                         attrs={"weight_side": "right"}, out_shape=(4, 4),
                         kernel="torch_dense"))
    return ExecutionPlan("shared", ["x"], ops, [ops[-1].name],
                         meta={"input_shapes": {"x": (4, 4)}})


def test_store_dedups_by_identity():
    shared = np.ones((4, 4), np.float32)
    params = collect_params(_shared_plan(shared), "cpu")
    assert params.slots[("a", "w")] == params.slots[("b", "w")]
    assert len(params.arrays) == 1
    assert params.nbytes() == shared.nbytes
    assert plan_param_bytes(_shared_plan(shared)) == shared.nbytes


def test_store_dedups_by_content():
    a = np.arange(16, dtype=np.float32).reshape(4, 4)
    c = a + 1.0
    plan = _shared_plan(a, a.copy(), c)
    params = collect_params(plan, "cpu")
    assert params.slots[("a", "w")] == params.slots[("b", "w")]
    assert params.slots[("c", "w")] != params.slots[("a", "w")]
    assert len(params.arrays) == 2
    assert params.value_dedup_bytes == a.nbytes
    assert params.nbytes() == plan_param_bytes(plan) == a.nbytes + c.nbytes


def test_content_dedup_folds_per_op_ell_copies():
    rng = np.random.default_rng(3)
    adj = (rng.random((12, 12)) < 0.2).astype(np.float32)
    b = GraphBuilder("ell_copies")
    x = b.input((12, 8), name="x")
    plan = compile_graph(b.output(b.mp(b.mp(x, adj=adj.copy()),
                                       adj=adj.copy())))
    ell_ops = [op for op in plan.ops if op.ell is not None]
    assert len(ell_ops) == 2 and ell_ops[0].ell[0] is not ell_ops[1].ell[0]
    params = collect_params(plan, "cpu")
    for slot in ("ell_idx", "ell_val"):
        assert params.slots[(ell_ops[0].name, slot)] == \
            params.slots[(ell_ops[1].name, slot)]
    assert params.value_dedup_bytes > 0
    ins = random_inputs(plan, seed=7)
    for got, want in zip(build_runner(plan, device="cpu")(**ins),
                         build_runner(plan, device="cpu",
                                      residency=False)(**ins)):
        assert torch.equal(got, want)


def test_shared_adjacency_uploads_once():
    rng = np.random.default_rng(0)
    adj = (rng.random((12, 12)) < 0.8).astype(np.float32)
    b = GraphBuilder("shared_adj")
    x = b.input((12, 8), name="x")
    plan = compile_graph(b.output(b.mp(b.mp(x, adj=adj), adj=adj)))
    mp_ops = [op for op in plan.ops if "adj" in op.weights]
    assert len(mp_ops) == 2
    params = collect_params(plan, "cpu")
    assert len({params.slots[(op.name, "adj")] for op in mp_ops
                if params.has(op, "adj")}) <= 1


@pytest.mark.parametrize("task", ["b6", "b2", "b4"])
def test_ell_supersedes_dense_operand(task):
    plan = compile_graph(build_task(task, small=True))
    params = collect_params(plan, "cpu")
    for op in plan.ops:
        if op.ell is not None and op.primitive == "SpDMM":
            assert not params.has(op, "adj") and not params.has(op, "w")
            assert params.has(op, "ell_idx") and params.has(op, "ell_val")


def test_handler_seam_falls_back_without_params():
    idx = np.zeros((3, 2), np.int32)
    val = np.ones((3, 2), np.float32)
    op = MatOp("o", "mm", ("x",),
               weights={"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                        "b": None},
               attrs={"weight_side": "right"}, out_shape=(3,),
               ell=(idx, val), kernel="torch_ell_spdmm")
    plan = ExecutionPlan("p", ["x"], [op], ["o"],
                         meta={"input_shapes": {"x": (2,)}})
    params = collect_params(plan, "cpu")
    assert opt_weight(op, "b", params) is None is opt_weight(op, "b", None)
    for a, b in zip(ell_pair(op, params), ell_pair(op, None)):
        assert torch.equal(a, b)
    assert not params.has(op, "w")            # ELL-bound: w is dead
    op.kernel = "torch_dense"
    params = collect_params(plan, "cpu")
    assert torch.equal(weight(op, "w", params), weight(op, "w", None))


# --------------------------------------------------------------- swaps ---
def _two_linears(b1, b2, seed=1):
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((8, 8)).astype(np.float32)
    w2 = rng.standard_normal((8, 8)).astype(np.float32)
    b = GraphBuilder("alias_swap")
    x = b.input((4, 8), name="x")
    h = b.linear(x, w1, b=b1, name="l1")
    h = b.linear(h, w2, b=b2, name="l2")
    return compile_graph(b.output(h)), w2


def test_swap_writes_in_place():
    plan = compile_graph(build_task("b6", small=True))
    run = build_runner(plan, device="cpu", batch=2)
    ins = stack_inputs([random_inputs(plan, seed=s) for s in range(2)])
    before = run(**ins)[0]
    target = next(op for op in plan.ops if op.weights.get("w") is not None)
    old = np.asarray(target.weights["w"])
    buf = run.resident.get(target, "w")
    ptr, version = buf.data_ptr(), run.resident.version
    run.resident.swap(target.name, "w", old * 2.0)
    after = run(**ins)[0]
    assert not torch.equal(before, after)
    assert run.resident.get(target, "w").data_ptr() == ptr
    assert run.resident.version == version and run.trace_count() == 0
    assert np.array_equal(target.weights["w"], old)   # the plan is intact
    run.resident.swap(target.name, "w", torch.from_numpy(old))
    assert torch.equal(run(**ins)[0], before)


def test_swap_unaliases_content_folded_slots():
    plan, w2 = _two_linears(np.zeros(8, np.float32), np.zeros(8, np.float32))
    run = build_runner(plan, device="cpu", batch=2)
    res = run.resident
    assert res.slots[("l1", "b")] == res.slots[("l2", "b")]      # folded
    rng = np.random.default_rng(1)
    ins = stack_inputs([{"x": rng.standard_normal((4, 8)).astype(
        np.float32)} for _ in range(2)])
    base = run(**ins)[0].numpy()
    delta = np.full(8, 0.5, np.float32)
    version = res.version
    res.swap("l1", "b", delta)
    assert res.slots[("l1", "b")] != res.slots[("l2", "b")]      # split
    assert res.version == version + 1
    np.testing.assert_allclose(run(**ins)[0].numpy(), base + delta @ w2,
                               rtol=1e-4, atol=1e-5)
    shared = np.zeros(8, np.float32)
    plan2, _ = _two_linears(shared, shared)
    res2 = build_runner(plan2, device="cpu").resident
    res2.swap("l1", "b", delta)
    assert res2.slots[("l1", "b")] == res2.slots[("l2", "b")]
    assert res2.version == 0


def test_swap_rejects_shape_change():
    plan = compile_graph(build_task("b6", small=True))
    run = build_runner(plan, device="cpu", batch=2)
    target = next(op for op in plan.ops if op.weights.get("w") is not None)
    with pytest.raises(AssertionError, match="shape"):
        run.resident.swap(target.name, "w", np.zeros((1, 1), np.float32))


def test_store_is_never_trace_constants():
    run = build_runner(compile_graph(build_task("b6", small=True)),
                       device="cpu", jit=True)
    assert run.resident.trace_constants is False


# ------------------------------------------------------------ COO sums ---
def test_row_order_sorts_edges_stably_by_row():
    seg = np.array([2, 0, 2, 1, 2, 0], np.int32)
    perm, lengths = host_row_order(seg, 4)
    assert perm.dtype == lengths.dtype == np.int64
    np.testing.assert_array_equal(perm, [1, 5, 3, 0, 2, 4])
    np.testing.assert_array_equal(lengths, [2, 1, 3, 0])
    perm, lengths = host_row_order(np.zeros(0, np.int32), 2)
    assert perm.shape == (0,) and lengths.tolist() == [0, 0]


@pytest.mark.parametrize("width", [(), (6,)], ids=["1d", "2d"])
def test_segment_sum_matches_jax_segment_sum(width):
    """Within 1e-6 of ``jax.ops.segment_sum``; on the CPU each row adds in
    edge order, so it equals ``index_add_`` bit for bit."""
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 50, 400).astype(np.int32)
    seg[seg == 7] = 8                              # an empty row
    x = rng.standard_normal((400, *width)).astype(np.float32)
    perm, lengths = map(torch.from_numpy, host_row_order(seg, 50))
    got = segment_sum(torch.from_numpy(x)[perm], lengths)
    want = np.asarray(jax.ops.segment_sum(x, seg, 50))
    assert (got[7] == 0).all()
    close(got.numpy(), want, COO_RTOL)
    assert torch.equal(got, torch.zeros(50, *width).index_add_(
        0, torch.from_numpy(seg).long(), torch.from_numpy(x)))


@pytest.mark.parametrize("task", ["b5", "b6"])
def test_coo_task_matches_reference_within_coo_bound(task):
    plan, ref = plans(task, "xla", "torch")
    assert any("coo_rows" in op.weights for op in plan.ops)
    for ins in samples(task, ref, 2):
        got = build_runner(plan, device="cpu")(**ins)[0].numpy()
        close(got, np.asarray(ref_build_runner(ref)(**ins)[0]), COO_RTOL)


def test_coo_row_order_follows_a_swap_of_the_rows():
    plan = compile_graph(build_task("b5", small=True))
    op = next(op for op in plan.ops if op.attrs.get("weight_side")
              == "left_coo" and op.attrs.get("reduce", "sum") == "sum")
    run = build_runner(plan, device="cpu")
    n = op.attrs["n"]
    rows = np.asarray(op.weights["coo_rows"])
    flipped = (n - 1 - rows).astype(rows.dtype)
    before = [t.data_ptr() for t in row_order(op, "coo_rows", n,
                                              run.resident)]
    run.resident.swap(op.name, "coo_rows", flipped)
    got = row_order(op, "coo_rows", n, run.resident)
    for t, a, ptr in zip(got, host_row_order(flipped, n), before):
        assert torch.equal(t, torch.from_numpy(a)) and t.data_ptr() == ptr
    assert run.resident.version == 0               # in place: no re-capture


def test_run_op_without_params_derives_the_row_order():
    plan = compile_graph(build_task("b5", small=True))
    op = next(op for op in plan.ops if op.attrs.get("weight_side")
              == "left_coo")
    run = build_runner(plan, device="cpu", free_dead=False)
    env = {k: torch.from_numpy(v) for k, v in
           random_inputs(plan, seed=0).items()}
    for o in plan.ops[:plan.ops.index(op)]:
        env[o.name] = run_op(o, env, run.resident)
    assert torch.equal(run_op(op, env, run.resident), run_op(op, env))


# -------------------------------------------------------- runner basics --
def test_jit_on_the_cpu_runs_eagerly():
    plan = compile_graph(build_task("b4", small=True))
    run = build_runner(plan, device="cpu", jit=True)
    assert run.jit is False and run.aot_compile() is None
    ins = random_inputs(plan, seed=0)
    assert torch.equal(run(**ins)[0],
                       build_runner(plan, device="cpu", jit=False)(**ins)[0])
    assert run.trace_count() == 0


def test_batched_runner_checks_batch_axis():
    plan = compile_graph(build_task("b6", small=True))
    run = build_runner(plan, device="cpu", batch=4, jit=False)
    with pytest.raises(AssertionError, match="leading batch axis"):
        run(**random_inputs(plan, seed=0, batch=2))
    with pytest.raises(AssertionError, match="leading batch axis"):
        run(**random_inputs(plan, seed=0))
    with pytest.raises(AssertionError, match="missing inputs"):
        run()


def test_random_inputs_and_input_specs_carry_the_batch_axis():
    plan = compile_graph(build_task("b4", small=True))
    ins = random_inputs(plan, seed=3, batch=2)
    assert ins["skeleton"].shape == (2, *plan.meta["input_shapes"][
        "skeleton"])
    np.testing.assert_array_equal(
        ins["skeleton"], ref_random_inputs(plans("b4")[1], seed=3,
                                           batch=2)["skeleton"])
    spec = build_runner(plan, device="cpu", batch=2).input_specs()
    assert spec == {"skeleton": (ins["skeleton"].shape, torch.float32)}


def test_stack_inputs_stacks_on_the_host():
    plan = compile_graph(build_task("b4", small=True))
    ins = [random_inputs(plan, seed=s) for s in range(3)]
    stacked = stack_inputs(ins)
    assert isinstance(stacked["skeleton"], np.ndarray)
    np.testing.assert_array_equal(stacked["skeleton"],
                                  np.stack([i["skeleton"] for i in ins]))
    tens = stack_inputs([{k: torch.from_numpy(v) for k, v in i.items()}
                         for i in ins])
    assert torch.equal(tens["skeleton"],
                       torch.from_numpy(stacked["skeleton"]))
    with pytest.raises(AssertionError, match="empty"):
        stack_inputs([])


def test_mesh_names_its_roadmap_item():
    """Kept under its earlier name, from when ``mesh=`` raised for ROADMAP
    item 6.  Now a mesh shards the batch (``tests/test_torch_sharded.py``):
    a malformed one is refused, a one-entry mesh is the plain runner, and
    a two-entry mesh runs two replicas of one row each."""
    plan = compile_graph(build_task("b4", small=True))
    with pytest.raises(AssertionError, match="Mesh"):
        build_runner(plan, device="cpu", batch=2, mesh=object())
    grid = make_data_mesh(["cpu", "cpu"]).devices.reshape(1, 2)
    with pytest.raises(AssertionError, match="1-D"):
        build_runner(plan, device="cpu", batch=2,
                     mesh=Mesh(grid, ("data", "model")))
    one = build_runner(plan, batch=2, mesh=make_data_mesh(["cpu"]))
    assert one.mesh is None and len(one.replicas) == 1
    two = build_runner(plan, batch=2, mesh=make_data_mesh(["cpu"] * 2))
    assert two.mesh.size == 2 and two.resident.replicas == 2
    ins = stack_inputs([random_inputs(plan, seed=s) for s in range(2)])
    assert two(**ins)[0].shape == one(**ins)[0].shape


def test_residency_off_stages_per_call_and_matches():
    plan = compile_graph(build_task("b5", small=True))
    ins = random_inputs(plan, seed=0)
    off = build_runner(plan, device="cpu", residency=False)
    assert off.resident is None
    assert torch.equal(off(**ins)[0],
                       build_runner(plan, device="cpu")(**ins)[0])
