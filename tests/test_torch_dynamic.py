"""The port's dynamic-graph slice (b6-dyn) and its companions b6 and b5
against the JAX reference, on the CPU.

- b6-dyn's plan equals the reference's traced plan
  (``jax_tasks.build_traced_task("b6-dyn")``) op for op, weights bit for
  bit, small and full, under both mode pairs.
- b6-dyn, b6 and b5 end to end on ``device="cpu"`` (every kernel wrapper
  runs its plain version) against the reference runner, parameters carried
  across with ``load_weights``: ``max|Δ| <= 1e-5 · max|ref|`` (fp32 sums
  in another order; the reference drifts ~1e-7 relative here).
- The dynamic graph equals the same graph precomputed as a COO, exactly
  (max aggregation is order-independent); padding a cloud with masked
  points leaves its logits within 1e-6 relative.
- Every ``run_ew`` branch, every ``shape.py`` op and the gather sides of
  ``mm`` against the reference's own handlers within 1e-6 · max|ref|,
  including ``left_coo``'s empty-row fallback and NaN propagation.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.core.plan import MatOp as RefOp
from repro.core.runtime import elementwise as ref_elementwise
from repro.core.runtime import matmul as ref_matmul
from repro.core.runtime import shape as ref_shape
from repro.gnncv.graphs import knn_indices
from repro.gnncv.jax_tasks import build_traced_task
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.plan import MatOp
from repro_torch.core.runtime import run_op
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_dynamic_task, build_task

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_compiler import assert_same_plan  # noqa: E402
from test_torch_runtime import exported  # noqa: E402

RTOL = 1e-5
HANDLER_RTOL = 1e-6
MODES = [("xla", "torch"), ("pallas", "cuda")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return
    err = np.abs(got[ok] - want[ok]).max()
    assert err <= rtol * max(np.abs(want[ok]).max(), 1e-30), err


def dyn_inputs(n, seed, pad=None):
    """Standard-normal points; the mask zeroes the last ``pad`` points."""
    pad = n // 16 if pad is None else pad
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0.0
    pts = np.random.default_rng(seed).standard_normal((n, 3))
    return dict(points=pts.astype(np.float32), mask=mask)


def port_out(plan, inputs):
    return build_runner(plan, device="cpu")(**inputs)[0].numpy()


def ref_out(plan, inputs):
    return np.asarray(ref_build_runner(plan)(**inputs)[0])


# ------------------------------------------------------------- plans ---
@pytest.mark.parametrize("ref_mode,port_mode", MODES)
@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
def test_b6_dyn_plan_matches_traced_reference(small, ref_mode, port_mode):
    ref = ref_compile(build_traced_task("b6-dyn", small=small),
                      RefOptions(target="fpga", kernels=ref_mode))
    port = compile_graph(build_dynamic_task("b6-dyn", small=small),
                         CompileOptions(target="fpga", kernels=port_mode))
    assert_same_plan(port, ref)
    names = [op.name for op in port.ops]
    assert names[0] == "knn.1" and port.ops[0].kernel == f"{port_mode}_knn"
    if not small:
        assert names[-4:] == ["bcast.21", "ew.22", "reduce.23", "dot.24"]
        assert len(names) == 14


# ---------------------------------------------------------- end to end ---
@pytest.mark.parametrize("ref_mode,port_mode", MODES)
def test_b6_dyn_small_matches_reference(ref_mode, port_mode):
    ref = ref_compile(build_traced_task("b6-dyn", small=True),
                      RefOptions(target="fpga", kernels=ref_mode))
    plan = compile_graph(build_dynamic_task("b6-dyn", small=True, seed=3),
                         CompileOptions(kernels=port_mode))
    load_weights(plan, exported(ref))
    for seed in (0, 5):
        inputs = dyn_inputs(64, seed)
        got = port_out(plan, inputs)
        assert got.shape == (40,) and np.isfinite(got).all()
        close(got, ref_out(ref, inputs))


def test_b6_dyn_full_width_matches_reference():
    ref = ref_compile(build_traced_task("b6-dyn"),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(build_dynamic_task("b6-dyn"),
                         CompileOptions(kernels="cuda"))
    load_weights(plan, exported(ref))
    inputs = dyn_inputs(1024, seed=2, pad=64)
    close(port_out(plan, inputs), ref_out(ref, inputs))


@pytest.mark.parametrize("ref_mode,port_mode", MODES)
@pytest.mark.parametrize("task", ["b5", "b6"])
def test_small_tasks_match_reference(task, ref_mode, port_mode):
    ref = ref_compile(ref_build_task(task, small=True),
                      RefOptions(target="fpga", kernels=ref_mode))
    plan = compile_graph(build_task(task, small=True, seed=4),
                         CompileOptions(kernels=port_mode))
    load_weights(plan, exported(ref))
    for seed in (0, 7):
        inputs = ref_random_inputs(ref, seed=seed)
        got = port_out(plan, inputs)
        assert np.isfinite(got).all()
        close(got, ref_out(ref, inputs))


@pytest.mark.parametrize("task", ["b5", "b6"])
def test_full_width_tasks_match_reference(task):
    ref = ref_compile(ref_build_task(task),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(build_task(task), CompileOptions(kernels="cuda"))
    load_weights(plan, exported(ref))
    inputs = ref_random_inputs(ref, seed=1)
    close(port_out(plan, inputs), ref_out(ref, inputs))


# ------------------------------------------------- graph construction ---
def _builder_model(n, k, w, idx=None):
    """knn_graph + mp(knn_input) when ``idx`` is None, else the same
    aggregation over the equivalent precomputed COO."""
    b = GraphBuilder("dyn")
    pts = b.input((n, 3), "pts")
    h = b.act(b.linear(pts, w), "relu")
    if idx is None:
        h = b.mp(h, knn_input=b.knn_graph(pts, k=k), reduce="max")
    else:
        rows = np.repeat(np.arange(n, dtype=np.int32), k)
        h = b.mp(h, adj_coo=(rows, idx.reshape(-1).astype(np.int32),
                             np.ones(n * k, np.float32), n), reduce="max")
    return b.output(h)


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_builder_knn_matches_precomputed_coo(kernels):
    rng = np.random.default_rng(3)
    n, k = 60, 5
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    w = rng.standard_normal((3, 16)).astype(np.float32)
    opts = CompileOptions(kernels=kernels)
    dyn = compile_graph(_builder_model(n, k, w), opts)
    pre = compile_graph(_builder_model(n, k, w, knn_indices(pts, k)), opts)
    assert [op.kernel for op in dyn.ops][1] == f"{kernels}_knn"
    np.testing.assert_array_equal(port_out(dyn, dict(pts=pts)),
                                  port_out(pre, dict(pts=pts)))


def test_mask_padding_invariance():
    """A b6-dyn cloud padded with masked points gives the logits of the
    unpadded cloud, within 1e-6 relative (the padded run sums over a
    longer axis in the DDMMs' blocking)."""
    n = 40
    inputs = dyn_inputs(n, seed=8, pad=0)

    def run(n_points, points, mask):
        plan = compile_graph(build_dynamic_task("b6-dyn", small=True,
                                                n_points=n_points))
        return port_out(plan, dict(points=points, mask=mask))

    exact = run(n, **inputs)
    pad = 64 - n
    padded = run(64, np.concatenate([inputs["points"],
                                     np.zeros((pad, 3), np.float32)]),
                 np.concatenate([inputs["mask"], np.zeros(pad, np.float32)]))
    close(padded, exact, rtol=1e-6)


def test_knn_graph_handler_reads_mask_and_self_loops():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((30, 3)).astype(np.float32)
    mask = np.ones(30, np.float32)
    mask[25:] = 0.0
    env = {"x": torch.from_numpy(x), "m": torch.from_numpy(mask)}
    for kern in ("torch_knn", "cuda_knn"):
        op = MatOp("g", "knn_graph", ("x", "m"), {},
                   {"k": 4, "masked": True}, kernel=kern)
        np.testing.assert_array_equal(run_op(op, env).numpy(),
                                      knn_indices(x, 4, mask=mask))
        op = MatOp("g", "knn_graph", ("x",), {}, {"k": 4, "self_loops": True},
                   kernel=kern)
        np.testing.assert_array_equal(run_op(op, env).numpy(),
                                      knn_indices(x, 4, self_loops=True))


# ------------------------------------------------ handlers one by one ---
def both(kind, inputs, weights, attrs, out_shape=(), kernel="torch_ew"):
    """The same op for both packages: (port MatOp, reference MatOp)."""
    ref_kernel = {"torch_ew": "xla_ew"}.get(kernel, kernel)
    return (MatOp("op", kind, inputs, dict(weights), dict(attrs), out_shape,
                  kernel=kernel),
            RefOp("op", kind, inputs, dict(weights), dict(attrs), out_shape,
                  kernel=ref_kernel))


def run_both(ref_handler, kind, env, weights=None, attrs=None, out_shape=(),
             kernel="torch_ew"):
    port_op, ref_op = both(kind, tuple(env), weights or {}, attrs or {},
                           out_shape, kernel)
    got = run_op(port_op, {k: torch.from_numpy(v) for k, v in env.items()})
    want = ref_handler(ref_op, {k: jnp.asarray(v) for k, v in env.items()},
                       False)
    return got.numpy(), np.asarray(want)


def arr(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


EW_CASES = {
    "add": (dict(a=arr(6, 5), b=arr(6, 5, seed=1)), {}, {"fn": "add"}),
    "mul_broadcast": (dict(a=arr(6, 5), b=arr(6, 1, seed=1)), {},
                      {"fn": "mul"}),
    "softmax_last": (dict(a=arr(6, 5)), {}, {"fn": "softmax"}),
    "softmax_axis0": (dict(a=arr(6, 5)), {}, {"fn": "softmax", "axis": 0}),
    "softmax_masked": (
        dict(a=arr(6, 5)),
        {"mask": np.r_[np.eye(5, dtype=np.float32),
                       np.zeros((1, 5), np.float32)]},
        {"fn": "softmax", "masked": True}),
    "segment_softmax": (
        dict(a=arr(9)), {"segments": np.array([0, 0, 1, 3, 3, 3, 1, 0, 3],
                                              np.int32)},
        {"fn": "segment_softmax", "num_segments": 5}),
    "norm_batch_3d": (
        dict(a=arr(4, 3, 5)),
        {"mean": arr(4, seed=2), "var": np.abs(arr(4, seed=3)) + 0.5,
         "scale": arr(4, seed=4), "bias": arr(4, seed=5)},
        {"fn": "norm_batch", "eps": 1e-3}),
    "norm_batch_2d_defaults": (dict(a=arr(6, 4)), {}, {"fn": "norm_batch"}),
    "norm_layer": (dict(a=arr(6, 8)),
                   {"scale": arr(8, seed=6), "bias": arr(8, seed=7)},
                   {"fn": "norm_layer"}),
    "norm_layer_bare": (dict(a=arr(6, 8)), {}, {"fn": "norm_layer",
                                                "eps": 1e-2}),
    **{f"act_{fn}": (dict(a=arr(6, 5)), {}, {"fn": fn})
       for fn in ("relu", "gelu", "silu", "tanh", "sigmoid", "leaky_relu")},
    "act_leaky_relu_alpha": (dict(a=arr(6, 5)), {},
                             {"fn": "leaky_relu", "alpha": 0.05}),
}


@pytest.mark.parametrize("case", sorted(EW_CASES))
def test_run_ew_branch_matches_reference(case):
    env, weights, attrs = EW_CASES[case]
    got, want = run_both(ref_elementwise.run_ew, "ew", env, weights, attrs)
    close(got, want, rtol=HANDLER_RTOL)


SHAPE_CASES = {
    "channel_to_node": ("transpose", dict(a=arr(4, 3, 5)),
                        {"mode": "channel_to_node"}, (4, 15)),
    "patch_to_node": ("identity", dict(a=arr(4, 3, 5)),
                      {"mode": "patch_to_node"}, (15, 4)),
    "node_to_channel": ("transpose", dict(a=arr(15, 4)),
                        {"mode": "node_to_channel"}, (4, 3, 5)),
    "reshape": ("reshape", dict(a=arr(6)), {"shape": (6, 1)}, (6, 1)),
    "concat_rows": ("concat", dict(a=arr(2, 3), b=arr(4, 3, seed=1)),
                    {"axis": 0}, (6, 3)),
    "concat_cols": ("concat", dict(a=arr(2, 3), b=arr(2, 5, seed=1)),
                    {"axis": 1}, (2, 8)),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_op_matches_reference(case):
    kind, env, attrs, out_shape = SHAPE_CASES[case]
    handler = {"transpose": ref_shape.run_dm, "identity": ref_shape.run_dm,
               "reshape": ref_shape.run_reshape,
               "concat": ref_shape.run_concat}[kind]
    got, want = run_both(handler, kind, env, {}, attrs, out_shape)
    assert got.shape == out_shape
    np.testing.assert_array_equal(got, want)


def coo(n):
    """Edges into rows 0..n-2; row n-1 has no neighbors."""
    rows = np.array([0, 0, 1, 2, 2, 2, 1], np.int32)
    cols = np.array([1, 3, 0, 3, 1, 0, 2], np.int32)
    assert n - 1 not in rows
    vals = arr(len(rows), seed=9)
    return dict(coo_rows=rows, coo_cols=cols, coo_vals=vals)


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_left_coo_matches_reference_with_an_empty_row(reduce):
    x = arr(4, 6, seed=10)
    got, want = run_both(ref_matmul.run_mm, "mm", dict(x=x), coo(4),
                         {"weight_side": "left_coo", "reduce": reduce,
                          "n": 4}, kernel="coo_scatter")
    close(got, want, rtol=HANDLER_RTOL)
    if reduce == "max":
        np.testing.assert_array_equal(got[3], x[3])   # own-feature fallback
    else:
        assert (got[3] == 0).all()


def test_left_coo_runtime_edge_values():
    x = arr(4, 6, seed=11)
    w = coo(4)
    edge = w.pop("coo_vals")
    w["coo_vals"] = np.ones_like(edge)
    got, want = run_both(ref_matmul.run_mm, "mm", dict(x=x, e=edge), w,
                         {"weight_side": "left_coo", "reduce": "sum",
                          "n": 4, "runtime_edge": True},
                         kernel="coo_scatter")
    close(got, want, rtol=HANDLER_RTOL)


def test_left_coo_max_propagates_nan():
    x = arr(4, 6, seed=12)
    x[3, 2] = np.nan                     # node 3 sends to rows 0 and 2
    got, want = run_both(ref_matmul.run_mm, "mm", dict(x=x), coo(4),
                         {"weight_side": "left_coo", "reduce": "max",
                          "n": 4}, kernel="coo_scatter")
    assert np.isnan(got[0, 2]) and np.isnan(got[2, 2])
    assert not np.isnan(got[1]).any()
    close(got, want, rtol=HANDLER_RTOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_left_knn_matches_reference(reduce):
    x = arr(10, 7, seed=13)
    idx = np.random.default_rng(14).integers(0, 10, (10, 3)).astype(np.int32)
    x[4, 1] = np.nan
    got, want = run_both(ref_matmul.run_mm, "mm", dict(x=x, idx=idx), {},
                         {"weight_side": "left_knn", "reduce": reduce},
                         kernel="coo_scatter")
    close(got, want, rtol=HANDLER_RTOL)


def test_runtime_adjacency_side_still_raises():
    plan = compile_graph(build_task("b1", small=True))
    op = next(o for o in plan.ops
              if o.attrs.get("weight_side") == "left_runtime")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_op(op, {name: torch.zeros(1) for name in op.inputs})
