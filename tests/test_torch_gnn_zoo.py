"""The port's GNN zoo (g1 GCN, g2 GraphSAGE, g3 GAT), its two repaired
faults (KNN with k > 64, dense max-aggregation), ``kernels/ops.py`` and the
H100 Step-4 target, against the JAX reference on the CPU.

- g1-g3 on the reference test's ``MINI_GRAPH`` and g1 on cora: the port's
  plan under ``target="fpga"`` equals the reference's
  (``test_torch_compiler.assert_same_plan``: ops, kinds, primitives,
  attrs, shapes, weights bit for bit, bindings per family), and the
  outputs on the same numpy-seeded features agree within
  ``1e-5 · max|ref|`` (fp32 sums in another order);
- the KNN reproducer (``knn_graph(x (200, 8), k)`` then ``mp(knn_input=,
  reduce="max")``) at k = 65, 80 and 128 through
  ``gcv.compile(..., device="cpu")`` under every kernel mode: indices equal
  to the reference's exactly, outputs too (a max of the same values);
- dense max-aggregation on 50 nodes with an empty row and a planted NaN,
  and traced over a constant dense adjacency: equal to the reference
  exactly, NaN included;
- every ``kernels.ops`` entry point against ``repro.kernels.ops`` (float
  outputs within ``1e-5 · max|ref|``, indices exactly), and
  ``choose_primitive`` against ``select_primitive(target="h100")``;
- ``target="h100"`` compiles b1-b6 and g1-g3 at small sizes, its plan
  outputs equal the fpga plan's where no op flips, and the default
  ``CompileOptions()`` plan stays the fpga one.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import gcv as ref_gcv
from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.ir import GraphBuilder as RefBuilder
from repro.frontend import nn as ref_nn
from repro.gnncv.gnn_zoo import GNN_ZOO as REF_ZOO
from repro.gnncv.graphs import GraphSpec as RefSpec
from repro.gnncv.tasks import build_task as ref_build_task
from repro.kernels import ops as jops
from repro_torch import gcv
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.passes.select import dense_to_ell
from repro_torch.core.perf_model import select_primitive
from repro_torch.core.runtime import run_op
from repro_torch.frontend import nn
from repro_torch.gnncv import GNN_ZOO
from repro_torch.gnncv.graphs import DATASETS, GraphSpec
from repro_torch.gnncv.tasks import build_task
from repro_torch.kernels import ops
from test_torch_compiler import assert_same_plan

RTOL = 1e-5
MINI = ("mini", 128, 512, 32, 7)
MODES = [("xla", "torch"), ("pallas", "cuda")]
PORT_MODES = ("cuda", "torch", "auto")


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
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def specs(dataset):
    """The (port, reference) specs of a dataset name or of ``MINI``."""
    if dataset == "mini":
        return GraphSpec(*MINI), RefSpec(*MINI)
    return DATASETS[dataset], dataset


@functools.lru_cache(maxsize=None)
def ref_model(model, dataset, ref_mode):
    """-> (reference plan, inputs, reference output), computed once."""
    plan = ref_compile(REF_ZOO[model](specs(dataset)[1]),
                       RefOptions(target="fpga", kernels=ref_mode))
    n, f = plan.meta["input_shapes"]["features"]
    inputs = {"features": np.random.default_rng(5).standard_normal(
        (n, f)).astype(np.float32)}
    return plan, inputs, np.asarray(ref_build_runner(plan)(**inputs)[0])


def port_plan(model, dataset, port_mode, target="fpga"):
    return compile_graph(GNN_ZOO[model](specs(dataset)[0]),
                         CompileOptions(target=target, kernels=port_mode))


CASES = [(m, "mini") for m in sorted(GNN_ZOO)] + [("g1_gcn", "cora")]


# ------------------------------------------------------------- g1-g3 --
def test_zoo_names_match_the_reference():
    assert list(GNN_ZOO) == list(REF_ZOO)


@pytest.mark.parametrize("ref_mode,port_mode", MODES)
@pytest.mark.parametrize("model,dataset", CASES)
def test_gnn_plan_parity(model, dataset, ref_mode, port_mode):
    ref, _, _ = ref_model(model, dataset, ref_mode)
    assert_same_plan(port_plan(model, dataset, port_mode), ref)


@pytest.mark.parametrize("port_mode", ["torch", "cuda"])
@pytest.mark.parametrize("model,dataset", CASES)
def test_gnn_outputs_match_reference(model, dataset, port_mode):
    _, inputs, want = ref_model(model, dataset, "xla")
    plan = port_plan(model, dataset, port_mode)
    got = build_runner(plan, device="cpu")(**inputs)[0].numpy()
    spec = specs(dataset)[0]
    assert got.shape == (spec.num_nodes, spec.num_classes)
    assert np.isfinite(got).all()
    close(got, want)


def test_gat_attention_rows_normalized():
    """The segment softmax must produce a stochastic attention vector
    (port of the reference's test of the same name)."""
    plan = port_plan("g3_gat", "mini", "cuda")
    env = {k: torch.from_numpy(v)
           for k, v in random_inputs(plan, seed=1).items()}
    for op in plan.ops:
        env[op.name] = run_op(op, env)
    alpha = env["alpha0"].numpy()
    rows = next(o for o in plan.ops if o.name == "attnmp0").weights[
        "coo_rows"]
    sums = np.zeros(MINI[1])
    np.add.at(sums, rows, alpha)
    np.testing.assert_allclose(sums[np.unique(rows)], 1.0, rtol=1e-5)


# -------------------------------------------- fault 1: KNN with k > 64 --
def knn_graph(builder, k):
    """Queue 3's reproducer: ``knn_graph(x (200, 8), k)`` then
    ``mp(knn_input=, reduce="max")``; both the indices and the output."""
    b = builder(f"knn_k{k}")
    x = b.input((200, 8), name="points")
    idx = b.knn_graph(x, k=k, name="nbrs")
    return b.output(idx, b.mp(x, knn_input=idx, reduce="max", name="agg"))


@pytest.mark.parametrize("kernels", PORT_MODES)
@pytest.mark.parametrize("k", [65, 80, 128])
def test_knn_above_the_warp_route_runs_like_the_reference(k, kernels):
    inputs = {"points": np.random.default_rng(k).standard_normal(
        (200, 8)).astype(np.float32)}
    ref_idx, ref_out = ref_gcv.compile(knn_graph(RefBuilder, k),
                                       target="fpga").run(**inputs)
    model = gcv.compile(knn_graph(GraphBuilder, k), device="cpu",
                        kernels=kernels)
    assert model.plan.ops[0].kernel == (
        "cuda_knn" if kernels == "cuda" else "torch_knn")
    idx, out = model.run(**inputs)
    assert idx.dtype == torch.int32 and idx.shape == (200, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


# ---------------------------------------- fault 2: dense max-aggregation --
def maxagg_adjacency(n=50):
    """A dense 0/1 adjacency (density 0.1) with row 7 empty."""
    adj = (np.random.default_rng(3).random((n, n)) < 0.1).astype(np.float32)
    adj[7] = 0.0
    return adj


def maxagg_graph(builder, adj):
    b = builder("maxagg")
    x = b.input((adj.shape[0], 6), name="nodes")
    return b.output(b.mp(x, adj=adj, reduce="max", name="agg"))


@pytest.mark.parametrize("kernels", PORT_MODES)
def test_dense_max_aggregation_equals_the_reference(kernels):
    adj = maxagg_adjacency()
    x = np.random.default_rng(4).standard_normal((50, 6)).astype(np.float32)
    x[int(np.nonzero(adj[3])[0][0]), 2] = np.nan     # a neighbour of row 3
    x[7, 1] = np.nan                                 # the empty row's own
    want = np.asarray(ref_gcv.compile(maxagg_graph(RefBuilder, adj),
                                      target="fpga").run(nodes=x)[0])
    model = gcv.compile(maxagg_graph(GraphBuilder, adj), device="cpu",
                        kernels=kernels)
    assert [(o.kind, o.kernel) for o in model.plan.ops] == \
        [("maxagg", "torch_ell_spdmm")]
    got = model.run(nodes=x)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[3, 2]) and np.isnan(got[7, 1])
    np.testing.assert_array_equal(got[7], x[7])      # the empty row


def test_dense_max_aggregation_batched_equals_per_sample():
    adj = maxagg_adjacency()
    model = gcv.compile(maxagg_graph(GraphBuilder, adj), device="cpu")
    xs = np.random.default_rng(6).standard_normal((3, 50, 6)).astype(
        np.float32)
    out = model.batched(3)(nodes=xs)[0]
    for i in range(3):
        assert torch.equal(out[i], model.run(nodes=xs[i])[0])


def test_traced_max_over_a_constant_dense_adjacency():
    adj = maxagg_adjacency()
    x = np.random.default_rng(8).standard_normal((50, 6)).astype(np.float32)
    model = gcv.compile(lambda x: nn.message_passing(adj, x, reduce="max"),
                        {"x": x}, device="cpu")
    assert "maxagg" in [o.kind for o in model.plan.ops]
    want = ref_gcv.compile(
        lambda x: ref_nn.message_passing(adj, x, reduce="max"),
        {"x": x}, target="fpga").run(x=x)[0]
    np.testing.assert_array_equal(model.run(x=x)[0].numpy(),
                                  np.asarray(want))


# ------------------------------------------------------- kernels/ops.py --
def test_ops_dense_entry_points_match_the_reference():
    rng = np.random.default_rng(9)
    x, y = rng.standard_normal((2, 5, 12)), rng.standard_normal((12, 7))
    bias, res = rng.standard_normal(7), rng.standard_normal((2, 5, 7))
    arrs = [a.astype(np.float32) for a in (x, y, bias, res)]
    want = jops.matmul(*map(jnp.asarray, arrs), act="relu",
                       use_pallas=False)
    for use_kernel in (True, False):
        got = ops.matmul(*map(torch.from_numpy, arrs), act="relu",
                         use_kernel=use_kernel)
        assert got.shape == (2, 5, 7)
        close(got, want)
    xs = rng.standard_normal((30, 16)).astype(np.float32)
    mask = (rng.random((30, 30)) < 0.3).astype(np.float32)
    want = jops.sampled_matmul(jnp.asarray(xs), jnp.asarray(xs.T),
                               jnp.asarray(mask), use_pallas=False)
    close(ops.sampled_matmul(torch.from_numpy(xs), torch.from_numpy(xs).T,
                             torch.from_numpy(mask)), want)
    img = rng.standard_normal((2, 3, 9, 9)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    want = jops.conv2d(jnp.asarray(img), jnp.asarray(w), stride=2,
                       use_pallas=False)
    close(ops.conv2d(torch.from_numpy(img), torch.from_numpy(w), stride=2),
          want)
    q = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 2, 6, 8)).astype(np.float32)
    want = jops.attention(*map(jnp.asarray, (q, kv, kv)), use_pallas=False)
    close(ops.attention(*map(torch.from_numpy, (q, kv, kv))), want)


def test_ops_sparse_and_knn_entry_points_match_the_reference():
    rng = np.random.default_rng(10)
    a = rng.standard_normal((40, 40)).astype(np.float32)
    a[rng.random((40, 40)) < 0.85] = 0.0
    idx, val = dense_to_ell(a)
    y = rng.standard_normal((40, 9)).astype(np.float32)
    want = jops.sparse_matmul(jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(y), use_pallas=False)
    for use_kernel in (True, False):
        close(ops.sparse_matmul(torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(y), use_kernel=use_kernel),
              want)
    pts = rng.standard_normal((90, 4)).astype(np.float32)
    mask = np.ones(90, np.float32)
    mask[-10:] = 0.0
    for k in (5, 70):
        want = jops.knn_graph(jnp.asarray(pts), jnp.asarray(mask), k=k,
                              use_pallas=False)
        for use_kernel in (True, False):
            np.testing.assert_array_equal(
                ops.knn_graph(torch.from_numpy(pts), torch.from_numpy(mask),
                              k=k, use_kernel=use_kernel).numpy(),
                np.asarray(want))


@pytest.mark.parametrize("s1,s2,s3,slots", [
    (1000, 1000, 64, 5000), (20000, 20000, 64, 20000), (64, 64, 8, 4096),
    (25, 25, 19200, 100), (4096, 4096, 256, 4096 * 3)])
def test_choose_primitive_is_the_h100_step4_price(s1, s2, s3, slots):
    """One Step-4 price: ``matmul_auto``'s decision is
    ``select_primitive(target="h100")`` with the ELL on the left."""
    assert ops.choose_primitive(s1, s2, s3, slots) == select_primitive(
        s1, s2, s3, slots, target="h100", columns=True)


def test_matmul_auto_takes_both_primitives():
    """DDMM for a small product; SpDMM where one slot a row stands for a
    20000 x 20000 operand (only its shape is read: a broadcast view)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((30, 30)).astype(np.float32)
    a[rng.random((30, 30)) < 0.8] = 0.0
    y = torch.from_numpy(rng.standard_normal((30, 5)).astype(np.float32))
    ell = tuple(map(torch.from_numpy, dense_to_ell(a)))
    out, prim = ops.matmul_auto(torch.from_numpy(a), y, ell=ell)
    assert prim == "DDMM"
    close(out, a @ y.numpy())
    n = 20000
    idx = torch.from_numpy(rng.integers(0, n, (n, 1)).astype(np.int32))
    val = torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    out, prim = ops.matmul_auto(torch.zeros(()).expand(n, n), y,
                                ell=(idx, val))
    assert prim == "SpDMM"
    torch.testing.assert_close(out, val * y[idx[:, 0].long()], rtol=0,
                               atol=0)


# --------------------------------------------------- the H100 target --
def test_select_primitive_targets():
    """The two targets answer; anything else raises naming them.  The H100
    price differs from the FPGA's: a half-dense 256 x 256 operand is DDMM
    by the paper's cycles (a tie) and SpDMM by the rows kernel's device
    time, DDMM again as the left operand (the columns kernel)."""
    assert select_primitive(256, 256, 64, 256 * 128) == "DDMM"
    assert select_primitive(256, 256, 64, 256 * 128,
                            target="h100") == "SpDMM"
    assert select_primitive(256, 256, 64, 256 * 128, target="h100",
                            columns=True) == "DDMM"
    assert select_primitive(25, 25, 19200, 100, target="h100") == "SpDMM"
    with pytest.raises(ValueError, match="fpga"):
        select_primitive(4, 4, 4, 4, target="tpu")


def h100_cases():
    return ([("task", t) for t in ("b1", "b2", "b3-r50", "b4", "b5", "b6")]
            + [("zoo", m) for m in sorted(GNN_ZOO)])


def small_graph(kind, name):
    return (build_task(name, small=True) if kind == "task"
            else GNN_ZOO[name](GraphSpec(*MINI)))


@pytest.mark.parametrize("kind,name", h100_cases())
def test_h100_target_compiles_and_runs(kind, name):
    h100 = compile_graph(small_graph(kind, name),
                         CompileOptions(target="h100", kernels="torch"))
    fpga = compile_graph(small_graph(kind, name),
                         CompileOptions(kernels="torch"))
    assert h100.meta["select_target"] == h100.meta["tiling_target"] == \
        "h100"
    assert all(t[0] % 16 == 0 and t[0] * t[1] + t[1] * t[2] + t[0] * t[2]
               <= 232448 // 4 for o in h100.ops if o.kind == "mm"
               for t in [o.tiles])
    inputs = random_inputs(fpga, seed=2)
    got = build_runner(h100, device="cpu")(**inputs)[0]
    want = build_runner(fpga, device="cpu")(**inputs)[0]
    assert [o.primitive for o in h100.ops] == [o.primitive for o in fpga.ops]
    assert torch.equal(got, want)


def test_default_options_keep_the_fpga_plan():
    """``CompileOptions()`` is the fpga plan, equal to the reference's (the
    parity tests' default); ``gcv.compile(target="h100")`` reaches the H100
    target through its keyword overrides and caches it apart."""
    g = build_task("b4", small=True)
    plan = compile_graph(g)
    assert plan.meta["select_target"] == "fpga"
    assert_same_plan(plan, ref_compile(ref_build_task("b4", small=True),
                                       RefOptions(target="fpga",
                                                  kernels="pallas")))
    m = gcv.compile(g, device="cpu", target="h100")
    assert m.plan.meta["select_target"] == "h100"
    assert gcv.compile(g, device="cpu").plan.meta["select_target"] == "fpga"
