"""The port's tracing frontend (``repro_torch.frontend``) against the JAX
reference's (``repro.frontend``), on the CPU.

Counterparts of ``tests/test_frontend.py``, ``test_frontend_lint.py`` and
the callable cases of ``test_gcv_api.py``:

- every layer kind and idiom of the reference's matrix, written once in jax
  and once in torch with the same constants: the port's traced ``Graph``
  equals the reference's traced ``Graph`` up to layer names (the same
  kinds in the same order, the same params and wiring, weights bit for
  bit), and the compiled plan runs to the torch function's own result
  (``rtol=1e-4, atol=1e-6``, the reference's bound);
- refusals, each naming the aten op or the pads: unsupported ops, explicit
  non-SAME padding, an unstable sort, a runtime adjacency with
  ``reduce="max"``, leftover elementwise and selects;
- provenance (``frontend.lint``): aten ops with shapes per layer;
- ``gcv.compile`` of a callable and of an ``nn.Module`` (eval mode),
  batched-example tracing and its warning, ``example_batched``, and
  ``gcv.serve`` over ``(fn, example)`` pairs and traced graph buckets.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import frontend as ref_frontend
from repro.core.ir import LAYER_KINDS
from repro.frontend import nn as ref_nn
from repro_torch import frontend, gcv
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.frontend import UnsupportedOpError, nn
from repro_torch.gnncv.tasks import build_task

CPU = "cpu"
OPTS = CompileOptions(target="fpga")
RNG = np.random.default_rng(0)
W_FF = RNG.standard_normal((8, 4)).astype(np.float32) * 0.1
B_FF = RNG.standard_normal(4).astype(np.float32) * 0.1
W_CONV = RNG.standard_normal((3, 3, 3, 4)).astype(np.float32) * 0.1
ADJ = (RNG.random((6, 6)) < 0.5).astype(np.float32)
COO = (np.array([0, 1, 2, 3], np.int32), np.array([1, 2, 3, 0], np.int32),
       np.ones(4, np.float32), 6)
MASK = np.array(np.arange(48).reshape(6, 8) % 3 != 0)
SEG_ROWS = np.array([0, 0, 1, 1, 2, 3], np.int32)
SEG_COLS = np.array([1, 2, 0, 3, 3, 2], np.int32)
ADJ_SQ = RNG.random((4, 4)).astype(np.float32)
ONES8, ZEROS8 = np.ones(8, np.float32), np.zeros(8, np.float32)

T = torch.from_numpy
W_FF_T, B_FF_T, ADJ_SQ_T = T(W_FF), T(B_FF), T(ADJ_SQ)
W_CONV_T = T(np.ascontiguousarray(W_CONV.transpose(3, 2, 0, 1)))   # OIHW
MASK_T = T(MASK)

_x2 = {"x": (6, 8)}
_x3 = {"x": (3, 4, 4)}
_x4 = {"x": (2, 3, 4, 4)}
_xy = {"x": (6, 8), "y": (8, 6)}
_xx = {"x": (6, 8), "y": (6, 8)}
_e6 = {"x": (6,)}
_x65 = {"x": (6, 5)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the two models ---
def _jconv(x):
    return jax.lax.conv_general_dilated(
        x, W_CONV, (1, 1), "SAME",
        dimension_numbers=("NCHW", "HWIO", "NCHW"))


def _tconv(x):
    return F.conv2d(F.pad(x, (1, 1, 1, 1)), W_CONV_T)


def _jconv_single(x):
    return jnp.squeeze(_jconv(x[None]), 0)


def _tconv_single(x):
    return _tconv(x[None])[0]


def _jmasked_softmax(x):
    z = jnp.where(MASK, x, -jnp.inf)
    return jnp.where(MASK, jax.nn.softmax(z, axis=-1), 0.0)


def _tmasked_softmax(x):
    z = torch.where(MASK_T, x, float("-inf"))
    return torch.where(MASK_T, F.softmax(z, dim=-1), 0.0)


def _jgat(x):
    e = ref_nn.vip(x, edges=(SEG_ROWS, SEG_COLS))
    a = ref_nn.segment_softmax(e, SEG_ROWS, 6)
    return ref_nn.message_passing((SEG_ROWS, SEG_COLS, a, 6), x)


def _tgat(x):
    e = nn.vip(x, edges=(SEG_ROWS, SEG_COLS))
    a = nn.segment_softmax(e, SEG_ROWS, 6)
    return nn.message_passing((SEG_ROWS, SEG_COLS, a, 6), x)


def _jstgcn(x):
    c, t, v = x.shape
    return (x.reshape(c * t, v) @ ADJ_SQ.T).reshape(c, t, v)


def _tstgcn(x):
    c, t, v = x.shape
    return (x.reshape(c * t, v) @ ADJ_SQ_T.T).reshape(c, t, v)


def _jsoftmax(x):
    e = jnp.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def _tsoftmax(x):
    e = torch.exp(x)
    return e / e.sum(1, keepdim=True)


# Every GraphBuilder layer kind -> (jax model, torch model, example shapes,
# the kinds the traced graph must contain).  'flatten' maps to 'reshape',
# as in the reference.
KIND_PROGRAMS = {
    "input": (lambda x: x @ W_FF, lambda x: x @ W_FF_T, _x2, {"input"}),
    "linear": (lambda x: x @ W_FF + B_FF, lambda x: x @ W_FF_T + B_FF_T,
               _x2, {"linear"}),
    "conv": (_jconv, _tconv, _x4, {"conv"}),
    "mp": (lambda x: ref_nn.message_passing(COO, x, reduce="max"),
           lambda x: nn.message_passing(COO, x, reduce="max"), _x2, {"mp"}),
    "vip": (lambda x: ref_nn.vip(x), lambda x: nn.vip(x), _x2, {"vip"}),
    "dm": (lambda x: x.reshape(3, -1).T, lambda x: x.reshape(3, -1).T, _x3,
           {"dm"}),
    "pool": (lambda x: jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, 2, 2), (1, 1, 2, 2), "SAME"),
        lambda x: F.max_pool2d(x, 2, 2), _x4, {"pool"}),
    "norm": (lambda x: ref_nn.batch_norm(x, ONES8, ZEROS8, ZEROS8, ONES8),
             lambda x: nn.batch_norm(x, ONES8, ZEROS8, ZEROS8, ONES8), _x2,
             {"norm"}),
    "act": (jax.nn.relu, torch.relu, _x2, {"act"}),
    "add": (lambda x, y: x + y, lambda x, y: x + y, _xx, {"add"}),
    "mul": (lambda x, y: x * y, lambda x, y: x * y, _xx, {"mul"}),
    "knn_graph": (lambda x: ref_nn.message_passing(
        ref_nn.knn_graph(x, k=3), x, reduce="max"),
        lambda x: nn.message_passing(nn.knn_graph(x, k=3), x, reduce="max"),
        _x2, {"knn_graph", "mp"}),
    "matmul": (lambda x, y: x @ y, lambda x, y: x @ y, _xy, {"matmul"}),
    "concat": (lambda x, y: jnp.concatenate([x, y], axis=1),
               lambda x, y: torch.cat([x, y], dim=1), _xx, {"concat"}),
    "reshape": (lambda x: x.reshape(4, 12), lambda x: x.reshape(4, 12), _x2,
                {"reshape"}),
    "softmax": (lambda x: jax.nn.softmax(x, axis=-1),
                lambda x: F.softmax(x, dim=-1), _x2, {"softmax"}),
    "globalpool": (lambda x: x.mean((1, 2)), lambda x: x.mean((1, 2)), _x3,
                   {"globalpool"}),
    "flatten": (lambda x: x.reshape(-1), lambda x: x.reshape(-1), _x2,
                {"reshape"}),
}

IDIOM_PROGRAMS = {
    "leaky_relu": (lambda x: jax.nn.leaky_relu(x, 0.2),
                   lambda x: F.leaky_relu(x, 0.2), _x2, {"act"}),
    "leaky_relu_where": (lambda x: jax.nn.leaky_relu(x, 0.2),
                         lambda x: torch.where(x >= 0, x, 0.2 * x), _x2,
                         {"act"}),
    "masked_softmax": (_jmasked_softmax, _tmasked_softmax, _x2,
                       {"softmax"}),
    "segment_softmax": (lambda x: ref_nn.segment_softmax(x, SEG_ROWS, 6),
                        lambda x: nn.segment_softmax(x, SEG_ROWS, 6), _e6,
                        {"softmax"}),
    "gat_attention": (_jgat, _tgat, _x65, {"vip", "softmax", "mp"}),
    "adj_right_mp": (_jstgcn, _tstgcn, _x3, {"mp"}),
    "conv_batch1": (_jconv_single, _tconv_single, _x3, {"conv"}),
    # rectangular windows/strides land as (kh, kw) tuples; SAME pads
    # (0, 1) x (0, 1) here, written out with F.pad
    "rect_pool_max": (lambda x: jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 1, 2, 3), (1, 1, 1, 2), "SAME"),
        lambda x: F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")),
                               (2, 3), (1, 2)), _x4, {"pool"}),
    "rect_pool_avg": (lambda x: jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 1, 3, 2), (1, 1, 3, 2), "SAME") / 6.0,
        lambda x: F.avg_pool2d(F.pad(x, (0, 0, 1, 1)), (3, 2), (3, 2)), _x4,
        {"pool"}),
    "handwritten_softmax": (_jsoftmax, _tsoftmax, _x2, {"softmax"}),
    "vector_linear": (lambda x: x.mean(0) @ W_FF + B_FF,
                      lambda x: F.linear(x.mean(0), W_FF_T.T, B_FF_T), _x2,
                      {"linear"}),
}
PROGRAMS = {**{f"kind-{k}": v for k, v in KIND_PROGRAMS.items()},
            **{f"idiom-{k}": v for k, v in IDIOM_PROGRAMS.items()}}


def jax_example(shapes):
    return {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}


def torch_example(shapes):
    return {k: torch.zeros(s) for k, s in shapes.items()}


def same_arrays(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def assert_same_graph(port, ref):
    """Equal up to layer names: the same layers in the same order, kinds,
    params, wiring and output shapes, weights bit for bit."""
    mine, theirs = port.toposorted(), ref.toposorted()
    assert [l.kind for l in mine] == [l.kind for l in theirs]
    names = {}
    for p, r in zip(mine, theirs):
        names[p.name] = r.name
        assert p.params == r.params, (p.name, p.params, r.params)
        assert tuple(names[i] for i in p.inputs) == tuple(r.inputs), p.name
        assert p.weights.keys() == r.weights.keys(), p.name
        for k in p.weights:
            assert same_arrays(p.weights[k], r.weights[k]), (p.name, k)
    assert [names[o] for o in port.outputs] == list(ref.outputs)
    assert port.meta["frontend"] == ref.meta["frontend"] == "tracer"


def test_matrix_covers_every_layer_kind():
    assert set(KIND_PROGRAMS) == set(LAYER_KINDS)


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_traced_graph_equals_the_reference(prog):
    jfn, tfn, shapes, expected = PROGRAMS[prog]
    g = frontend.to_graph(tfn, torch_example(shapes), name=prog)
    assert expected <= {l.kind for l in g.toposorted()}
    assert_same_graph(g, ref_frontend.to_graph(jfn, jax_example(shapes),
                                               name=prog))


@pytest.mark.parametrize("prog", sorted(PROGRAMS))
def test_traced_program_compiles_and_runs_to_its_direct_result(prog):
    _, tfn, shapes, _ = PROGRAMS[prog]
    model = gcv.compile(tfn, torch_example(shapes), options=OPTS,
                        device=CPU)
    ins = {k: torch.from_numpy(RNG.standard_normal(s).astype(np.float32))
           for k, s in shapes.items()}
    out = model.run(**ins)[0]
    torch.testing.assert_close(out, tfn(**ins), rtol=1e-4, atol=1e-6)


def test_nn_ops_run_directly_like_the_reference_ops():
    """The eager bodies of the ``gcv`` ops compute what the reference's
    primitives compute."""
    x = RNG.standard_normal((6, 8)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    m = np.ones(6, np.float32)
    m[-2:] = 0
    pairs = [
        (nn.message_passing(COO, xt, reduce="max"),
         ref_nn.message_passing(COO, xj, reduce="max")),
        (nn.message_passing(COO, xt), ref_nn.message_passing(COO, xj)),
        (nn.message_passing(ADJ, xt), ref_nn.message_passing(ADJ, xj)),
        (nn.message_passing(ADJ, xt, reduce="max"),
         ref_nn.message_passing(ADJ, xj, reduce="max")),
        (nn.vip(xt), ref_nn.vip(xj)),
        (nn.vip(xt, mask=ADJ), ref_nn.vip(xj, mask=ADJ)),
        (nn.batch_norm(xt, ONES8 * 2, ZEROS8 + 1, ZEROS8 + .5, ONES8 * 3),
         ref_nn.batch_norm(xj, ONES8 * 2, ZEROS8 + 1, ZEROS8 + .5,
                           ONES8 * 3)),
        (_tgat(xt[:, :5]), _jgat(xj[:, :5])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    idx = nn.knn_graph(xt, k=3, mask=torch.from_numpy(m))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(ref_nn.knn_graph(xj, k=3, mask=m)))
    np.testing.assert_array_equal(
        nn.message_passing(idx, xt, reduce="max").numpy(),
        np.asarray(ref_nn.message_passing(
            ref_nn.knn_graph(xj, k=3, mask=m), xj, reduce="max")))


# ----------------------------------------------------------- refusals ----
@pytest.mark.parametrize("fn,op", [
    (lambda x: torch.cumsum(x, 0), "aten.cumsum"),
    (lambda x: x[torch.tensor([1, 0])], "aten.index"),
    (lambda x: torch.sort(x, dim=-1).values, "unstable sort"),
    (lambda x: torch.argsort(x, dim=1), "aten.sort"),
    (lambda x: x[1], "aten.select"),
    (lambda x: x.double(), "aten._to_copy"),
])
def test_unsupported_aten_op_is_named(fn, op):
    with pytest.raises(UnsupportedOpError, match=op.replace(".", r"\.")):
        frontend.to_graph(fn, torch_example(_x2))


def test_symmetric_padding_of_a_stride2_conv_is_refused_with_its_pads():
    """torch's ``padding=1`` pads a 3x3 stride-2 conv at 8 by (1, 1); SAME
    pads (0, 1) there, and the IR knows SAME and VALID only."""
    w = torch.zeros(4, 3, 3, 3)
    with pytest.raises(UnsupportedOpError,
                       match=r"\(\(1, 1\), \(1, 1\)\).*SAME"):
        frontend.to_graph(lambda x: F.conv2d(x, w, stride=2, padding=1),
                          torch_example({"x": (1, 3, 8, 8)}))
    # the same conv padded (0, 1) by hand is SAME
    g = frontend.to_graph(
        lambda x: F.conv2d(F.pad(x, (0, 1, 0, 1)), w, stride=2),
        torch_example({"x": (1, 3, 8, 8)}))
    (conv,) = [l for l in g.toposorted() if l.kind == "conv"]
    assert conv.params["padding"] == "SAME"
    with pytest.raises(UnsupportedOpError, match=r"\(\(0, 2\), \(0, 2\)\)"):
        frontend.to_graph(
            lambda x: F.conv2d(F.pad(x, (0, 2, 0, 2)), w, stride=2),
            torch_example({"x": (1, 3, 8, 8)}))
    with pytest.raises(UnsupportedOpError, match="pool padding"):
        frontend.to_graph(lambda x: F.max_pool2d(x, 3, 2, padding=1),
                          torch_example({"x": (1, 3, 8, 8)}))


def test_runtime_adjacency_max_reduce_rejected():
    def fn(x, a):
        return nn.message_passing(a, x, reduce="max")
    with pytest.raises(UnsupportedOpError, match="reduce='sum'"):
        frontend.to_graph(fn, {"x": torch.ones(6, 8), "a": torch.ones(6, 6)})


def test_leftover_elementwise_is_rejected_not_mislowered():
    with pytest.raises(UnsupportedOpError, match=r"'aten\.div\.Tensor'"):
        frontend.to_graph(lambda x, y: x / y, torch_example(_xx))


def test_unmatched_where_is_rejected_by_name():
    with pytest.raises(UnsupportedOpError, match=r"'aten\.ge\.Scalar'"):
        frontend.to_graph(lambda x: torch.where(x >= 1.0, x, 0.2 * x),
                          torch_example(_x2))


def test_mismatched_softmax_masks_rejected():
    other = torch.from_numpy(~MASK)

    def fn(x):
        z = torch.where(MASK_T, x, float("-inf"))
        return torch.where(other, F.softmax(z, dim=-1), 0.0)
    with pytest.raises(UnsupportedOpError, match=r"aten\.where"):
        frontend.to_graph(fn, torch_example(_x2))


def test_segment_softmax_traced_ids_rejected():
    def fn(x, seg):
        return nn.segment_softmax(x, seg, 6)
    with pytest.raises(UnsupportedOpError, match="static"):
        frontend.to_graph(fn, {"x": torch.ones(6),
                               "seg": torch.zeros(6, dtype=torch.int32)})


def test_module_in_training_mode_is_refused():
    with pytest.raises(ValueError, match="eval"):
        frontend.to_graph(torch.nn.Linear(8, 4), torch_example(_x2))


# ------------------------------------------------------ canonicalization --
def test_bias_add_folds_into_linear():
    g = frontend.to_graph(lambda x: x @ W_FF_T + B_FF_T, torch_example(_x2))
    (lin,) = [l for l in g.toposorted() if l.kind == "linear"]
    assert same_arrays(lin.weights["b"], B_FF)
    assert not any(l.kind == "add" for l in g.toposorted())


def test_handwritten_softmax_is_recognized():
    def fn(x):
        e = torch.exp(x)
        return e / e.sum(1, keepdim=True)
    g = frontend.to_graph(fn, torch_example(_x2))
    assert [l.kind for l in g.toposorted()] == ["input", "softmax"]


def test_dense_adjacency_matmul_becomes_mp():
    g = frontend.to_graph(lambda x: T(ADJ) @ x, torch_example(_x2))
    (mp,) = [l for l in g.toposorted() if l.kind == "mp"]
    assert same_arrays(mp.weights["adj"], ADJ)


def test_x_xt_becomes_vip():
    g = frontend.to_graph(lambda x: x @ x.T, torch_example(_x2))
    assert [l.kind for l in g.toposorted()] == ["input", "vip"]


def test_adj_right_mp_matches_builder_weight_layout():
    g = frontend.to_graph(_tstgcn, torch_example(_x3))
    (mp,) = [l for l in g.toposorted() if l.kind == "mp"]
    assert same_arrays(mp.weights["adj"], ADJ_SQ)
    plan = compile_graph(g, OPTS)
    assert any(o.attrs.get("weight_side") == "right_t" for o in plan.ops)


def test_conv_batch1_wrapper_and_pad_fold_to_one_3d_conv():
    g = frontend.to_graph(_tconv_single, torch_example(_x3))
    assert [l.kind for l in g.toposorted()] == ["input", "conv"]
    (conv,) = [l for l in g.toposorted() if l.kind == "conv"]
    assert conv.params["padding"] == "SAME"
    assert same_arrays(conv.weights["w"], W_CONV)       # OIHW back to HWIO
    (op,) = [o for o in compile_graph(g, OPTS).ops if o.kind == "conv"]
    assert op.out_shape == (4, 4, 4)


def test_dm_chains_classified_for_fusion():
    w = torch.from_numpy(RNG.standard_normal((3, 5)).astype(np.float32))

    def fn(x):                                 # (3, 4, 4) CNN layout
        nodes = x.reshape(3, -1).T             # -> (16, 3) GNN layout
        return (nodes @ w).T.reshape(5, 4, 4)  # -> CNN layout
    g = frontend.to_graph(fn, torch_example(_x3))
    modes = [l.params["mode"] for l in g.toposorted() if l.kind == "dm"]
    assert modes == ["patch_to_node", "node_to_channel"]
    assert any(op.kind == "identity" for op in compile_graph(g, OPTS).ops)


def test_topk_idiom_recovers_self_loops():
    def fn(x):
        sq = (x * x).sum(1)
        d = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        idx = torch.topk(-d, 4).indices
        return nn.message_passing(idx, x, reduce="max")
    g = frontend.to_graph(fn, torch_example({"x": (40, 6)}))
    layer = next(l for l in g.layers.values() if l.kind == "knn_graph")
    assert layer.params["k"] == 4 and layer.params.get("self_loops")
    assert "vip" not in g.stats()


def test_foreign_leaky_slope_carries_alpha_and_fuses():
    w = torch.linspace(-1, 1, 16).reshape(8, 2)

    def fn(x):
        return F.leaky_relu(x @ w, 0.05)
    g = frontend.to_graph(fn, torch_example(_x2))
    act = next(l for l in g.toposorted() if l.kind == "act")
    assert act.params["alpha"] == pytest.approx(0.05)
    plan = compile_graph(g, CompileOptions())
    mm = next(op for op in plan.ops if op.kind == "mm")
    assert mm.attrs["fused_act"] == "leaky_relu"
    x = torch.linspace(-2, 2, 48).reshape(6, 8)
    torch.testing.assert_close(build_runner(plan, device=CPU)(x=x)[0],
                               fn(x), rtol=1e-5, atol=1e-6)


def test_modules_trace_their_parameters_and_batch_norm():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
            self.bn = torch.nn.BatchNorm2d(4)
            self.fc = torch.nn.Linear(4, 5)

        def forward(self, x):
            h = torch.relu(self.bn(self.conv(x)))
            return self.fc(h.mean((2, 3)))

    torch.manual_seed(0)
    net = Net().eval()
    net.bn.running_mean.uniform_(-1, 1)
    net.bn.running_var.uniform_(0.5, 2)
    g = frontend.to_graph(net, torch_example(_x4))
    assert [l.kind for l in g.toposorted()] == \
        ["input", "conv", "norm", "act", "globalpool", "linear"]
    conv = next(l for l in g.toposorted() if l.kind == "conv")
    assert same_arrays(conv.weights["b"], net.conv.bias.detach().numpy())
    model = gcv.compile(net, torch_example(_x4), options=OPTS, device=CPU)
    x = torch.from_numpy(RNG.standard_normal((2, 3, 4, 4)).astype(
        np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.run(x=x)[0], net(x), rtol=1e-5,
                                   atol=1e-6)


# -------------------------------------------------------------- lint -----
def test_every_traced_layer_has_aten_provenance():
    from repro_torch.gnncv.torch_tasks import build_traced_task
    g = build_traced_task("b4", small=True)
    nodes = g.meta["aten_nodes"]
    for layer in g.toposorted():
        assert layer.name in nodes
        if layer.kind != "input":
            assert nodes[layer.name], layer.name
    conv = next(l for l in g.toposorted() if l.kind == "conv")
    ops = [s.split(":")[0] for s in nodes[conv.name]]
    assert "aten.convolution.default" in ops
    assert "aten.unsqueeze.default" in ops and "aten.select.int" in ops


def test_pattern_partners_fold_into_survivor():
    def fn(x):
        h = x @ W_FF_T + B_FF_T
        return torch.where(h >= 0, h, 0.2 * h)
    g = frontend.to_graph(fn, torch_example(_x2))
    nodes = g.meta["aten_nodes"]
    act = next(l for l in g.toposorted() if l.kind == "act")
    ops = [s.split(":")[0] for s in nodes[act.name]]
    assert "aten.where.self" in ops and "aten.ge.Scalar" in ops
    assert "aten.mul.Tensor" in ops
    lin = next(l for l in g.toposorted() if l.kind == "linear")
    ops = [s.split(":")[0] for s in nodes[lin.name]]
    assert "aten.mm.default" in ops and "aten.add.Tensor" in ops


def test_lint_names_aten_ops_with_shapes_at_b7_width():
    from repro_torch.gnncv.torch_tasks import TRACED_TASKS
    fn, example = TRACED_TASKS["b7"](blocks=1)
    g = frontend.to_graph(fn, example, name="b7_lint")
    report = frontend.lint(g)
    assert "b7_lint" in report and "model input" in report
    assert "aten.mm.default:(196, 192)" in report
    for layer in g.toposorted():
        assert layer.name in report


def test_lint_on_builder_graph_says_no_provenance():
    report = frontend.lint(build_task("b6", small=True))
    assert "GraphBuilder" in report and "no aten provenance" in report


# ------------------------------------------------------------ gcv ------
def _tiny_fn():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 4)).astype(np.float32))

    def fn(x):
        return torch.relu(x @ w)
    return fn, {"x": torch.zeros(6, 8)}


def test_compile_accepts_a_torch_callable():
    fn, example = _tiny_fn()
    model = gcv.compile(fn, example, device=CPU)
    assert model.plan.meta["frontend"] == "tracer"
    assert model.stats()["frontend"] == "tracer"
    assert model.graph.name == "fn"
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 8)).astype(np.float32))
    torch.testing.assert_close(model.run(x=x)[0], fn(x), rtol=1e-5,
                               atol=1e-6)
    text = model.lint()
    assert "aten.mm.default:(6, 4)" in text and "kernel choices for" in text


def test_compile_of_a_callable_defaults_to_the_card():
    fn, example = _tiny_fn()
    if torch.cuda.is_available():
        assert gcv.compile(fn, example).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gcv.compile(fn, example)


def test_compile_rejects_a_callable_without_examples():
    with pytest.raises(AssertionError, match="requires example_inputs"):
        gcv.compile(lambda x: x, device=CPU)


def test_batched_example_tracing_parity():
    fn, example = _tiny_fn()
    xb = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 6, 8)).astype(np.float32))
    per_sample = gcv.compile(fn, example, device=CPU)
    with pytest.warns(UserWarning, match="batch axis"):
        batched = gcv.compile(fn, {"x": xb}, batch=4, device=CPU)
    assert batched.plan.meta["input_shapes"] == \
        per_sample.plan.meta["input_shapes"]
    outs = batched.run(x=xb)[0]
    assert torch.equal(outs, build_runner(per_sample.plan, batch=4,
                                          device=CPU)(x=xb)[0])
    for i in range(4):
        assert torch.equal(outs[i], per_sample.run(x=xb[i])[0])


def test_batched_example_explicit_flag():
    fn, _ = _tiny_fn()
    xb = np.zeros((3, 6, 8), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # explicit flag: no warning
        model = gcv.compile(fn, {"x": xb}, example_batched=True, device=CPU)
    assert model.batch == 3
    assert model.plan.meta["input_shapes"]["x"] == (6, 8)
    kept = gcv.compile(torch.relu, {"x": np.zeros((3, 6), np.float32)},
                       example_batched=False, device=CPU)
    assert kept.plan.meta["input_shapes"]["x"] == (3, 6)
    with pytest.raises(AssertionError, match="does not match"):
        gcv.compile(fn, {"x": xb}, batch=5, example_batched=True,
                    device=CPU)


def test_serve_takes_fn_example_pairs_and_traced_graph_buckets():
    from repro_torch.gnncv.torch_tasks import (TRACED_SMALL_CONFIGS,
                                               TRACED_TASKS)
    cfg = TRACED_SMALL_CONFIGS["b6-dyn"]
    eng = gcv.serve(
        {"tiny": _tiny_fn(),
         "b6-dyn": lambda n: TRACED_TASKS["b6-dyn"](**{**cfg,
                                                      "n_points": n})},
        graph_buckets={"b6-dyn": [32, 64]}, max_batch=2, device=CPU)
    assert eng.models["tiny"].plan.meta["frontend"] == "tracer"
    assert eng.models["b6-dyn@g32"].plan.meta["frontend"] == "tracer"
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    r1 = eng.submit("tiny", x=x)
    r2 = eng.submit("b6-dyn", points=pts, mask=np.ones(20, np.float32))
    assert eng.run() == 2 and r2.task == "b6-dyn@g32"
    assert torch.equal(torch.as_tensor(r1.result[0]),
                       eng.models["tiny"].run(x=x)[0])
    padded = {"points": np.concatenate([pts, np.zeros((12, 3), np.float32)]),
              "mask": np.concatenate([np.ones(20, np.float32),
                                      np.zeros(12, np.float32)])}
    assert torch.equal(torch.as_tensor(r2.result[0]),
                       eng.models["b6-dyn@g32"].run(**padded)[0])
