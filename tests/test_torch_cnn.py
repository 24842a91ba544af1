"""The port's CNN + VIP slice against the JAX reference: b1 (few-shot),
b2 (ML-GCN) and b3-r50/r101 (DualGCN) end to end, the masked and COO VIP
graphs, windowed ``pool2d``, the batched conv and the SDDMM plain version.

Everything runs on ``device="cpu"``, where every kernel wrapper takes its
plain version; the reference runs under ``kernels="xla"`` and, for the
Pallas kernels, ``"pallas"`` in interpret mode, as its own tests run them.
Tolerance: ``max|Δ| <= 1e-5 · max|ref|`` (fp32 sums in another order; the
reference's own drift on this tree is ~1e-6 relative).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.core.ir import GraphBuilder as RefBuilder
from repro.gnncv.tasks import build_task as ref_build_task
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sddmm import sddmm as jsddmm
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.ir import GraphBuilder
from repro_torch.kernels import ref
from repro_torch.kernels.sddmm import BLOCK, live_tiles, sddmm
from repro_torch.kernels.shift_conv import shift_conv2d
from repro_torch.gnncv.tasks import build_task
from test_torch_cuda import (SDDMM_SHAPES, close, sddmm_inputs, t,
                             vip_masked_graph)

PORT_MODES = ["torch", "cuda"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def ref_task(task, small, ref_mode, seed):
    """-> (inputs, reference output) for one task, computed once."""
    plan = ref_compile(ref_build_task(task, small=small),
                       RefOptions(target="fpga", kernels=ref_mode))
    inputs = ref_random_inputs(plan, seed=seed)
    return inputs, np.asarray(ref_build_runner(plan)(**inputs)[0])


def port_out(plan, inputs):
    return build_runner(plan, device="cpu")(**inputs)[0].numpy()


def ref_graph_out(graph, inputs, ref_mode="xla"):
    plan = ref_compile(graph, RefOptions(target="fpga", kernels=ref_mode))
    return np.asarray(ref_build_runner(plan)(**inputs)[0])


def port_graph_out(graph, inputs, port_mode="torch"):
    return port_out(compile_graph(graph, CompileOptions(kernels=port_mode)),
                    inputs)


# ------------------------------------------------------ tasks end to end --
@pytest.mark.parametrize("port_mode", PORT_MODES)
@pytest.mark.parametrize("ref_mode", ["xla", "pallas"])
@pytest.mark.parametrize("task", ["b1", "b2", "b3-r50"])
def test_small_task_matches_reference(task, ref_mode, port_mode):
    inputs, want = ref_task(task, True, ref_mode, 0)
    plan = compile_graph(build_task(task, small=True),
                         CompileOptions(kernels=port_mode))
    got = port_out(plan, inputs)
    assert np.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("port_mode", PORT_MODES)
def test_b3_r101_small_matches_reference(port_mode):
    inputs, want = ref_task("b3-r101", True, "xla", 0)
    plan = compile_graph(build_task("b3-r101", small=True),
                         CompileOptions(kernels=port_mode))
    close(port_out(plan, inputs), want)


@pytest.mark.parametrize("port_mode", PORT_MODES)
def test_b1_full_width_matches_reference(port_mode):
    inputs, want = ref_task("b1", False, "xla", 3)
    assert inputs["images"].shape == (26, 1, 28, 28)
    plan = compile_graph(build_task("b1"), CompileOptions(kernels=port_mode))
    got = port_out(plan, inputs)
    assert got.shape == (26, 5)
    close(got, want)


# ------------------------------------------------------------ VIP graphs --
@pytest.mark.parametrize("port_mode", PORT_MODES)
@pytest.mark.parametrize("ref_mode", ["xla", "pallas"])
def test_vip_masked_graph_matches_reference(ref_mode, port_mode):
    """Nodes scaled by 2^-2, so the affinities peak near 4 (self ~16/16
    against neighbours' ±4/16) and the masked softmax mixes each window:
    a fault in the SDDMM, the masked softmax or the MP moves the output."""
    kw = dict(side=8, feat=16, win=3)
    nodes = np.random.default_rng(2).standard_normal((64, 16)) * 0.25
    inputs = {"nodes": nodes.astype(np.float32)}
    want = ref_graph_out(vip_masked_graph(RefBuilder, **kw), inputs,
                         ref_mode)
    got = port_graph_out(vip_masked_graph(GraphBuilder, **kw), inputs,
                         port_mode)
    assert got.shape == (64, 16)
    assert np.abs(got - inputs["nodes"]).max() > \
        0.1 * np.abs(inputs["nodes"]).max()
    close(got, want)


@pytest.mark.parametrize("port_mode", PORT_MODES)
def test_vip_coo_graph_matches_reference(port_mode):
    rng = np.random.default_rng(4)
    n, f, nnz = 40, 12, 150
    edges = (rng.integers(0, n, nnz), rng.integers(0, n, nnz))

    def graph(builder):
        b = builder("vip_coo")
        x = b.input((n, f), name="nodes")
        return b.output(b.vip(x, edges=edges, name="scores"))

    inputs = {"nodes": rng.standard_normal((n, f)).astype(np.float32)}
    plan = compile_graph(graph(GraphBuilder),
                         CompileOptions(kernels=port_mode))
    assert plan.ops[0].kernel == "coo_scatter"
    got = port_out(plan, inputs)
    assert got.shape == (nnz,)
    close(got, ref_graph_out(graph(RefBuilder), inputs))


# -------------------------------------------------------------- pool2d --
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("shape", [(5, 13, 11), (2, 3, 13, 11), (4, 12, 12)],
                         ids=str)
def test_pool2d_matches_reference(shape, kind):
    """3x3/2 SAME: odd sides pad (1, 1), even sides the TF split (0, 1)."""
    def graph(builder):
        b = builder("pool")
        x = b.input(shape, name="x")
        return b.output(b.pool(x, window=3, stride=2, kind=kind))

    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = port_graph_out(graph(GraphBuilder), {"x": x})
    assert got.shape == (*shape[:-2], -(-shape[-2] // 2), -(-shape[-1] // 2))
    close(got, ref_graph_out(graph(RefBuilder), {"x": x}))


# ---------------------------------------------------------- batched conv --
@pytest.mark.parametrize("groups", [1, 2])
def test_batched_conv_matches_reference_vmap(groups):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4, 9, 10)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4 // groups, 6)).astype(np.float32)
    kw = dict(stride=2, padding="SAME", groups=groups, dilation=(1, 1))
    got = shift_conv2d(t(x), t(w), **kw).numpy()
    assert got.shape == (3, 6, 5, 5)
    close(got, jops.conv2d(jnp.asarray(x), jnp.asarray(w), use_pallas=False,
                           **kw))
    for i in range(3):
        close(got[i], ref.conv2d_ref(t(x[i]), t(w), **kw).numpy())


# ----------------------------------------------------------------- sddmm --
@pytest.mark.parametrize("m,k,n,density", SDDMM_SHAPES[:3])
def test_sddmm_matches_pallas_and_ref(m, k, n, density):
    x, y, mask = sddmm_inputs(m, k, n, density)
    got = sddmm(t(x), t(y), t(mask)).numpy()
    np.testing.assert_array_equal(got, ref.sddmm_ref(t(x), t(y),
                                                     t(mask)).numpy())
    jx, jy, jm = map(jnp.asarray, (x, y, mask))
    close(got, jsddmm(jx, jy, jm, interpret=True))
    close(got, jref.sddmm_ref(jx, jy, jm))


def test_live_tiles_follow_the_mask():
    mask = torch.zeros((70, 40))
    mask[0, 0] = mask[69, 39] = 1.0
    live = live_tiles(mask)
    assert live.shape == (-(-70 // BLOCK), -(-40 // BLOCK))
    assert live.sum().item() == 2 and live[0, 0] and live[-1, -1]
