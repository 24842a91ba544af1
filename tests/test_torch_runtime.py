"""The port's runtime (``repro_torch.core.executor``) against the reference.

b4 (ST-GCN) end to end on ``device="cpu"``, where every kernel wrapper
runs its plain version: the port's output must match the reference's
``build_runner(plan)`` under ``kernels="xla"`` and ``kernels="pallas"``
(interpret mode) within ``max|Δ| <= 1e-5 · max|ref|`` — reference drift
on this tree is ~1e-6 relative.  Also: parameters carried across with
``load_weights`` (the ELL pair and a masked VIP's mask), the no-CUDA
guard, dense max-aggregation (``maxagg``) against the reference, float64
inputs cast to float32 as the reference casts them, and b4's ELL products
running on views of their operands.  b5,
b6 and b6-dyn are in ``test_torch_dynamic.py``; b1-b3 and the VIP graphs in
``test_torch_cnn.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.core.ir import GraphBuilder as RefBuilder
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.plan import MATOP_KINDS
from repro_torch.core.runtime import registered_kinds, run_op
from repro_torch.core.runtime.residency import ELL_IDX, ELL_VAL
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_task
from test_torch_cuda import vip_masked_graph, window_mask

RTOL = 1e-5


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
    assert err <= rtol * np.abs(want).max(), err / np.abs(want).max()


def port_outputs(plan, inputs, **kw):
    return [o.numpy() for o in build_runner(plan, device="cpu", **kw)(
        **inputs)]


def ref_outputs(plan, inputs):
    return [np.asarray(o) for o in ref_build_runner(plan)(**inputs)]


def exported(plan) -> dict:
    """A compiled reference plan's parameters as ``load_weights`` takes
    them."""
    out = {}
    for op in plan.ops:
        slots = {k: np.asarray(v) for k, v in op.weights.items()}
        if op.ell is not None:
            slots[ELL_IDX], slots[ELL_VAL] = map(np.asarray, op.ell)
        if slots:
            out[op.name] = slots
    return out


@pytest.mark.parametrize("port_mode", ["torch", "cuda"])
@pytest.mark.parametrize("ref_mode", ["xla", "pallas"])
def test_b4_small_matches_reference(ref_mode, port_mode):
    ref = ref_compile(ref_build_task("b4", small=True),
                      RefOptions(target="fpga", kernels=ref_mode))
    plan = compile_graph(build_task("b4", small=True),
                         CompileOptions(kernels=port_mode))
    for seed in (0, 7):
        inputs = ref_random_inputs(ref, seed=seed)
        (got,), (want,) = port_outputs(plan, inputs), ref_outputs(ref,
                                                                  inputs)
        assert got.shape == (60,) and np.isfinite(got).all()
        close(got, want)


def test_b4_full_width_matches_reference():
    ref = ref_compile(ref_build_task("b4"),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(build_task("b4"), CompileOptions(kernels="cuda"))
    inputs = ref_random_inputs(ref, seed=3)
    assert inputs["skeleton"].shape == (3, 150, 25)
    close(port_outputs(plan, inputs)[0], ref_outputs(ref, inputs)[0])


def test_random_inputs_replay_the_reference():
    plan = compile_graph(build_task("b4", small=True))
    ref = ref_compile(ref_build_task("b4", small=True),
                      RefOptions(target="fpga", kernels="xla"))
    ours, theirs = random_inputs(plan, seed=5), ref_random_inputs(ref,
                                                                  seed=5)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_load_weights_carries_reference_parameters():
    ref = ref_compile(ref_build_task("b4", small=True, seed=1),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(build_task("b4", small=True, seed=2))
    inputs = ref_random_inputs(ref, seed=0)
    want = ref_outputs(ref, inputs)[0]
    before = port_outputs(plan, inputs)[0]
    assert np.abs(before - want).max() > 1e-3      # different seeds differ
    arrays = exported(ref)
    assert any(ELL_IDX in s for s in arrays.values())
    load_weights(plan, arrays)
    close(port_outputs(plan, inputs)[0], want)


def test_load_weights_carries_a_masked_vip_mask():
    kw = dict(side=6, feat=8)
    ref = ref_compile(vip_masked_graph(RefBuilder, win=3, **kw),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(vip_masked_graph(GraphBuilder, win=5, **kw))
    inputs = ref_random_inputs(ref, seed=0)
    want = ref_outputs(ref, inputs)[0]
    assert np.abs(port_outputs(plan, inputs)[0] - want).max() > 1e-3
    arrays = exported(ref)
    assert set(arrays) == {"aff", "aff_sm"}
    assert all(set(slots) == {"mask"} for slots in arrays.values())
    load_weights(plan, arrays)
    for op in plan.ops[:2]:
        assert op.weights["mask"].tobytes() == \
            window_mask(6, 3).tobytes()
    close(port_outputs(plan, inputs)[0], want)


def test_load_weights_rejects_mismatches():
    plan = compile_graph(build_task("b4", small=True))
    with pytest.raises(KeyError):
        load_weights(plan, {"nope": {"w": np.zeros(1)}})
    with pytest.raises(ValueError):
        load_weights(plan, {"tcn0": {"w": np.zeros((3, 1, 16, 16),
                                                   np.float32)}})
    with pytest.raises(ValueError):
        load_weights(plan, {"gcn0_mp": {ELL_IDX: np.zeros((25, 5),
                                                          np.int64)}})


def test_free_dead_matches_keep_everything():
    plan = compile_graph(build_task("b4", small=True))
    inputs = random_inputs(plan, seed=1)
    np.testing.assert_array_equal(port_outputs(plan, inputs)[0],
                                  port_outputs(plan, inputs,
                                               free_dead=False)[0])


def test_resident_store_holds_live_arrays_only():
    plan = compile_graph(build_task("b4", small=True))
    store = build_runner(plan, device="cpu").resident
    ell = store.get(plan.ops[1], ELL_IDX)
    assert plan.ops[1].kernel == "cuda_ell_spdmm"
    assert ell.dtype == torch.int32 and not store.has(plan.ops[1], "adj")
    assert store.nbytes() > 0


def test_build_runner_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = compile_graph(build_task("b4", small=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runner(plan)


def test_registry_covers_lowering_vocabulary():
    assert registered_kinds() == MATOP_KINDS


def test_maxagg_is_not_ported_and_says_so():
    """Kept under its earlier name (``maxagg`` once raised, naming
    ROADMAP).  Dense-adjacency max aggregation now runs, bound to the
    gather family, and equals the reference exactly (a max)."""
    def graph(builder):
        b = builder("maxagg")
        x = b.input((6, 4), name="nodes")
        return b.output(b.mp(x, adj=np.eye(6, dtype=np.float32),
                             reduce="max"))
    plan = compile_graph(graph(GraphBuilder))
    assert [(op.kind, op.kernel) for op in plan.ops] == \
        [("maxagg", "torch_ell_spdmm")]
    inputs = random_inputs(plan, seed=0)
    got = build_runner(plan, device="cpu")(**inputs)[0].numpy()
    ref = ref_compile(graph(RefBuilder), RefOptions(target="fpga"))
    np.testing.assert_array_equal(got, np.asarray(
        ref_build_runner(ref)(**inputs)[0]))
    np.testing.assert_array_equal(got, inputs["nodes"])


def test_kernelless_op_is_refused():
    plan = compile_graph(build_task("b4", small=True))
    op = plan.ops[0]
    op.kernel = None
    with pytest.raises(ValueError, match="no kernel bound"):
        run_op(op, {op.inputs[0]: torch.zeros(3, 16, 25)})


@pytest.mark.parametrize("task", ["b4", "b1"])
def test_float64_inputs_run_as_float32_like_the_reference(task):
    """The reference stages inputs with ``jnp.asarray`` (x64 off), which
    makes float64 float32.  The port casts the same way, numpy arrays and
    tensors alike: its outputs are float32 and equal the float32 run bit
    for bit, and the float64 run matches the reference's float64 run."""
    ref = ref_compile(ref_build_task(task, small=True),
                      RefOptions(target="fpga", kernels="xla"))
    plan = compile_graph(build_task(task, small=True),
                         CompileOptions(kernels="cuda"))
    inputs = random_inputs(plan, seed=0)
    wide = {k: np.asarray(v, np.float64) for k, v in inputs.items()}
    assert all(v.dtype == np.float64 for v in wide.values())
    run = build_runner(plan, device="cpu")
    want = run(**inputs)
    for staged in (wide, {k: torch.from_numpy(v) for k, v in wide.items()}):
        got = run(**staged)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w)
    theirs = ref_outputs(ref, wide)
    assert all(o.dtype == np.float32 for o in theirs)
    for g, w in zip(port_outputs(plan, wide), theirs):
        close(g, w)


def test_float_inputs_keep_narrow_and_integer_types():
    from repro_torch.core.executor import _as_tensor
    cpu = torch.device("cpu")
    for value, dtype in ((np.zeros(3, np.float32), torch.float32),
                         (np.zeros(3, np.float16), torch.float16),
                         (torch.zeros(3, dtype=torch.bfloat16),
                          torch.bfloat16),
                         (np.arange(3, dtype=np.int64), torch.int64),
                         (np.arange(3, dtype=np.int32), torch.int32),
                         (np.zeros(3, np.float64), torch.float32),
                         (torch.zeros(3, dtype=torch.float64),
                          torch.float32)):
        assert _as_tensor(value, cpu).dtype == dtype


def test_b4_ell_products_make_no_transposing_copy(monkeypatch):
    """b4's ``right_t`` ELL ops hand ``spdmm_rows`` the ``(C·T, V)`` view
    of their input and return a view of its output: no copy either way
    (here on the CPU, where the wrapper runs its twin)."""
    from repro_torch.core.runtime import matmul
    plan = compile_graph(build_task("b4", small=True),
                         CompileOptions(kernels="cuda"))
    ell = [op for op in plan.ops if op.kernel == "cuda_ell_spdmm"]
    assert ell and all(op.attrs["weight_side"] == "right_t" for op in ell)
    calls = []
    real = matmul.spdmm_rows

    def recording(idx, val, x2):
        out = real(idx, val, x2)
        calls.append((x2.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(matmul, "spdmm_rows", recording)
    names = [n for op in ell for n in (op.inputs[0], op.name)]
    run = build_runner(dataclasses.replace(plan, outputs=names),
                       device="cpu", free_dead=False)
    outs = run(**random_inputs(plan, seed=0))
    assert len(calls) == len(ell)
    for (x2_ptr, out_ptr), i in zip(calls, range(0, len(outs), 2)):
        assert outs[i].data_ptr() == x2_ptr          # the input, as a view
        assert outs[i + 1].data_ptr() == out_ptr     # the output, as a view
