"""The port's runtime (``repro_torch.core.executor``) against the reference.

b4 (ST-GCN) end to end on ``device="cpu"``, where every kernel wrapper
runs its plain version: the port's output must match the reference's
``build_runner(plan)`` under ``kernels="xla"`` and ``kernels="pallas"``
(interpret mode) within ``max|Δ| <= 1e-5 · max|ref|`` — reference drift
on this tree is ~1e-6 relative.  Also: parameters carried across with
``load_weights``, the no-CUDA guard, and the loud failure of kinds not
ported yet (b1-b3; b5, b6 and b6-dyn are in ``test_torch_dynamic.py``).
"""
import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import build_runner as ref_build_runner
from repro.core import compile_graph as ref_compile
from repro.core.executor import random_inputs as ref_random_inputs
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch.core import CompileOptions, build_runner, compile_graph
from repro_torch.core.executor import random_inputs
from repro_torch.core.plan import MATOP_KINDS
from repro_torch.core.runtime import registered_kinds, run_op
from repro_torch.core.runtime.residency import ELL_IDX, ELL_VAL
from repro_torch.core.weights import load_weights
from repro_torch.gnncv.tasks import build_task

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


@pytest.mark.parametrize("task", ["b1", "b2", "b3-r50"])
def test_out_of_slice_kinds_raise(task):
    plan = compile_graph(build_task(task, small=True))
    run = build_runner(plan, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run(**random_inputs(plan, seed=0))


def test_kernelless_op_is_refused():
    plan = compile_graph(build_task("b4", small=True))
    op = plan.ops[0]
    op.kernel = None
    with pytest.raises(ValueError, match="no kernel bound"):
        run_op(op, {op.inputs[0]: torch.zeros(3, 16, 25)})
