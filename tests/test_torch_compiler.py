"""The port's compiler (``repro_torch.core``) against the JAX reference.

For b1-b6, small and full configs, ``target="fpga"``: the port's plan under
``kernels="torch"`` must equal the reference's under ``"xla"``, and
``"cuda"`` the reference's ``"pallas"``, once kernel names are mapped per
family (``xla_*`` <-> ``torch_*``, ``pallas_*`` <-> ``cuda_*``): the same op
names, kinds, primitives, attrs, shapes, liveness, tiles and cycles, with
weights and ELL arrays identical bit for bit.  The same holds for the masked
VIP graph, whose mask is carried bit for bit.  Also pins the port's
independence: importing it loads neither ``jax`` nor ``repro``.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import CompileOptions as RefOptions
from repro.core import compile_graph as ref_compile
from repro.core.ir import GraphBuilder as RefBuilder
from repro.core.plan import KERNELS as REF_KERNELS
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch import obs
from repro_torch.core import CompileOptions, compile_graph
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.passes import select_kernels
from repro_torch.core.plan import KERNELS
from repro_torch.gnncv.tasks import build_task
from test_torch_cuda import vip_masked_graph, window_mask

ROOT = pathlib.Path(__file__).resolve().parents[1]
TASKS = ["b1", "b2", "b3-r50", "b3-r101", "b4", "b5", "b6"]
MODES = [("xla", "torch"), ("pallas", "cuda")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_kernel(name: str) -> str:
    """The reference's kernel name in the port's lattice."""
    for old, new in (("xla_", "torch_"), ("pallas_", "cuda_")):
        if name.startswith(old):
            return new + name[len(old):]
    return name


def assert_same_arrays(a: dict, b: dict, where: str):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        assert x.tobytes() == y.tobytes(), (where, k)


def assert_same_plan(port, ref):
    assert port.name == ref.name
    assert port.input_names == ref.input_names
    assert port.outputs == ref.outputs
    assert port.meta["input_shapes"] == ref.meta["input_shapes"]
    assert [o.name for o in port.ops] == [o.name for o in ref.ops]
    for p, r in zip(port.ops, ref.ops):
        where = f"{port.name}/{p.name}"
        assert (p.kind, p.inputs, p.portion) == (r.kind, r.inputs,
                                                 r.portion), where
        assert p.primitive == r.primitive, where
        assert p.kernel == port_kernel(r.kernel), where
        assert p.attrs == r.attrs, where
        assert tuple(p.out_shape) == tuple(r.out_shape), where
        assert p.frees == r.frees, where
        assert p.tiles == r.tiles, where
        assert (p.cycles, p.flops, p.bytes_moved) == \
            (r.cycles, r.flops, r.bytes_moved), where
        assert_same_arrays(p.weights, r.weights, where)
        assert (p.ell is None) == (r.ell is None), where
        if p.ell is not None:
            assert_same_arrays(dict(enumerate(p.ell)),
                               dict(enumerate(r.ell)), where + "/ell")
    for key in ("fpga_latency_s", "total_cycles_one_pe", "weight_bytes",
                "sparse_ops", "fused_layers"):
        assert port.meta[key] == ref.meta[key], key
    assert port.peak_live_bytes() == ref.peak_live_bytes()


@pytest.mark.parametrize("ref_mode,port_mode", MODES)
@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
@pytest.mark.parametrize("task", TASKS)
def test_plan_parity(task, small, ref_mode, port_mode):
    ref = ref_compile(ref_build_task(task, small=small),
                      RefOptions(target="fpga", kernels=ref_mode))
    port = compile_graph(build_task(task, small=small),
                         CompileOptions(target="fpga", kernels=port_mode))
    assert_same_plan(port, ref)


@pytest.mark.parametrize("ref_mode,port_mode", MODES)
def test_vip_masked_plan_parity(ref_mode, port_mode):
    ref = ref_compile(vip_masked_graph(RefBuilder),
                      RefOptions(target="fpga", kernels=ref_mode))
    port = compile_graph(vip_masked_graph(GraphBuilder),
                         CompileOptions(target="fpga", kernels=port_mode))
    assert_same_plan(port, ref)
    vip = port.ops[0]
    assert (vip.kind, vip.kernel) == ("sddmm", f"{port_mode}_sddmm")
    assert vip.weights["mask"].tobytes() == window_mask(14, 5).tobytes()
    assert vip.attrs["nnz"] == 4096


def test_lattice_maps_one_to_one():
    assert {port_kernel(k) for k in REF_KERNELS} == set(KERNELS)
    assert len(KERNELS) == len(REF_KERNELS)


def test_options_default_to_cuda_on_the_fpga_model():
    opts = CompileOptions()
    assert (opts.kernels, opts.target) == ("cuda", "fpga")


@pytest.mark.parametrize("mode", ["auto", "measured"])
def test_cost_model_modes_wait_for_the_gpu_model(mode, tmp_path):
    """Kept under its earlier name (the modes once raised until the GPU
    model came).  Checks that ``auto`` and ``measured`` now bind off the
    card (every twin there) and record the backend; unknown modes
    raise."""
    plan = compile_graph(build_task("b4", small=True))
    select_kernels(plan, kernels=mode, backend="cpu",
                   autotune_cache=str(tmp_path / "at.json"))
    assert plan.meta["kernels_mode"] == mode
    assert plan.meta["kernels_backend"] == "cpu"
    assert not any(op.kernel.startswith("cuda_") for op in plan.ops)
    with pytest.raises(ValueError):
        select_kernels(plan, kernels="pallas")


def test_kernel_choices_record_no_predicted_seconds():
    """Kept under its earlier name.  Checks the opposite of it: every
    candidate now records the H100 model's predicted seconds, and
    ``measured_s`` stays None outside measured mode."""
    plan = compile_graph(build_task("b4", small=True))
    choice = plan.meta["kernel_choices"]["gcn0_mp"]
    assert choice["kernel"] == "cuda_ell_spdmm"
    assert choice["candidates"] == ["torch_ell_spdmm", "cuda_ell_spdmm"]
    assert set(choice["predicted_s"]) == set(choice["candidates"])
    assert all(v > 0 for v in choice["predicted_s"].values())
    assert choice["measured_s"] is None


def test_compile_spans_match_the_reference():
    def span_names(tracer, fn):
        tracer.clear()
        fn()
        return [(sp.name, sp.parent) for sp in tracer.spans]

    ours = span_names(obs.get_tracer(), lambda: compile_graph(
        build_task("b4", small=True), CompileOptions(telemetry=True)))
    theirs = span_names(robs.get_tracer(), lambda: ref_compile(
        ref_build_task("b4", small=True),
        RefOptions(target="fpga", kernels="pallas", telemetry=True)))
    assert ours == theirs
    assert ("compile", None) in ours and len(ours) == 8


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.kernels, "
            "repro_torch.gnncv.tasks, repro_torch.core.weights, "
            "repro_torch.models.transformer, repro_torch.models.weights, "
            "repro_torch.models.ssm, repro_torch.models.moe, "
            "repro_torch.models.attention, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.gcv, "
            "repro_torch.obs.profile, repro_torch.core.runtime.cache, "
            "repro_torch.core.autotune, repro_torch.core.perf_model, "
            "repro_torch.serve.gnncv, repro_torch.serve.scheduler, "
            "repro_torch.frontend, repro_torch.gnncv.torch_tasks, "
            "repro_torch.gnncv.gnn_zoo, repro_torch.kernels.ops, "
            "repro_torch.train, repro_torch.data, "
            "repro_torch.launch.train, "
            "repro_torch.configs.qwen2_72b, "
            "repro_torch.configs.codeqwen1_5_7b, "
            "repro_torch.configs.chameleon_34b, "
            "repro_torch.configs.musicgen_medium, "
            "repro_torch.launch.mesh, repro_torch.distributed, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.collectives, "
            "repro_torch.distributed.pipeline, "
            "repro_torch.launch.dryrun, repro_torch.launch.step_analysis, "
            "repro_torch.launch.roofline, repro_torch.launch.perf_probe\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\nassert not bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                         r"import\s+repro\.|import\s+repro\s*$|"
                         r"from\s+repro[\s.])", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, (f, hits)
