"""Step 4b on the port: the H100 cost model, ``kernels="auto"`` and
``"measured"``, the autotune cache, and the predicted-vs-measured report,
on the CPU.

Counterparts of ``tests/test_kernel_select.py``:

- off the card ``auto`` binds exactly what ``torch`` binds (every
  ``cuda_*`` candidate pays the off-card penalty) and its outputs equal
  the ``torch`` plan's bit for bit on b1-b6 and b6-dyn (small), as the
  reference's ``auto`` equals its ``xla`` plan off the TPU;
- the H100 model's crossovers at the paths' full-width shapes
  (``backend="cuda"``, no card needed): cuBLAS (``torch_dense``) wins
  b6's ``(1024, 256) @ (256, 1024)``, the CUDA kernels win conv, ELL
  SpDMM, SDDMM and KNN;
- re-binding in place by backend, ``kernel_report``'s predicted column,
  ``gcv.compile(plan, kernels=...)``, the plan cache keyed on the backend
  under ``auto``;
- the autotune cache (round trip, versioned file, two writers merge,
  corrupt file, signature ignores weight values) and measured mode off
  the card (the ``cuda_*`` candidates are not measured; the twin is bound
  with the reason recorded).

Nothing here reads the wall clock for a verdict: measured timings only
pick among twins whose outputs are checked by tolerance.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import CompileOptions as RefOptions
from repro.core import compile_graph as ref_compile
from repro.core.autotune import op_signature as ref_op_signature
from repro.core.passes import select_kernels as ref_select_kernels
from repro_torch import gcv
from repro_torch.core import CompileOptions, compile_graph
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.autotune import AutotuneCache, op_signature
from repro_torch.core.executor import random_inputs
from repro_torch.core.passes import kernel_report, select_kernels
from repro_torch.core.perf_model import (OFF_CARD_PENALTY,
                                         predict_kernel_seconds)
from repro_torch.core.plan import KERNELS
from repro_torch.core.runtime.cache import (cache_stats, cached_plan,
                                            clear_caches)
from repro.gnncv.tasks import build_task as ref_build_task
from repro_torch.gnncv.tasks import build_dynamic_task, build_task

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_compiler import port_kernel  # noqa: E402

CPU = "cpu"
SEED = 11
TASKS = ["b1", "b2", "b3-r50", "b4", "b5", "b6", "b6-dyn"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _graph(task):
    if task == "b6-dyn":
        return build_dynamic_task(task, small=True)
    return build_task(task, small=True)


def _model(task, **kw):
    return gcv.compile(_graph(task), device=CPU, **kw)


# ------------------------------------------------------- auto off the card --
@pytest.mark.parametrize("task", TASKS)
def test_auto_binds_the_twins_off_the_card_bit_for_bit(task):
    auto = _model(task, kernels="auto")
    plain = _model(task, kernels="torch")
    assert auto.plan.meta["kernels_backend"] == "cpu"
    assert auto.plan.kernel_counts() == plain.plan.kernel_counts()
    assert not any(k.startswith("cuda_") for k in auto.plan.kernel_counts())
    choices = auto.plan.meta["kernel_choices"]
    assert set(choices) == {op.name for op in auto.plan.ops}
    for op in auto.plan.ops:
        c = choices[op.name]
        assert op.kernel == c["kernel"] in KERNELS
        assert set(c["predicted_s"]) == set(c["candidates"])
        assert all(v > 0 for v in c["predicted_s"].values())
        if len(c["candidates"]) > 1:
            assert c["source"] == "predicted"
    ins = auto.random_inputs(seed=SEED)
    for a, b in zip(auto.run(**ins), plain.run(**ins)):
        assert torch.equal(a, b)


def test_off_card_penalty_makes_every_cuda_candidate_lose():
    for twin, kern, dims in [
            ("torch_dense", "cuda_ddmm", dict(s1=1024, s2=256, s3=1024)),
            ("torch_ell_spdmm", "cuda_ell_spdmm",
             dict(s1=25, s2=25, s3=9600, nnz=125)),
            ("torch_knn", "cuda_knn", dict(s1=1024, s2=3, s3=1024,
                                           nnz=20480))]:
        on = predict_kernel_seconds(kern, backend="cuda", **dims)
        off = predict_kernel_seconds(kern, backend="cpu", **dims)
        assert off == pytest.approx(on * OFF_CARD_PENALTY)
        assert off > predict_kernel_seconds(twin, backend="cpu", **dims)


# ------------------------------------------------ H100 model's crossovers --
# The paths' full-width shapes, in ``_op_dims``'s orientation.
CROSSOVERS = {
    # b6's (1024, 256) @ (256, 1024): cuBLAS 17 us against DDMM's 32 us
    # by events (PERF.md §6)
    "b6-dense-1024x256x1024": ("torch_dense", "cuda_ddmm",
                               dict(s1=1024, s2=256, s3=1024)),
    # b4's temporal 9x1 conv, 64 channels over (150, 25)
    "b4-conv-9x1": ("cuda_ddmm", "torch_dense",
                    dict(s1=150 * 25, s2=9 * 64, s3=64, taps=9, conv=True)),
    # b2's 3x3 conv at 56x56
    "b2-conv-3x3": ("cuda_ddmm", "torch_dense",
                    dict(s1=56 * 56, s2=9 * 64, s3=64, taps=9, conv=True)),
    # b1's first conv over the 26-image stack
    "b1-conv-stack": ("cuda_ddmm", "torch_dense",
                      dict(s1=26 * 28 * 28, s2=9, s3=64, taps=9,
                           conv=True)),
    # b5's 3x3 conv at 128x128
    "b5-conv-3x3": ("cuda_ddmm", "torch_dense",
                    dict(s1=128 * 128, s2=9 * 48, s3=48, taps=9,
                         conv=True)),
    # b4's ELL aggregation: A (25 x 25, 5 slots a row) @ (C·T)-row views
    "b4-ell": ("cuda_ell_spdmm", "torch_ell_spdmm",
               dict(s1=25, s2=25, s3=19200, nnz=125)),
    # vip-masked: (196, 512) x (512, 196) under a 0.107-dense mask
    "vip-masked-sddmm": ("cuda_sddmm", "torch_sddmm",
                         dict(s1=196, s2=512, s3=196, nnz=4096,
                              masked=True)),
    # b6-dyn: 1024 points of 3 features, k = 20
    "b6-dyn-knn": ("cuda_knn", "torch_knn",
                   dict(s1=1024, s2=3, s3=1024, nnz=20480)),
    # an ELL matrix on the left runs the columns kernel, whose threads walk
    # every stored slot in turn: 8000 slots lose to the gather, 360 win
    "ell-columns-1000x8": ("torch_ell_spdmm", "cuda_ell_spdmm",
                           dict(s1=1000, s2=1000, s3=256, nnz=8000,
                                columns=True)),
    "ell-columns-120x3": ("cuda_ell_spdmm", "torch_ell_spdmm",
                          dict(s1=120, s2=120, s3=4096, nnz=360,
                               columns=True)),
}


@pytest.mark.parametrize("case", sorted(CROSSOVERS))
def test_h100_model_crossovers(case):
    winner, loser, dims = CROSSOVERS[case]
    assert predict_kernel_seconds(winner, backend="cuda", **dims) \
        < predict_kernel_seconds(loser, backend="cuda", **dims)


@pytest.mark.parametrize("dims, small", [
    (dict(s1=196, s2=512, s3=196), True),
    (dict(s1=26, s2=400, s3=26), True),
    (dict(s1=1024, s2=2048, s3=1024), False)])
def test_unmasked_vip_twin_is_a_gram_on_cublas(dims, small):
    """Without a mask the VIP's twin is cuBLAS's ``x @ xᵀ``: at the
    paths' sizes it sits on its own host floor, above DDMM's, and at a
    large size it costs what the dense product of the same dims does."""
    gram = predict_kernel_seconds("torch_sddmm", backend="cuda", **dims)
    dense = predict_kernel_seconds("torch_dense", backend="cuda", **dims)
    ddmm = predict_kernel_seconds("cuda_sddmm", backend="cuda", **dims)
    if small:
        assert gram > ddmm > dense
    else:
        assert gram == dense < ddmm


def test_ell_on_the_left_is_priced_as_the_columns_kernel():
    """``_op_dims`` marks an ELL matrix on the left (the columns kernel)
    and not b4's right-side products (the rows kernel)."""
    from repro_torch.core.passes.select import _op_dims
    b = GraphBuilder("ell_left")
    adj = np.eye(64, dtype=np.float32)[np.roll(np.arange(64), 1)] \
        + np.eye(64, dtype=np.float32)
    b.output(b.mp(b.input((64, 32), name="x"), adj=adj, name="left"))
    plan = compile_graph(b.g, CompileOptions(kernels="auto"),
                         backend="cuda")
    op = next(op for op in plan.ops if op.name == "left")
    assert op.ell is not None
    assert _op_dims(op, "cuda_ell_spdmm")["columns"]
    b4 = compile_graph(build_task("b4", small=True),
                       CompileOptions(kernels="auto"), backend="cuda")
    assert not any(_op_dims(op, "cuda_ell_spdmm").get("columns")
                   for op in b4.ops if op.ell is not None)


def test_auto_on_the_card_binds_cublas_only_where_it_wins():
    """Full-width b6 and b4 selected for the card (no card needed to
    select): b6's large products go to cuBLAS, b4 keeps every kernel."""
    b6 = compile_graph(build_task("b6"), CompileOptions(kernels="auto"),
                       backend="cuda")
    kinds = {op.name: op.kernel for op in b6.ops if op.kind == "mm"
             and op.attrs["weight_side"] == "right"}
    big = [n for n, op in ((op.name, op) for op in b6.ops)
           if op.kind == "mm" and op.attrs.get("s2") == 256
           and op.attrs.get("s3") == 1024]
    assert big and all(kinds[n] == "torch_dense" for n in big)
    b4 = compile_graph(build_task("b4"), CompileOptions(kernels="auto"),
                       backend="cuda")
    counts = b4.kernel_counts()
    assert counts.get("cuda_ell_spdmm") and not counts.get("torch_ell_spdmm")
    assert all(op.kernel == "cuda_ddmm" for op in b4.ops
               if op.kind == "conv")


# ----------------------------------------------- re-binding and reporting --
def test_backend_rebinds_in_place():
    plan = compile_graph(build_task("b4"), CompileOptions(kernels="auto"),
                         backend="cpu")
    assert not any(k.startswith("cuda_") for k in plan.kernel_counts())
    same = select_kernels(plan, kernels="auto", backend="cuda")
    assert same is plan and plan.meta["kernels_backend"] == "cuda"
    assert plan.kernel_counts().get("cuda_ell_spdmm")
    assert {op.kernel for op in plan.ops} \
        == {c["kernel"] for c in plan.meta["kernel_choices"].values()}
    select_kernels(plan, kernels="auto", backend="cpu")
    assert not any(k.startswith("cuda_") for k in plan.kernel_counts())
    with pytest.raises(ValueError, match="backend"):
        select_kernels(plan, kernels="auto", backend="tpu")
    with pytest.raises(ValueError, match="kernels"):
        select_kernels(plan, kernels="pallas")


def test_kernel_report_prints_the_predicted_column():
    plan = _model("b4", kernels="auto").plan
    text = kernel_report(plan)
    assert "mode=auto, backend=cpu" in text
    lines = [ln for ln in text.splitlines()[1:-1]]
    assert len(lines) == len(plan.ops)
    for op, line in zip(plan.ops, lines):
        want = plan.meta["kernel_choices"][op.name]["predicted_s"][op.kernel]
        assert "predicted" in line and f"{want * 1e6:8.2f} us" in line
    assert "totals:" in text.splitlines()[-1]


def test_gcv_compile_of_a_plan_rebinds_its_kernels():
    plan = compile_graph(_graph("b4"), CompileOptions(kernels="cuda"))
    assert plan.kernel_counts().get("cuda_ell_spdmm")
    model = gcv.compile(plan, kernels="auto", device=CPU)
    assert model.plan is plan and plan.meta["kernels_mode"] == "auto"
    assert not any(k.startswith("cuda_") for k in plan.kernel_counts())
    gcv.compile(plan, kernels="cuda", device=CPU)
    assert plan.meta["kernels_mode"] == "cuda"
    assert plan.kernel_counts().get("cuda_ell_spdmm")


def test_plan_cache_keys_on_backend_under_auto():
    clear_caches()
    g = _graph("b4")
    auto = CompileOptions(kernels="auto")
    on_cpu = cached_plan(g, auto, backend="cpu")
    on_card = cached_plan(g, auto, backend="cuda")
    assert on_cpu is not on_card
    assert on_cpu.kernel_counts() != on_card.kernel_counts()
    assert cached_plan(g, auto, backend="cpu") is on_cpu
    cuda = CompileOptions(kernels="cuda")
    assert cached_plan(g, cuda, backend="cpu") \
        is cached_plan(g, cuda, backend="cuda")
    assert cache_stats()["plans"] == 3
    # the façade keys its plan on the device it compiles for
    assert gcv.compile(g, kernels="auto", device=CPU).plan is on_cpu


# ------------------------------------------------ measured mode and cache --
def _cache_case_round_trip(tmp_path):
    path = str(tmp_path / "autotune.json")
    clear_caches()
    first = _model("b1", kernels="measured", autotune_cache=path)
    at1 = first.plan.meta["autotune"]
    assert at1["measured_signatures"] > 0
    clear_caches()          # drop the memoized plan, not the autotune file
    second = _model("b1", kernels="measured", autotune_cache=path)
    at2 = second.plan.meta["autotune"]
    assert at2["measured_signatures"] == 0 and at2["cache_hits"] > 0
    assert {n: c["kernel"]
            for n, c in first.plan.meta["kernel_choices"].items()} == \
           {n: c["kernel"]
            for n, c in second.plan.meta["kernel_choices"].items()}
    plain = _model("b1", kernels="torch")
    ins = random_inputs(second.plan, seed=SEED)
    for a, b in zip(second.run(**ins), plain.run(**ins)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def _cache_case_versioned_file(tmp_path):
    path = tmp_path / "at.json"
    cache = AutotuneCache(path)
    cache.store("sig", {"torch_dense": 1e-6})
    cache.save()
    blob = path.read_text()
    assert '"version"' in blob and '"torch_dense"' in blob
    assert AutotuneCache(path).lookup("sig") == {"torch_dense": 1e-6}
    path.write_text('{"version": 0, "entries": {"sig": {"x": 1.0}}}')
    assert AutotuneCache(path).lookup("sig") is None


def _cache_case_two_writers_merge(tmp_path):
    path = tmp_path / "at.json"
    a = AutotuneCache(path)
    b = AutotuneCache(path)            # opened before a writes anything
    a.store("sig_a", {"torch_dense": 1e-6})
    a.store("shared", {"torch_dense": 3e-6, "cuda_ddmm": 9e-6})
    a.save()
    b.store("sig_b", {"cuda_ddmm": 2e-6})
    b.store("shared", {"torch_dense": 4e-6})
    b.save()                           # merges a's entries from disk
    merged = AutotuneCache(path)
    assert merged.lookup("sig_a") == {"torch_dense": 1e-6}
    assert merged.lookup("sig_b") == {"cuda_ddmm": 2e-6}
    assert merged.lookup("shared") == {"torch_dense": 4e-6,
                                       "cuda_ddmm": 9e-6}
    assert [p.name for p in tmp_path.iterdir()] == ["at.json"]


def _cache_case_corrupt_file(tmp_path):
    path = tmp_path / "at.json"
    path.write_text("{not json")
    cache = AutotuneCache(path)
    assert cache.entries == {}
    cache.store("sig", {"torch_dense": 1e-6})
    cache.save()
    assert AutotuneCache(path).lookup("sig") == {"torch_dense": 1e-6}


def _cache_case_signature_ignores_weight_values(tmp_path):
    """Two ops differing only in weight values share one signature, and
    the signature reads as the reference's with the port's backend."""
    plan = _model("b1").plan
    dense = [op for op in plan.ops if op.kind == "mm"
             and op.weights.get("w") is not None]
    a = dense[0]
    sig = op_signature(a, "cuda")
    assert sig.split("|")[0] == "mm" and sig.split("|")[-2] == "cuda"
    assert sig == ref_op_signature(a, "cuda")
    twin = type(a)(**{**a.__dict__,
                      "weights": {k: v * 3 for k, v in a.weights.items()}})
    assert op_signature(twin, "cuda") == sig


CACHE_CASES = {
    "round_trip": _cache_case_round_trip,
    "versioned_file": _cache_case_versioned_file,
    "two_writers_merge": _cache_case_two_writers_merge,
    "corrupt_file": _cache_case_corrupt_file,
    "signature_ignores_weight_values":
        _cache_case_signature_ignores_weight_values,
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_autotune_cache(case, tmp_path):
    CACHE_CASES[case](tmp_path)


def test_measured_off_the_card_binds_twins_and_says_why(tmp_path):
    model = _model("b4", kernels="measured",
                   autotune_cache=str(tmp_path / "at.json"))
    plan = model.plan
    assert plan.meta["kernels_backend"] == "cpu"
    assert not any(k.startswith("cuda_") for k in plan.kernel_counts())
    measured = [c for c in plan.meta["kernel_choices"].values()
                if c["source"] == "measured"]
    assert measured
    for c in measured:
        assert c["kernel"] in c["measured_s"]
        assert not any(k.startswith("cuda_") for k in c["measured_s"])
        assert "not measured" in c["reason"] and "card" in c["reason"]
        # measured mode may cross ELL -> dense, as the reference's does
        if c["candidates"][0] == "torch_ell_spdmm":
            assert c["candidates"][2:] == ["torch_dense", "cuda_ddmm"]
    plain = _model("b4", kernels="torch")
    ins = random_inputs(plan, seed=SEED)
    for a, b in zip(model.run(**ins), plain.run(**ins)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_auto_off_the_card_matches_the_reference_per_op():
    """Off the accelerator both packages' ``auto`` bind the plain member
    of every family, op by op, from the same candidate families under the
    name mapping (xla -> torch, pallas -> cuda)."""
    ref_plan = ref_compile(ref_build_task("b4", small=True),
                           RefOptions(target="fpga", kernels="xla"))
    ref_select_kernels(ref_plan, kernels="auto", backend="cpu")
    port_plan = compile_graph(build_task("b4", small=True),
                              CompileOptions(kernels="auto"), backend="cpu")
    for op in port_plan.ops:
        mine = port_plan.meta["kernel_choices"][op.name]
        theirs = ref_plan.meta["kernel_choices"][op.name]
        assert mine["candidates"] == [port_kernel(k)
                                      for k in theirs["candidates"]]
        assert mine["kernel"] == port_kernel(theirs["kernel"])


def test_profile_report_computes_the_agreement_rate(tmp_path):
    """A measured-mode plan off the card still races two twins on b4's
    ELL ops (the gather SpDMM and the dense product), so those ops are
    considered: each row's verdict is its predicted argmin against its
    measured argmin over the twins timed, and the rate their share."""
    model = _model("b4", kernels="measured",
                   autotune_cache=str(tmp_path / "at.json"))
    report = model.profile_report(repeats=1)
    rows = [r for r in report["rows"] if r["agree"] is not None]
    assert rows and report["agreement"]["considered"] == len(rows)
    for r in rows:
        meas, pred = r["candidates_s"], r["candidates_predicted_s"]
        assert set(meas) == {"torch_ell_spdmm", "torch_dense"}
        assert r["agree"] == (min(meas, key=meas.get)
                              == min(meas, key=pred.get))
    ag = report["agreement"]
    assert ag["rate"] == ag["agree"] / ag["considered"]
    assert f"({ag['agree']}/{ag['considered']})" in report["text"]
