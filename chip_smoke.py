"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc``, holds each one against its plain-PyTorch version at every shape the
four full-width tasks give it (b4 ST-GCN, b6-dyn dynamic point cloud, b6
point cloud, b5 SAR), serves 8 requests of each task through its compiled
plan with the CUDA kernels bound, checks the launch counts and the outputs
against the same plan bound to the plain versions (on the card and, for one
request, on the CPU), and times kernels and requests.  Every number printed
is measured in this run.  The last line is the JSON result; any failure
exits nonzero before it.  Imports the port only (``repro_torch``), never
JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# the fp32 rate outside the tensor cores, which is what these fp32 SIMT
# kernels (and their plain versions, with TF32 off) run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# Tolerances.  The kernels accumulate in fp32 in another order than the
# plain versions (cuBLAS / torch reductions): the rounding error of a
# K-term fp32 dot grows like sqrt(K)·2^-24 ≈ 3e-6 at b4's largest
# K = 9·256, so a kernel agrees within 1e-5 of the output's magnitude.
# Through 29 ops of a request those differences compound, and b5's COO sums
# run with atomics (``index_add_``) in an order that changes from run to
# run, hence 1e-4 end to end.  KNN indices must be equal exactly: the
# kernel repeats the plain version's fp32 arithmetic.
KERNEL_RTOL = 1e-5
E2E_RTOL = 1e-4
REQUESTS = 8
# b6-dyn requests: a 960-point cloud padded to a 1024-point bucket, as
# graph-bucketed serving sends it.
PAD_POINTS = 64
# Launches per request of each task's main path (the plan's bindings).
PER_REQUEST = {
    "b4": {"shift_conv2d": 18, "spdmm": 9, "ddmm": 1, "knn": 0},
    "b6-dyn": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 1},
    "b6": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 0},
    "b5": {"shift_conv2d": 2, "spdmm": 0, "ddmm": 3, "knn": 0},
}
SOURCES = {
    "shift_conv2d": ("src/repro_torch/kernels/csrc/shift_conv.cu",
                     "src/repro/kernels/shift_conv.py:78"),
    "spdmm": ("src/repro_torch/kernels/csrc/spdmm.cu",
              "src/repro/kernels/spdmm.py:76"),
    "ddmm": ("src/repro_torch/kernels/csrc/ddmm.cu",
             "src/repro/kernels/ddmm.py:103"),
    "knn": ("src/repro_torch/kernels/csrc/knn.cu",
            "src/repro/kernels/knn.py:128"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """-> (max |got - want|, that over max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Case:
    """One kernel call at one shape: the kernel, its plain version, an
    optional one-call library yardstick, the bytes and operations the call
    needs, how many times one request of the task makes it, and whether
    the result must equal the plain version's exactly (integer indices)."""
    kernel: str
    label: str
    run: Callable
    plain: Callable
    library: Callable | None
    nbytes: float
    flops: float
    per_request: int
    exact: bool = False


def task_cases(task, plan, rng, dev) -> list[Case]:
    """Every distinct kernel call ``plan`` makes, with the plan's own
    weights and random activations, plus how often one request makes it;
    then, per task, shapes beyond the main path."""
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    shapes = dict(plan.meta["input_shapes"])
    cases: dict[tuple, Case] = {}
    for op in plan.ops:
        xin = tuple(shapes[op.inputs[0]])
        shapes[op.name] = op.out_shape
        if op.kernel == "cuda_ddmm" and op.kind == "conv":
            w = op.weights["w"]
            kw = dict(stride=op.attrs["stride"], padding=op.attrs["padding"])
            key = ("conv", xin, w.shape, kw["stride"], kw["padding"])
            if key not in cases:
                cases[key] = conv_case(t(rng.standard_normal(xin)), t(w),
                                       kw, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ell_spdmm":
            c, tt, v = xin                     # right_t: (V, C·T) operand
            key = ("spdmm", (v, c * tt), op.ell[0].shape)
            if key not in cases:
                idx, val = t(op.ell[0], torch.int32), t(op.ell[1])
                y = t(rng.standard_normal((v, c * tt)))
                cases[key] = spdmm_case(idx, val, y, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ddmm" and op.kind == "mm":
            # the runtime calls the kernel as x @ w; bias and activation
            # follow in the shared epilogue
            w = op.weights["w"]
            x = t(rng.standard_normal((int(np.prod(xin[:-1] or (1,))),
                                       xin[-1])))
            key = ("ddmm", tuple(x.shape), w.shape)
            if key not in cases:
                cases[key] = ddmm_case(x, t(w), per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_knn":
            n = xin[0]
            key = ("knn", xin, op.attrs["k"])
            if key not in cases:
                cases[key] = knn_case(
                    t(rng.standard_normal(xin)), op.attrs["k"],
                    mask=t(pad_mask(n)) if op.attrs.get("masked") else None,
                    self_loops=bool(op.attrs.get("self_loops")),
                    per_request=0)
            cases[key].per_request += 1
        elif op.kernel not in ("torch_ew", "coo_scatter"):
            raise AssertionError(f"unexpected kernel {op.kernel} on {task}")
    extra = []
    if task == "b4":
        # beyond the path: ragged tiles with the whole epilogue, and the
        # conv options
        x = t(rng.standard_normal((1000, 700)))
        extra = [ddmm_case(x, t(rng.standard_normal((700, 300))),
                           bias=t(rng.standard_normal(300)),
                           residual=t(rng.standard_normal((1000, 300))),
                           act="gelu", per_request=0),
                 conv_case(t(rng.standard_normal((32, 40, 25))),
                           t(rng.standard_normal((3, 3, 8, 32))),
                           dict(stride=(2, 1), padding="SAME", groups=4,
                                dilation=(2, 1)), per_request=0),
                 conv_case(t(rng.standard_normal((16, 21, 25))),
                           t(rng.standard_normal((3, 2, 8, 16))),
                           dict(stride=(1, 2), padding="VALID", groups=2,
                                dilation=(1, 3)), per_request=0)]
    elif task == "b6-dyn":
        # beyond the path: integer coordinates (exact distance ties), self
        # loops, a ragged N, and b7-dyn's shape (196 patches of 192 features)
        ints = rng.integers(-4, 5, (1024, 3))
        extra = [knn_case(t(ints), 20, mask=None, self_loops=False,
                          per_request=0),
                 knn_case(t(rng.standard_normal((1024, 3))), 20, mask=None,
                          self_loops=True, per_request=0),
                 knn_case(t(rng.standard_normal((1000, 3))), 20,
                          mask=t(pad_mask(1000)), self_loops=False,
                          per_request=0),
                 knn_case(t(rng.standard_normal((196, 192))), 9, mask=None,
                          self_loops=False, per_request=0)]
    return list(cases.values()) + extra


def pad_mask(n: int) -> np.ndarray:
    """Ones with the last ``PAD_POINTS`` set to zero (padded points)."""
    mask = np.ones(n, np.float32)
    mask[-PAD_POINTS:] = 0.0
    return mask


def conv_case(x, w, kw, per_request) -> Case:
    from repro_torch.kernels import ref, shift_conv2d
    k1, k2, cin_g, cout = w.shape
    ho, wo, pt, pb, pl, pr = ref.conv_geometry(
        x.shape[1], x.shape[2], k1, k2, stride=kw["stride"],
        padding=kw["padding"], dilation=kw.get("dilation", (1, 1)))
    # the library yardstick gets the pre-padded input (set-up, untimed):
    # F.conv2d's own padding is symmetric, the reference's SAME split is not
    xp = F.pad(x, (pl, pr, pt, pb))[None]
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    groups = kw.get("groups", 1)
    label = (f"shift_conv2d x{tuple(x.shape)} w{tuple(w.shape)} "
             f"stride={kw['stride']} {kw['padding']}"
             + (f" groups={groups} dilation={kw['dilation']}"
                if "dilation" in kw else ""))
    return Case(
        "shift_conv2d", label,
        lambda: shift_conv2d(x, w, **kw),
        lambda: ref.conv2d_ref(x, w, **kw),
        lambda: F.conv2d(xp, w_oihw, stride=ref.pair(kw["stride"]),
                         dilation=ref.pair(kw.get("dilation", 1)),
                         groups=groups)[0],
        4.0 * (x.numel() + w.numel() + cout * ho * wo),
        2.0 * k1 * k2 * cin_g * cout * ho * wo, per_request)


def spdmm_case(idx, val, y, per_request) -> Case:
    from repro_torch.kernels import ref, spdmm
    s1, ell_l = idx.shape
    dense = torch.zeros((s1, y.shape[0]), device=y.device)
    rows = torch.arange(s1, device=y.device)[:, None].expand(-1, ell_l)
    dense.index_put_((rows, idx.long()), val, accumulate=True)
    csr = dense.to_sparse_csr()
    nnz = int((val != 0).sum().item())
    return Case(
        "spdmm", f"spdmm ell{tuple(idx.shape)} nnz={nnz} y{tuple(y.shape)}",
        lambda: spdmm(idx, val, y),
        lambda: ref.spdmm_ref(idx, val, y),
        lambda: torch.sparse.mm(csr, y),
        4.0 * (2 * idx.numel() + y.numel() + s1 * y.shape[1]),
        2.0 * nnz * y.shape[1], per_request)


def ddmm_case(x, y, *, bias=None, residual=None, act=None,
              per_request=0) -> Case:
    from repro_torch.kernels import ddmm, ref
    m, k = x.shape
    n = y.shape[1]
    library = None
    if act is None and residual is None:
        library = ((lambda: torch.mm(x, y)) if bias is None  # noqa: E731
                   else (lambda: torch.addmm(bias, x, y)))
    nbytes = 4.0 * (x.numel() + y.numel() + m * n
                    + (n if bias is not None else 0)
                    + (m * n if residual is not None else 0))
    label = (f"ddmm ({m},{k})@({k},{n}) bias={bias is not None} "
             f"act={act} residual={residual is not None}")
    return Case(
        "ddmm", label,
        lambda: ddmm(x, y, bias=bias, residual=residual, act=act),
        lambda: ref.ddmm_ref(x, y, bias=bias, residual=residual, act=act),
        library, nbytes, 2.0 * m * k * n, per_request)


def knn_case(x, k, *, mask, self_loops, per_request) -> Case:
    from repro_torch.kernels import knn, ref
    n, f = x.shape
    kw = dict(mask=mask, self_loops=self_loops)
    label = (f"knn x{tuple(x.shape)} k={k} masked={mask is not None} "
             f"self_loops={self_loops}")
    # bytes: points, mask, indices; operations: the 2·N²·F of the dot
    # products plus 3·N² to form each distance and compare it
    return Case(
        "knn", label, lambda: knn(x, k, **kw),
        lambda: ref.knn_ref(x, k, **kw), None,
        4.0 * (n * f + (n if mask is not None else 0) + n * k),
        2.0 * n * n * f + 3.0 * n * n, per_request, exact=True)


def check_case(case: Case) -> float:
    """Run the kernel and its plain version once; raise on disagreement.
    Returns max |kernel - plain|."""
    got, want = case.run(), case.plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape, (case.label, got.shape, want.shape)
    if case.exact:
        bad = (got != want).any(1).nonzero().flatten().tolist()
        log(f"check {case.label}: {len(bad)} rows differ"
            + ("" if not bad else "  FAIL"))
        for row in bad[:8]:
            log(f"  row {row}: kernel {got[row].tolist()}")
            log(f"  row {row}: plain  {want[row].tolist()}")
        assert not bad, f"{case.label}: kernel indices differ"
        return 0.0
    assert torch.isfinite(got).all(), case.label
    err, rel = rel_err(got, want)
    ok = rel <= KERNEL_RTOL
    msg = f"check {case.label}: max|d|={err:.3e} rel={rel:.3e}"
    if case.library is not None:
        _, lrel = rel_err(case.library(), want)
        msg += f" (library rel={lrel:.3e})"
    log(msg + ("" if ok else "  FAIL"))
    assert ok, f"{case.label}: kernel disagrees with its plain version"
    return err


def profile_requests(run, requests, card, task) -> None:
    """Device time by kernel name over the requests (``torch.profiler``),
    and the share of the profiled window in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for req in requests:
            run(**req)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("profile: no device events recorded (device breakdown not "
            "measured)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    n = len(requests)
    log(f"profile over {n} {task} requests (under the profiler): "
        f"{len(kernels) / n:.1f} device kernels/request, device busy "
        f"{busy / n / 1e3:.4f} ms/request, idle share of the device window "
        f"{1 - busy / window:.3f}  [{card}]")
    by_name: dict[str, list] = {}
    for e in kernels:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / n / 1e3:.4f} ms/request  {count // n:3d}x  "
            f"{name[:90]}")


def task_plans(task):
    """-> (plan with the CUDA kernels bound, the same plan bound to the
    plain versions)."""
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task
    build = build_dynamic_task if task == "b6-dyn" else build_task
    return tuple(compile_graph(build(task), CompileOptions(kernels=mode))
                 for mode in ("cuda", "torch"))


def task_requests(task, plan) -> list[dict]:
    """``REQUESTS`` requests from seeds 0..REQUESTS-1.  b6-dyn: standard
    normal points and the padding mask; the others: the plan's random
    inputs."""
    from repro_torch.core.executor import random_inputs
    if task != "b6-dyn":
        return [random_inputs(plan, seed=s) for s in range(REQUESTS)]
    n, f = plan.meta["input_shapes"]["points"]
    return [dict(points=np.random.default_rng(s).standard_normal(
        (n, f)).astype(np.float32), mask=pad_mask(n))
        for s in range(REQUESTS)]


def serve(task, plan, plan_torch, requests, kernels) -> dict[str, int]:
    """Drive one task's main path: every launch count set to 0 just
    before, read just after.  Checks counts and outputs; returns the
    counts."""
    from repro_torch.core import build_runner
    binding = [(op.kind, op.kernel) for op in plan.ops]
    per_req = {"shift_conv2d": binding.count(("conv", "cuda_ddmm")),
               "spdmm": binding.count(("mm", "cuda_ell_spdmm")),
               "ddmm": binding.count(("mm", "cuda_ddmm")),
               "knn": binding.count(("knn_graph", "cuda_knn"))}
    assert per_req == PER_REQUEST[task], (task, per_req)
    run_cuda = build_runner(plan)
    run_torch = build_runner(plan_torch)
    for fn in kernels.values():
        fn.launches = 0
    outs = []
    for s, req in enumerate(requests):
        before = {name: fn.launches for name, fn in kernels.items()}
        outs.append(run_cuda(**req)[0])
        step = {name: fn.launches - before[name]
                for name, fn in kernels.items()}
        assert step == per_req, (task, s, step)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"{task}: launches over {len(requests)} requests: {launches}")
    for name, n in launches.items():
        assert n == per_req[name] * len(requests), (task, name, n)
    n_out = plan.ops[-1].out_shape
    for s, (req, out) in enumerate(zip(requests, outs)):
        assert tuple(out.shape) == tuple(n_out), (task, out.shape)
        assert torch.isfinite(out).all(), f"{task} request {s}: non-finite"
        err, rel = rel_err(out, run_torch(**req)[0])
        log(f"{task} request {s}: cuda vs torch plan max|d|={err:.3e} "
            f"rel={rel:.3e}")
        assert rel <= E2E_RTOL, f"{task} request {s}: disagrees with the " \
            "torch plan"
    cpu_out = build_runner(plan_torch, device="cpu")(**requests[0])[0]
    err, rel = rel_err(outs[0].cpu(), cpu_out)
    log(f"{task} request 0: cuda vs CPU plain versions max|d|={err:.3e} "
        f"rel={rel:.3e}")
    assert rel <= E2E_RTOL, f"{task} request 0 disagrees with the CPU run"
    return launches


def request_times(task, plan, plan_torch, requests, card) -> None:
    """Request latency of both plans, in turns, on the host clock."""
    from repro_torch.core import build_runner
    run_cuda, run_torch = build_runner(plan), build_runner(plan_torch)

    def request_ms(run):
        t_req = []
        for req in requests:
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            run(**req)
            torch.cuda.synchronize()
            t_req.append((time.perf_counter() - t_a) * 1e3)
        return t_req

    request_ms(run_cuda)
    request_ms(run_torch)                              # warm both
    t_cuda, t_torch = [], []
    for turn in range(5):                              # cuda/torch in turns
        order = (run_cuda, run_torch) if turn % 2 == 0 else \
            (run_torch, run_cuda)
        for run in order:
            (t_cuda if run is run_cuda else t_torch).extend(request_ms(run))
    for name, samples in (("cuda", t_cuda), ("torch", t_torch)):
        q1, med, q3 = statistics.quantiles(samples, n=4)
        log(f"{task} request, {name} plan (host clock, synchronized, "
            f"{len(samples)} requests): p50 {med:.4f} ms, p25 {q1:.4f} ms, "
            f"p75 {q3:.4f} ms  [{card}]")
    profile_requests(run_cuda, requests, card, task)


def kernel_rows(task, cases, launches, max_err, card) -> list[dict]:
    """Time every case; one JSON row per kernel the task's path runs."""
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, nbytes=0.0, flops=0.0,
                         library=True) for name in SOURCES}
    for case in cases:
        ms = time_ms(case.run)
        plain = time_ms(case.plain)
        lib = time_ms(case.library) if case.library is not None else None
        bnd, by = bound_ms(case.nbytes, case.flops)
        log(f"time {task} {case.label}: kernel {ms:.5f} ms, plain "
            f"{plain:.5f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{bnd:.5f} ms ({by}), x{case.per_request}/request  [{card}]")
        if case.per_request:
            tot = totals[case.kernel]
            tot["ms"] += case.per_request * ms
            tot["plain_ms"] += case.per_request * plain
            tot["bound_ms"] += case.per_request * bnd
            tot["nbytes"] += case.per_request * case.nbytes
            tot["flops"] += case.per_request * case.flops
            if lib is None:
                tot["library"] = False
            else:
                tot["library_ms"] += case.per_request * lib
    rows = []
    for name, tot in totals.items():
        if not PER_REQUEST[task][name]:
            continue
        _, by = bound_ms(tot["nbytes"], tot["flops"])
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "launches_per_request": PER_REQUEST[task][name],
            "max_abs_err": max_err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"] if tot["library"] else None,
            "unit": f"ms per {task} request: sum over its launches",
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ddmm, knn, shift_conv2d, spdmm
    from repro_torch.kernels.knn import MAX_K
    kernels = {"shift_conv2d": shift_conv2d, "spdmm": spdmm, "ddmm": ddmm,
               "knn": knn}

    # ---- phase 1: card, numerics, build ---------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.relative_to(ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    assert lib.repro_knn_max_k() == MAX_K, "csrc/knn.cu and knn.py disagree"

    tasks = list(PER_REQUEST)
    plans = {task: task_plans(task) for task in tasks}

    # ---- phase 2: every kernel against its plain version ----------------
    rng = np.random.default_rng(0)
    cases = {task: task_cases(task, plans[task][0], rng, dev)
             for task in tasks}
    max_err = {task: {name: 0.0 for name in kernels} for task in tasks}
    for task in tasks:
        for case in cases[task]:
            max_err[task][case.kernel] = max(max_err[task][case.kernel],
                                             check_case(case))

    # ---- phase 3: serve each task's requests through the CUDA kernels ---
    requests = {task: task_requests(task, plans[task][0]) for task in tasks}
    launches = {task: serve(task, *plans[task], requests[task], kernels)
                for task in tasks}

    # ---- phase 4: timing -----------------------------------------------
    rows = []
    for task in tasks:
        request_times(task, *plans[task], requests[task], card)
    for task in tasks:
        rows += kernel_rows(task, cases[task], launches[task],
                            max_err[task], card)
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
