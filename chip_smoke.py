"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --conv-sweep    # shift-conv's tiles and splits
    python3 chip_smoke.py --ddmm-sweep    # DDMM's column tiles and splits

Builds the port's hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc``, holds each one against its plain-PyTorch version at every shape the
full-width paths give it (b4 ST-GCN, b6-dyn dynamic point cloud, b6 point
cloud, b5 SAR, b1 few-shot, b2 ML-GCN, b3 DualGCN on ResNet-50 and -101,
and the masked VIP at b3's spatial width) and the LM path (qwen3-0.6b's
served prefills, a 2048-token prefill, and flash attention's edge cases in
fp32 and bf16), serves 8 requests of each GNN-CV path through its compiled
plan with the CUDA kernels bound, checks the launch counts and the outputs
against the same plan bound to the plain versions (on the card and, for
one request, on the CPU), serves 16 requests of qwen3-0.6b at full width
through ``repro_torch.launch.serve`` and checks its tokens against the
plain attention path, and times kernels, requests and tokens.  DDMM is
held to its batch rule (a product stacked along M equals its per-sample
products bit for bit; a second call with split-K the first), and relu
must keep a NaN row NaN.  SpDMM runs through the entry the path calls
(``spdmm_rows`` on b4's ``(C·T, V)`` view), timed beside the route it
replaced (the column kernel between two transposing copies).  KNN is also
held to the orders and ties that stress its warp list
(``knn_adversarial``), SDDMM to split-K at K = 4096 and to exact zeros in
dead tiles over NaN and inf inputs; both print their share of the bound.  Every
number printed is measured in this run.  The last line is the JSON result;
any failure exits nonzero before it.  Imports the port only
(``repro_torch``), never JAX.

``--conv-sweep`` instead times the shift-conv kernel at every pixel tile
and split-K factor it takes, at every distinct conv shape of b4, b5, b1,
b2 and b3, checks each against the plain version, and prints the plan's
choice (``shift_conv.launch_plan``) beside the best: the data behind the
plan's rule.  ``--ddmm-sweep`` does the same for DDMM's tensor-core route
(column tile and split-K at every tensor-core call of the paths, beside
``ddmm.launch_plan``'s choice).
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import warnings
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM rate and
# the fp32 rate outside the tensor cores, which is what the fp32 SIMT
# kernels (and their plain versions, with TF32 off) run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# the bf16 tensor-core peak: the least time for bf16 attention's products
BF16_FLOPS = 989e12
# Shift-conv runs fp32-accurate products on the TF32 tensor cores as three
# TF32 products each (3xTF32): its least time is 3·ops / 495 TFLOP/s.
TF32_FLOPS = 495e12
CONV_FLOPS = TF32_FLOPS / 3

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
# Flash attention in bf16: kernel and plain version both compute from the
# same bf16 inputs with fp32 sums (the kernel's p in three bf16 parts,
# fp32-level) and round the result once to bf16, so an element may differ
# by one bf16 ulp (2^-8 of itself) where the two sums straddle a rounding
# boundary: within 2^-7 of max|plain|.  Shift-conv's 3xTF32 products are
# fp32-level (~2^-21 of each product): KERNEL_RTOL holds for it.
FLASH_BF16_RTOL = 2.0 ** -7
REQUESTS = 8
# b6-dyn requests: a 960-point cloud padded to a 1024-point bucket, as
# graph-bucketed serving sends it.
PAD_POINTS = 64
# The masked VIP path: b3-r50's spatial branch (14x14 patches of 512
# channels), each patch sampling its 5x5 window (nnz 4096, density 0.107).
VIP_SIDE, VIP_FEAT, VIP_WIN = 14, 512, 5
# b3's random-weight ResNet has zero biases and identity BN statistics, so
# its features grow through depth (to ~1e4 at a standard-normal 224x224
# image for ResNet-50) and its VIP affinities reach 1e10 and more: the
# softmax over them is a hard argmax, and any two fp32 orders of summation
# flip its near-ties.  The backbone is positively homogeneous (conv, ReLU,
# max pool, residual add), so scaling the image by s scales the affinities
# by s²: b3's requests are scaled by the power of two that brings their
# largest affinity to at most AFFINITY_PEAK, where the softmax is smooth
# and the comparison with the plain versions means something.
# The work, and so every time, does not depend on the data.  The masked
# VIP's standard-normal 512-feature nodes have self-affinities near 512
# against neighbours' ±23, so its softmax would collapse to the diagonal
# and the path would return its input: its requests are scaled the same
# way.
SCALED_TASKS = ("b3-r50", "b3-r101", "vip-masked")
AFFINITY_PEAK = 4.0
# Launches per request of each task's main path (the plan's bindings).  An
# unmasked VIP runs the DDMM kernel on x @ xᵀ, as the reference does.
PER_REQUEST = {
    "b4": {"shift_conv2d": 18, "spdmm": 9, "ddmm": 1, "knn": 0, "sddmm": 0},
    "b6-dyn": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 1,
               "sddmm": 0},
    "b6": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 6, "knn": 0, "sddmm": 0},
    "b5": {"shift_conv2d": 2, "spdmm": 0, "ddmm": 3, "knn": 0, "sddmm": 0},
    # 4 convs on the (26, c, H, W) stack; 5 linears, 3 runtime-adjacency
    # MPs and 3 unmasked VIPs
    "b1": {"shift_conv2d": 4, "spdmm": 0, "ddmm": 11, "knn": 0, "sddmm": 0},
    "b2": {"shift_conv2d": 53, "spdmm": 0, "ddmm": 5, "knn": 0, "sddmm": 0},
    "b3-r50": {"shift_conv2d": 55, "spdmm": 0, "ddmm": 6, "knn": 0,
               "sddmm": 0},
    "b3-r101": {"shift_conv2d": 106, "spdmm": 0, "ddmm": 6, "knn": 0,
                "sddmm": 0},
    "vip-masked": {"shift_conv2d": 0, "spdmm": 0, "ddmm": 1, "knn": 0,
                   "sddmm": 1},
}
# The LM path: qwen3-0.6b at full width (28 layers, 16 query and 8 kv heads
# of 128), random weights from seed 0, the launcher's defaults: 16 requests
# with prompt lengths in [8, 48) from seed 0 (buckets of 16, 32 and 48),
# 32 new tokens each, 8 slots, 256 positions, greedy.  One prefill per
# request launches the flash kernel once per layer.  Then one prefill of a
# 2048-token prompt.
LM_ARCH = "qwen3-0.6b"
LM_REQUESTS, LM_MAX_NEW, LM_SLOTS, LM_MAX_LEN = 16, 32, 8, 256
LM_PROMPT_LEN = (8, 48)
LONG_PROMPT = 2048
# bf16 end to end: the kernel path and the plain path (``impl="naive"``)
# differ by one bf16 rounding of some attention outputs per layer, carried
# through 28 layers of bf16 arithmetic.  Prefill logits of the two paths
# must agree within PREFILL_RTOL of max|logits|.  Greedy tokens may then
# part where two logits lie closer than that, so each token the engine
# emits must hold a plain-path logit (teacher-forced over the prompt and
# the engine's own tokens) within MARGIN_RTOL of max|logits| of that
# position's maximum: twice the prefill bound, one for each path's error.
PREFILL_RTOL = 2e-2
MARGIN_RTOL = 4e-2
# The same weights cast to fp32: the two paths then differ only by the
# order of fp32 sums, so their prefill logits must agree within E2E_RTOL.
# The name prefix of each kernel's device kernels in a profile (shift-conv's
# split-K reduction is ``shift_conv_splitk_reduce``; flash has a bf16 and
# an fp32 kernel).
DEVICE_PREFIX = {"shift_conv2d": "shift_conv", "spdmm": "ell_spdmm",
                 "ddmm": "ddmm", "knn": "knn", "sddmm": "sddmm",
                 "flash_attention": "flash"}
# the kernels whose rows print their achieved share of the bound (the two
# redesigned last, from under 1% of it)
BOUND_SHARE = ("knn", "sddmm")
SOURCES = {
    "shift_conv2d": ("src/repro_torch/kernels/csrc/shift_conv.cu",
                     "src/repro/kernels/shift_conv.py:78"),
    "spdmm": ("src/repro_torch/kernels/csrc/spdmm.cu",
              "src/repro/kernels/spdmm.py:76"),
    "ddmm": ("src/repro_torch/kernels/csrc/ddmm.cu",
             "src/repro/kernels/ddmm.py:103"),
    "knn": ("src/repro_torch/kernels/csrc/knn.cu",
            "src/repro/kernels/knn.py:128"),
    "sddmm": ("src/repro_torch/kernels/csrc/sddmm.cu",
              "src/repro/kernels/sddmm.py:81"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:108"),
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


def bound_ms(nbytes: float, flops: float,
             rate: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Case:
    """One kernel call at one shape: the kernel, its plain version, an
    optional one-call library yardstick, the bytes and operations the call
    needs and the peak rate of those operations, how many times one
    request of the path makes it (on average), whether the result must
    equal the plain version's exactly (integer indices), and the
    tolerance otherwise."""
    kernel: str
    label: str
    run: Callable
    plain: Callable
    library: Callable | None
    nbytes: float
    flops: float
    per_request: float
    exact: bool = False
    rtol: float = KERNEL_RTOL
    rate: float = FP32_FLOPS
    plan: object = None          # shift-conv's or DDMM's launch plan
    # the route the runtime took before this kernel's redesign, timed
    # beside it (SpDMM: the column kernel between two transposing copies)
    before: Callable | None = None
    # DDMM: ``torch.mm`` of the product alone, the yardstick where no one
    # PyTorch call computes the product with its epilogue
    mm: Callable | None = None
    # DDMM: the call's (x, y, bias, residual, act), for ``--ddmm-sweep``
    args: tuple = ()


def mm_operands(op, xin, shapes, rng):
    """The ``(x, y)`` a ``cuda_ddmm`` mm op hands the DDMM kernel, by its
    side: compile-time operands from the plan, runtime ones random."""
    side = op.attrs["weight_side"]

    def rand(*shape):
        return rng.standard_normal(shape)

    def rows(shape):                               # (..., F) -> (M, F)
        return int(np.prod(shape[:-1] or (1,))), shape[-1]

    if side == "right":
        return rand(*rows(xin)), op.weights["w"]
    if side == "left":
        return op.weights["adj"], rand(*xin)
    if side == "left_runtime":
        return rand(*shapes[op.inputs[1]]), rand(*xin)
    if side == "both_runtime":
        y = shapes[op.inputs[1]]
        return rand(*rows(xin)), rand(y[0], int(np.prod(y[1:])))
    raise AssertionError(f"{op.name}: no DDMM case for side {side!r}")


def task_cases(task, plan, rng, dev) -> list[Case]:
    """Every distinct kernel call ``plan`` makes, with the plan's own
    weights and random activations, plus how often one request makes it;
    then, per task, shapes beyond the main path."""
    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def ddmm_at(x, y, gram=False, epi=None):
        epi = epi or {}
        key = ("ddmm", tuple(x.shape), tuple(y.shape), gram,
               tuple(sorted((k, v is not None if k != "act" else v)
                            for k, v in epi.items())))
        if key not in cases:
            cases[key] = ddmm_case(x, y, gram=gram, per_request=0, **epi)
        cases[key].per_request += 1

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
            c, tt, v = xin                     # right_t: the (C·T, V) view
            key = ("spdmm", (c * tt, v), op.ell[0].shape)
            if key not in cases:
                idx, val = t(op.ell[0], torch.int32), t(op.ell[1])
                x2 = t(rng.standard_normal((c * tt, v)))
                cases[key] = spdmm_case(idx, val, x2, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ddmm" and op.kind == "mm":
            # the runtime hands the kernel the op's epilogue where it can
            x, y = map(t, mm_operands(op, xin, shapes, rng))
            ddmm_at(x, y, epi=handed_epilogue(op, x.shape[0], y.shape[1],
                                              rng, dev))
        elif op.kernel == "cuda_sddmm" and "mask" not in op.weights:
            x = t(rng.standard_normal(xin))            # VIP: x @ xᵀ, a view
            ddmm_at(x, x.T, gram=True)
        elif op.kernel == "cuda_sddmm":
            x = t(rng.standard_normal(xin))
            key = ("sddmm", xin, op.attrs["nnz"])
            if key not in cases:
                cases[key] = sddmm_case(x, x.T, t(op.weights["mask"]),
                                        per_request=0)
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
        # conv options; SpDMM's column entry (the JAX signature) at b4's
        # widest shape
        x = t(rng.standard_normal((1000, 700)))
        idx, val = (t(a, dt) for a, dt in zip(
            next(op.ell for op in plan.ops if op.ell is not None),
            (torch.int32, torch.float32)))
        extra = [ddmm_case(x, t(rng.standard_normal((700, 300))),
                           bias=t(rng.standard_normal(300)),
                           residual=t(rng.standard_normal((1000, 300))),
                           act="gelu", per_request=0),
                 spdmm_columns_case(idx, val, t(rng.standard_normal(
                     (25, 19200)))),
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
        # loops, a ragged N, b7-dyn's shape (196 patches of 192 features)
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
        # the warp list's worst orders and ties, and k at both ends (their
        # own generator: the other paths' inputs stay as they were)
        from repro_torch.kernels.knn import MAX_K
        own = np.random.default_rng(17)
        for name, k in (("rising", 20), ("falling", 20), ("equal", 20),
                        ("masked", 20), ("normal", 1), ("rising", MAX_K)):
            x, mask = knn_adversarial(name, 1024, 3, own)
            extra.append(knn_case(t(x), k, mask=None if mask is None
                                  else t(mask), self_loops=False,
                                  per_request=0, note=name))
    elif task == "b1":
        # beyond the path: every other act, ragged M, N and K on both y
        # layouts, and each route at K not a multiple of 4
        for act, (m, k, n) in zip(("gelu", "silu", "tanh", None),
                                  ((26, 800, 400), (33, 257, 129),
                                   (5, 403, 7), (100, 70, 130))):
            x = t(rng.standard_normal((m, k)))
            for y in (t(rng.standard_normal((k, n))),
                      t(rng.standard_normal((n, k))).T):
                extra.append(ddmm_case(
                    x, y, bias=t(rng.standard_normal(n)),
                    residual=t(rng.standard_normal((m, n))), act=act))
    elif task == "vip-masked":
        # beyond the path: the reference's three shapes, ragged M, N and K,
        # a mask of density 1 and one of density 0, y stored k-major
        for m, k, n, density in ((128, 64, 128, 0.2), (256, 128, 256, 0.05),
                                 (100, 50, 70, 0.4), (33, 17, 65, 0.3),
                                 (37, 1, 31, 1.0), (64, 40, 96, 0.0)):
            y = t(rng.standard_normal((k, n)))
            extra.append(sddmm_case(
                t(rng.standard_normal((m, k))), y,
                t(rng.random((m, n)) < density), per_request=0))
        x = t(rng.standard_normal((100, 50)))
        extra.append(sddmm_case(x, x.T, t(rng.random((100, 100)) < 0.4),
                                per_request=0))
        # split-K at its deepest: K = 4096 in 8 chunks, ragged M and N, y
        # row-major and a transposed view (their own generator)
        own = np.random.default_rng(17)
        for m, n, density, view in ((100, 70, 0.3, False),
                                    (33, 65, 0.05, True)):
            y = t(own.standard_normal((n, 4096) if view else (4096, n)))
            extra.append(sddmm_case(
                t(own.standard_normal((m, 4096))), y.T if view else y,
                t(own.random((m, n)) < density), per_request=0))
    return list(cases.values()) + extra


def handed_epilogue(op, m, n, rng, dev) -> dict:
    """The epilogue the runtime hands the DDMM kernel with ``op``'s
    ``(m, k) @ (k, n)`` product (``matmul.kernel_epilogue``: bias, relu,
    a pre-activation residual, random where it is a runtime value), on
    ``dev``; empty where ``apply_epilogue`` runs it after the kernel."""
    from repro_torch.core.runtime.matmul import kernel_epilogue
    shape = tuple(op.out_shape) if op.out_shape else (m * n,)
    env = {}
    if op.attrs.get("fused_residual"):
        env[op.attrs["fused_residual"]] = torch.tensor(
            rng.standard_normal(shape), dtype=torch.float32)
    epi = kernel_epilogue(op, env, None, m, n, shape)
    if epi is None:
        return {}
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in epi.items()}


def ddmm_exact_checks(task, rng, dev) -> None:
    """DDMM's batch-stable plan and in-order split-K, bit for bit: a
    stacked-M product equals its per-sample products (b1's linear on the
    tensor cores and its classifier on the narrow route, stacked 4x; b6's
    classifier at M = 1 against M = 4), two calls with split-K active give
    the same bits (b2), and relu keeps a NaN row NaN (b6)."""
    from repro_torch.kernels import ddmm, ref
    from repro_torch.kernels.ddmm import launch_plan

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)

    stacked = {"b1": ((26, 800, 400, "relu"), (26, 400, 5, None)),
               "b6": ((1, 1024, 40, None),)}
    for m, k, n, act in stacked.get(task, ()):
        x, y, b = t(4 * m, k), t(k, n), t(n)
        got = ddmm(x, y, bias=b, act=act)
        each = torch.cat([ddmm(x[i * m:(i + 1) * m], y, bias=b, act=act)
                          for i in range(4)])
        torch.cuda.synchronize()
        differ = int((got != each).sum().item())
        one, four = launch_plan(m, k, n), launch_plan(4 * m, k, n)
        log(f"check ddmm stacked ({4 * m},{k})@({k},{n}) act={act} (route "
            f"{one.route}, tiles {four.bm}x{four.bn} vs {one.bm}x{one.bn}, "
            f"split {four.split} of {four.k_tiles} K stages): vs 4 "
            f"per-sample products, {differ} elements differ"
            + ("" if not differ else "  FAIL"))
        assert not differ, "ddmm: stacked M differs from per-sample calls"
    if task == "b2":
        x, y, b = t(80, 1024), t(1024, 2048), t(2048)
        plan = launch_plan(80, 1024, 2048)
        got, again = ddmm(x, y, bias=b), ddmm(x, y, bias=b)
        torch.cuda.synchronize()
        differ = int((got != again).sum().item())
        log(f"check ddmm (80,1024)@(1024,2048) split {plan.split} of "
            f"{plan.k_tiles} K stages: a second call, {differ} elements "
            f"differ" + ("" if not differ else "  FAIL"))
        assert plan.split > 1 and not differ, "ddmm: two calls differ"
    if task == "b6":
        x, y, b = t(64, 256), t(256, 1024), t(1024)
        x[3] = float("nan")
        got = ddmm(x, y, bias=b, act="relu")
        torch.cuda.synchronize()
        want = ref.ddmm_ref(x, y, bias=b, act="relu")
        nan_row = bool(torch.isnan(got[3]).all().item())
        rest = torch.cat([got[:3], got[4:]])
        _, rel = rel_err(rest, torch.cat([want[:3], want[4:]]))
        ok = nan_row and bool(torch.isfinite(rest).all().item()) \
            and rel <= KERNEL_RTOL
        log(f"check ddmm relu with a NaN row of x: the row NaN "
            f"{nan_row}, the other rows finite, rel={rel:.3e}"
            + ("" if ok else "  FAIL"))
        assert ok, "ddmm: relu does not keep NaN"


def exact_checks(task, rng, dev) -> None:
    """Kernel results beyond the main path that must hold exactly: a
    batched conv equals its per-image calls (same arithmetic order; b1's
    and b2's shapes, split-K active) and a second call of itself (no
    atomics); SDDMM's dead tiles come out as exact zeros over NaN and inf
    inputs, and its split-K result is the same on a second call and with y
    as a transposed view (vip-masked);
    DDMM's (``ddmm_exact_checks``)."""
    from repro_torch.kernels import sddmm, shift_conv2d
    from repro_torch.kernels.sddmm import live_tiles
    from repro_torch.kernels.shift_conv import launch_plan
    ddmm_exact_checks(task, rng, dev)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    conv_shapes = {
        "b1": (((26, 1, 28, 28), (3, 3, 1, 64), dict(stride=1)),
               ((26, 64, 14, 14), (3, 3, 64, 64), dict(stride=1)),
               ((5, 8, 15, 25), (3, 2, 2, 8),
                dict(stride=(2, 1), padding="VALID", groups=4,
                     dilation=(1, 2)))),
        # b2's 7x7 and 14x14 layers, batched
        "b2": (((4, 512, 7, 7), (3, 3, 512, 512), dict(stride=1)),
               ((4, 1024, 14, 14), (1, 1, 1024, 256), dict(stride=1)),
               ((3, 256, 28, 28), (3, 3, 256, 256), dict(stride=2)))}
    for xs, ws, kw in conv_shapes.get(task, ()):
        x, w = t(rng.standard_normal(xs)), t(rng.standard_normal(ws))
        got = shift_conv2d(x, w, **kw)
        again = shift_conv2d(x, w, **kw)
        each = torch.stack([shift_conv2d(xi, w, **kw) for xi in x])
        torch.cuda.synchronize()
        differ = int((got != each).sum().item())
        rerun = int((got != again).sum().item())
        plan = launch_plan(xs, ws, **kw)
        log(f"check batched shift_conv2d x{xs} w{ws} {kw} (split "
            f"{plan.split} of {plan.k_tiles} K tiles): one launch vs "
            f"{xs[0]} per-image launches, {differ} elements differ; a "
            f"second call, {rerun} differ"
            + ("" if not (differ or rerun) else "  FAIL"))
        assert not differ, "batched conv differs from per-image calls"
        assert not rerun, "two calls of the conv differ"
    if task == "vip-masked":
        # NaN in x's rows and inf in y's columns that only dead tiles read
        x, y = t(rng.standard_normal((256, 64))), t(rng.standard_normal(
            (64, 256)))
        x[160:200] = float("nan")
        y[:, 130:250] = float("inf")
        mask = torch.zeros((256, 256), device=dev)
        mask[:128, :128] = 1.0
        got = sddmm(x, y, mask)
        torch.cuda.synchronize()
        dead = torch.cat([got[128:].flatten(), got[:128, 128:].flatten()])
        nonzero = int((dead != 0).sum().item())
        log(f"check sddmm dead tiles: mask live on [:128, :128] of 256x256, "
            f"{int(live_tiles(mask).sum())}/{live_tiles(mask).numel()} tiles "
            f"live, NaN and inf only in dead bands, {nonzero} nonzero "
            f"outputs outside" + ("" if not nonzero else "  FAIL"))
        assert not nonzero, "sddmm: a dead tile is not exactly zero"
        # split-K in order: a second call and a transposed y, bit for bit
        from repro_torch.kernels.sddmm import launch_plan as sddmm_plan
        own = np.random.default_rng(18)
        x = t(own.standard_normal((100, 4096)))
        y = t(own.standard_normal((4096, 70)))
        mask = t(own.random((100, 70)) < 0.3)
        got, again = sddmm(x, y, mask), sddmm(x, y, mask)
        view = sddmm(x, y.T.contiguous().T, mask)
        torch.cuda.synchronize()
        rerun = int((got != again).sum().item())
        differ = int((got != view).sum().item())
        plan = sddmm_plan(100, 4096, 70)
        log(f"check sddmm (100,4096)@(4096,70) split {plan.split} of "
            f"{plan.k_tiles} K stages: a second call, {rerun} elements "
            f"differ; y as a transposed view, {differ} differ"
            + ("" if not (rerun or differ) else "  FAIL"))
        assert plan.split > 1 and not (rerun or differ), \
            "sddmm: two calls or two layouts of y differ"


def knn_adversarial(name: str, n: int, f: int,
                    rng) -> tuple[np.ndarray, np.ndarray | None]:
    """``(x, mask)`` for the KNN cases that stress the kernel's warp list:
    ``rising`` / ``falling`` collinear points (every candidate of the last
    or first rows beats all before it: the threshold filter's worst case,
    with a tie toward each side), ``equal`` points (every distance ties:
    pure index order), ``masked`` (all but 5 candidates masked: trailing
    +inf in index order); standard-normal points otherwise."""
    mask = None
    if name in ("rising", "falling"):
        line = np.arange(n, dtype=np.float32) * 0.5
        x = np.stack([line if name == "rising" else line[::-1]]
                     + [np.zeros(n, np.float32)] * (f - 1), 1)
    elif name == "equal":
        x = np.full((n, f), 0.25, np.float32)
    else:
        x = rng.standard_normal((n, f)).astype(np.float32)
    if name == "masked":
        mask = np.zeros(n, np.float32)
        mask[rng.choice(n, 5, replace=False)] = 1.0
    return x, mask


def pad_mask(n: int) -> np.ndarray:
    """Ones with the last ``PAD_POINTS`` set to zero (padded points)."""
    mask = np.ones(n, np.float32)
    mask[-PAD_POINTS:] = 0.0
    return mask


def conv_case(x, w, kw, per_request) -> Case:
    from repro_torch.kernels import ref, shift_conv2d
    from repro_torch.kernels.shift_conv import launch_plan
    k1, k2, cin_g, cout = w.shape
    ho, wo, pt, pb, pl, pr = ref.conv_geometry(
        x.shape[-2], x.shape[-1], k1, k2, stride=kw["stride"],
        padding=kw["padding"], dilation=kw.get("dilation", (1, 1)))
    batch = x.shape[0] if x.ndim == 4 else 1
    # the library yardstick gets the pre-padded input (set-up, untimed):
    # F.conv2d's own padding is symmetric, the reference's SAME split is not
    xp = F.pad(x, (pl, pr, pt, pb))
    xp = xp.reshape(batch, *xp.shape[-3:])
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
                         groups=groups).reshape(*x.shape[:-3], cout, ho, wo),
        4.0 * (x.numel() + w.numel() + batch * cout * ho * wo),
        2.0 * batch * k1 * k2 * cin_g * cout * ho * wo, per_request,
        rate=CONV_FLOPS, plan=launch_plan(tuple(x.shape), tuple(w.shape),
                                          **kw))


def ell_csr(idx, val, s2):
    """The ELL matrix as CSR (set-up, untimed), and its nonzeros."""
    s1, ell_l = idx.shape
    dense = torch.zeros((s1, s2), device=val.device)
    rows = torch.arange(s1, device=val.device)[:, None].expand(-1, ell_l)
    dense.index_put_((rows, idx.long()), val, accumulate=True)
    with warnings.catch_warnings():                # "CSR support is beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = dense.to_sparse_csr()
    return csr, int((val != 0).sum().item())


def spdmm_case(idx, val, x2, per_request) -> Case:
    """SpDMM as b4's ``right_t`` side calls it: ``spdmm_rows`` on the
    ``(C·T, V)`` view.  Library: ``torch.sparse.mm`` of the CSR matrix
    and ``x2ᵀ`` (it returns ``outᵀ``; the ``.T`` is a view).  Before: the
    route the runtime took before ``spdmm_rows``, the column kernel
    between two transposing copies."""
    from repro_torch.kernels import ref, spdmm, spdmm_rows
    r, s2 = x2.shape
    csr, nnz = ell_csr(idx, val, s2)
    return Case(
        "spdmm", f"spdmm_rows ell{tuple(idx.shape)} nnz={nnz} "
                 f"x2{tuple(x2.shape)}",
        lambda: spdmm_rows(idx, val, x2),
        lambda: ref.spdmm_rows_ref(idx, val, x2),
        lambda: torch.sparse.mm(csr, x2.T).T,
        4.0 * (2 * idx.numel() + x2.numel() + r * idx.shape[0]),
        2.0 * nnz * r, per_request,
        before=lambda: spdmm(idx, val, x2.T.contiguous()).T.contiguous())


def spdmm_columns_case(idx, val, y) -> Case:
    """SpDMM's column entry, the JAX signature ``(S1, L) @ (S2, N)``."""
    from repro_torch.kernels import ref, spdmm
    csr, nnz = ell_csr(idx, val, y.shape[0])
    return Case(
        "spdmm", f"spdmm ell{tuple(idx.shape)} nnz={nnz} y{tuple(y.shape)}",
        lambda: spdmm(idx, val, y), lambda: ref.spdmm_ref(idx, val, y),
        lambda: torch.sparse.mm(csr, y),
        4.0 * (2 * idx.numel() + y.numel() + idx.shape[0] * y.shape[1]),
        2.0 * nnz * y.shape[1], 0)


def sddmm_case(x, y, mask, per_request) -> Case:
    """Bound: bytes, or the sampled products at the 3xTF32 rate.  Library:
    ``torch.sparse.sampled_addmm`` of the CSR mask."""
    from repro_torch.kernels import ref, sddmm
    from repro_torch.kernels.sddmm import launch_plan, live_tiles
    m, k = x.shape
    n = y.shape[1]
    # the VIP passes y = xᵀ, a view of x's memory: x is read once
    y_is_x = y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    mask = mask.float().contiguous()
    nnz = int((mask != 0).sum().item())
    live = live_tiles(mask)
    with warnings.catch_warnings():                # "CSR support is beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = mask.to_sparse_csr()                 # set-up, untimed
    label = (f"sddmm ({m},{k})@({k},{n}) y_strides={tuple(y.stride())} "
             f"nnz={nnz} density={nnz / (m * n):.4f} live tiles "
             f"{int(live.sum())}/{live.numel()} = "
             f"{live.float().mean().item():.4f}"
             + (" y=xᵀ" if y_is_x else ""))
    # bytes: x, y (unless it is x's view), the mask and the output once
    # each; operations: the sampled products only, 2·nnz·K
    return Case(
        "sddmm", label, lambda: sddmm(x, y, mask),
        lambda: ref.sddmm_ref(x, y, mask),
        lambda: torch.sparse.sampled_addmm(csr, x, y, beta=0.0),
        4.0 * (m * k + (0 if y_is_x else k * n) + 2 * m * n),
        2.0 * nnz * k, per_request, rate=CONV_FLOPS,
        plan=launch_plan(m, k, n))


def ddmm_case(x, y, *, bias=None, residual=None, act=None, gram=False,
              per_request=0) -> Case:
    """``gram``: y is xᵀ (a VIP's x @ xᵀ), so the function reads x once.
    Library: ``torch.mm`` or ``torch.addmm`` where one call computes the
    function (no activation, no residual); ``mm``: ``torch.mm`` of the
    product alone, always.  Bound: operations at the 3xTF32 rate on the
    tensor-core route, at the fp32 SIMT rate on the narrow one."""
    from repro_torch.kernels import ddmm, ref
    from repro_torch.kernels.ddmm import launch_plan
    m, k = x.shape
    n = y.shape[1]
    library = None
    if act is None and residual is None:
        library = ((lambda: torch.mm(x, y)) if bias is None  # noqa: E731
                   else (lambda: torch.addmm(bias, x, y)))
    nbytes = 4.0 * (x.numel() + (0 if gram else y.numel()) + m * n
                    + (n if bias is not None else 0)
                    + (m * n if residual is not None else 0))
    plan = launch_plan(m, k, n)
    label = (f"ddmm ({m},{k})@({k},{n}) y_strides={tuple(y.stride())} "
             f"bias={bias is not None} act={act} "
             f"residual={residual is not None}"
             + (" y=xᵀ" if gram else ""))
    return Case(
        "ddmm", label,
        lambda: ddmm(x, y, bias=bias, residual=residual, act=act),
        lambda: ref.ddmm_ref(x, y, bias=bias, residual=residual, act=act),
        library, nbytes, 2.0 * m * k * n, per_request,
        rate=CONV_FLOPS if plan.route == "mma" else FP32_FLOPS, plan=plan,
        mm=lambda: torch.mm(x, y), args=(x, y, bias, residual, act))


def knn_case(x, k, *, mask, self_loops, per_request, note="") -> Case:
    """``note``: the name of the input's kind (``knn_adversarial``)."""
    from repro_torch.kernels import knn, ref
    n, f = x.shape
    kw = dict(mask=mask, self_loops=self_loops)
    label = (f"knn x{tuple(x.shape)} k={k} masked={mask is not None} "
             f"self_loops={self_loops}" + (f" ({note})" if note else ""))
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
    got, want = got.float(), want.float()
    err, rel = rel_err(got, want)
    ok = rel <= case.rtol
    msg = f"check {case.label}: max|d|={err:.3e} rel={rel:.3e}"
    if case.library is not None:
        lib = case.library()
        _, lrel = rel_err((lib if lib.layout == torch.strided
                           else lib.to_dense()).float(), want)
        msg += f" (library rel={lrel:.3e})"
    log(msg + ("" if ok else "  FAIL"))
    assert ok, f"{case.label}: kernel disagrees with its plain version"
    return err


def device_events(fn, n: int) -> list:
    """The device kernels of ``n`` calls of ``fn`` under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_base(name: str) -> str:
    """A profiled kernel's bare function name: ``void (anonymous
    namespace)::shift_conv_tf32x3_kernel<64, false>(...)`` ->
    ``shift_conv_tf32x3_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return head.split("<", 1)[0].split()[-1].split("::")[-1]


def device_ms(fn, prefix: str, n: int = 20,
              tries: int = 3) -> float | None:
    """Mean device time of the kernels whose bare name starts with
    ``prefix``, per call of ``fn``, over ``n`` profiled calls.  A profile
    now and then records no device kernel at all; it is taken again, up to
    ``tries`` times (None if none recorded one)."""
    fn()
    for _ in range(tries):
        events = [e for e in device_events(fn, n)
                  if kernel_base(e.name).startswith(prefix)]
        if events:
            return sum(e.time_range.end - e.time_range.start
                       for e in events) / n / 1e3
    return None


def profile_requests(run, requests, card, task) -> None:
    """Device time by kernel name over the requests (``torch.profiler``),
    and the share of the profiled window in which no kernel ran."""
    it = iter(requests)
    profile_window(lambda: run(**next(it)), len(requests),
                   f"{task} requests", "request", card)


def profile_window(fn, n: int, what: str, per: str, card: str) -> None:
    """Profile ``n`` calls of ``fn``: device kernels and busy time per
    call, the idle share of the device window, the largest kernels."""
    kernels = device_events(fn, n)
    if not kernels:
        log(f"profile of {what}: no device events recorded (device "
            "breakdown not measured)")
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
    log(f"profile over {n} {what} (under the profiler): "
        f"{len(kernels) / n:.1f} device kernels/{per}, device busy "
        f"{busy / n / 1e3:.4f} ms/{per}, idle share of the device window "
        f"{1 - busy / window:.3f}  [{card}]")
    by_name: dict[str, list] = {}
    for e in kernels:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.end - e.time_range.start
        tot[1] += 1
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        log(f"  {us / n / 1e3:.4f} ms/{per}  {count // n:3d}x  "
            f"{name[:90]}")


def window_mask(side: int, win: int) -> np.ndarray:
    """0/1 ``(side², side²)`` mask joining each cell of a ``side x side``
    grid to the cells of its ``win x win`` window (clipped at the edges)."""
    r, c = np.divmod(np.arange(side * side), side)
    h = win // 2
    near = ((np.abs(r[:, None] - r[None, :]) <= h)
            & (np.abs(c[:, None] - c[None, :]) <= h))
    return near.astype(np.float32)


def vip_masked_graph(builder, side=VIP_SIDE, feat=VIP_FEAT, win=VIP_WIN):
    """The masked VIP path: ``vip(mask=M)`` -> ``softmax(mask=M)`` -> MP
    over that runtime affinity, on ``side²`` nodes of ``feat`` features,
    M = ``window_mask(side, win)`` (defaults: b3-r50's spatial branch).
    ``builder`` is a ``GraphBuilder`` class: the port's here, either
    package's in the tests, which share this one definition."""
    mask = window_mask(side, win)
    b = builder("vip_masked")
    x = b.input((side * side, feat), name="nodes")
    aff = b.vip(x, mask=mask, name="aff")
    aff = b.softmax(aff, axis=-1, mask=mask, name="aff_sm")
    return b.output(b.mp(x, adj_input=aff, name="agg"))


def task_plans(task):
    """-> (plan with the CUDA kernels bound, the same plan bound to the
    plain versions)."""
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task

    def graph():
        if task == "vip-masked":
            return vip_masked_graph(GraphBuilder)
        return (build_dynamic_task if task == "b6-dyn" else build_task)(task)

    return tuple(compile_graph(graph(), CompileOptions(kernels=mode))
                 for mode in ("cuda", "torch"))


def task_requests(task, plan, plan_torch) -> list[dict]:
    """``REQUESTS`` requests from seeds 0..REQUESTS-1.  b6-dyn: standard
    normal points and the padding mask; b3 and vip-masked: the plan's
    random inputs, scaled (``request_scale``); the others: the plan's
    random inputs."""
    from repro_torch.core.executor import random_inputs
    if task != "b6-dyn":
        reqs = [random_inputs(plan, seed=s) for s in range(REQUESTS)]
        if task in SCALED_TASKS:
            scale = np.float32(request_scale(task, plan, plan_torch,
                                             reqs))
            reqs = [{k: v * scale for k, v in r.items()} for r in reqs]
        return reqs
    n, f = plan.meta["input_shapes"]["points"]
    return [dict(points=np.random.default_rng(s).standard_normal(
        (n, f)).astype(np.float32), mask=pad_mask(n))
        for s in range(REQUESTS)]


def request_scale(task, plan, plan_torch, reqs) -> float:
    """The power of two s that brings the largest VIP affinity over
    ``reqs`` to at most ``AFFINITY_PEAK``.  Also prints what unscaled
    requests show: the cuda plan against the torch plan, and, for the
    request where they differ most, the torch plan on the card against
    the same plan on the CPU."""
    from repro_torch.core import build_runner
    vips = [op.name for op in plan_torch.ops if op.kind == "sddmm"]
    probe = build_runner(dataclasses.replace(plan_torch, outputs=vips),
                         free_dead=False)
    peak = max(a.abs().max().item() for r in reqs for a in probe(**r))
    scale = 2.0 ** math.floor(0.5 * math.log2(AFFINITY_PEAK / peak))
    run_cuda, run_torch = build_runner(plan), build_runner(plan_torch)
    rels = [rel_err(run_cuda(**r)[0], run_torch(**r)[0])[1] for r in reqs]
    worst = int(np.argmax(rels))
    cpu = build_runner(plan_torch, device="cpu")(**reqs[worst])[0]
    _, rel_cpu = rel_err(run_torch(**reqs[worst])[0].cpu(), cpu)
    log(f"{task}: standard-normal requests give max|affinity| {peak:.3e} "
        f"({', '.join(vips)}); unscaled, cuda vs torch plan rel up to "
        f"{rels[worst]:.3e} (request {worst}), where the torch plan on the "
        f"card vs on the CPU gives rel={rel_cpu:.3e}; requests scaled by "
        f"2^{math.log2(scale):.0f}")
    return scale


def serve(task, plan, plan_torch, requests, kernels) -> dict[str, int]:
    """Drive one task's main path: every launch count set to 0 just
    before, read just after.  Checks counts and outputs; returns the
    counts."""
    from repro_torch.core import build_runner
    per_req = dict.fromkeys(kernels, 0)
    expected = {**per_req, **PER_REQUEST[task]}
    for op in plan.ops:
        if op.kernel == "cuda_ddmm":
            per_req["shift_conv2d" if op.kind == "conv" else "ddmm"] += 1
        elif op.kernel == "cuda_ell_spdmm":
            per_req["spdmm"] += 1
        elif op.kernel == "cuda_knn":
            per_req["knn"] += 1
        elif op.kernel == "cuda_sddmm":     # unmasked: DDMM on x @ xᵀ
            per_req["sddmm" if "mask" in op.weights else "ddmm"] += 1
    assert per_req == expected, (task, per_req)
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


def kernel_rows(task, cases, launches, per_request, max_err, card,
                unit=None) -> list[dict]:
    """Time every case; one JSON row per kernel the path runs
    (``per_request``: its launches per request)."""
    totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, device_ms=0.0, nbytes=0.0,
                         flops=0.0, library=True, device=True,
                         before_ms=None, before_device_ms=None, mm_ms=None)
              for name in SOURCES}
    for case in cases:
        ms = time_ms(case.run)
        plain = time_ms(case.plain)
        lib = time_ms(case.library) if case.library is not None else None
        bnd, by = bound_ms(case.nbytes, case.flops, case.rate)
        dev = device_ms(case.run, DEVICE_PREFIX[case.kernel])
        # the rate of the products the function needs, by device time
        rate = case.flops / ((dev or ms) * 1e-3) / 1e12
        plan = case.plan
        extra = {}
        if case.before is not None:
            extra["before_ms"] = time_ms(case.before)
            # every device kernel of the old route, its copies included
            extra["before_device_ms"] = device_ms(case.before, "")
        if case.mm is not None:
            extra["mm_ms"] = time_ms(case.mm)
        log(f"time {task} {case.label}: kernel {ms:.5f} ms"
            + ("" if dev is None else f" (device {dev:.5f} ms)")
            + f", plain {plain:.5f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{bnd:.5f} ms ({by}), {rate:.2f} TFLOP/s"
            + "".join(f", {k} {v:.5f}" for k, v in extra.items()
                      if v is not None)
            + ("" if plan is None else
               f", {getattr(plan, 'route', 'tile')} {plan.bm}x{plan.bn} "
               f"split {plan.split} of {plan.k_tiles} K tiles, "
               f"{plan.blocks} blocks")
            + (f", {bnd / (dev or ms):.4f} of the bound"
               if case.kernel in BOUND_SHARE else "")
            + f", x{case.per_request:g}/request  [{card}]")
        if case.per_request:
            tot = totals[case.kernel]
            for key, value in extra.items():
                if value is not None:
                    tot[key] = (tot[key] or 0.0) + case.per_request * value
            tot["ms"] += case.per_request * ms
            tot["plain_ms"] += case.per_request * plain
            tot["bound_ms"] += case.per_request * bnd
            # operations in fp32-rate units, so that mixed cases compare
            tot["nbytes"] += case.per_request * case.nbytes
            tot["flops"] += case.per_request * case.flops * (
                FP32_FLOPS / case.rate)
            if lib is None:
                tot["library"] = False
            else:
                tot["library_ms"] += case.per_request * lib
            if dev is None:
                tot["device"] = False
            else:
                tot["device_ms"] += case.per_request * dev
    rows = []
    for name, tot in totals.items():
        if not per_request.get(name):
            continue
        _, by = bound_ms(tot["nbytes"], tot["flops"])
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "launches_per_request": per_request[name],
            "max_abs_err": max_err[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": by,
            "library_ms": tot["library_ms"] if tot["library"] else None,
            "unit": unit or f"ms per {task} request: sum over its launches",
        }
        if tot["device"]:
            row["device_ms"] = tot["device_ms"]
        if name in BOUND_SHARE:
            # the bound over the time taken: device time where profiled
            took = tot["device_ms"] if tot["device"] else tot["ms"]
            row["bound_share"] = tot["bound_ms"] / took
            log(f"{task} {name}: {took:.5f} ms/request "
                f"({'device' if tot['device'] else 'events'}) against a "
                f"bound of {tot['bound_ms']:.5f} ms: "
                f"{row['bound_share']:.4f} of the bound  [{card}]")
        for key in ("before_ms", "before_device_ms", "mm_ms"):
            if tot[key] is not None:
                row[key] = tot[key]
        rows.append(row)
    return rows


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: under the diagonal when
    causal (query i sees keys j <= i + sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def flash_case(shape, dtype, rng, dev, per_request=0.0) -> Case:
    """Flash attention at ``(B, Hq, Hkv, Sq, Sk, D, causal)``.  Bound: q,
    k, v and o moved once; 4·D operations per live pair at the peak of the
    input's type.  Library: one ``F.scaled_dot_product_attention`` call
    (its causal mask is aligned at the top left, so only at Sq = Sk or
    without a mask is it the same function)."""
    from repro_torch.kernels import flash_attention, ref
    b, hq, hkv, sq, sk, d, causal = shape
    q, k, v = (torch.tensor(rng.standard_normal(sh), dtype=torch.float32,
                            device=dev).to(dtype)
               for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    library = None
    if sq == sk or not causal:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    bf16 = dtype == torch.bfloat16
    label = (f"flash_attention {str(dtype).split('.')[-1]} q{tuple(q.shape)} "
             f"kv{tuple(k.shape)} causal={causal}")
    return Case(
        "flash_attention", label,
        lambda: flash_attention(q, k, v, causal=causal),
        lambda: ref.attention_ref(q, k, v, causal=causal), library,
        q.element_size() * (2.0 * q.numel() + 2.0 * k.numel()),
        4.0 * d * b * hq * live_pairs(sq, sk, causal), per_request,
        rtol=FLASH_BF16_RTOL if bf16 else KERNEL_RTOL,
        rate=BF16_FLOPS if bf16 else FP32_FLOPS)


def lm_buckets(cfg) -> dict[int, int]:
    """Requests per prefill bucket among the launcher's prompts."""
    from repro_torch.launch.serve import prompts
    from repro_torch.serve import ServeEngine
    counts: dict[int, int] = {}
    for p in prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT_LEN, 0):
        bucket = ServeEngine._bucket(len(p))
        counts[bucket] = counts.get(bucket, 0) + 1
    return counts


def lm_cases(cfg, rng, dev) -> dict[str, list[Case]]:
    """The flash kernel's calls on the LM paths in bf16 (the served
    prefills, weighted by their share of requests; the 2048-token
    prefill), the same shapes in fp32, and edge cases in both types: a
    D = 64 GQA (llama3.2's heads), a continuation (Sq < Sk), rows with no
    live key (Sq > Sk) and no mask at ragged sizes."""
    hq, hkv, d, n_l = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                       cfg.n_layers)
    bf16, f32 = torch.bfloat16, torch.float32
    serve_cases = [flash_case((1, hq, hkv, s, s, d, True), bf16, rng, dev,
                              per_request=n * n_l / LM_REQUESTS)
                   for s, n in sorted(lm_buckets(cfg).items())]
    long = (1, hq, hkv, LONG_PROMPT, LONG_PROMPT, d, True)
    long_cases = [flash_case(long, bf16, rng, dev, per_request=n_l),
                  flash_case(long, f32, rng, dev)]
    extra = [flash_case((1, hq, hkv, s, s, d, True), f32, rng, dev)
             for s in sorted(lm_buckets(cfg))]
    for shape in ((2, 32, 8, 128, 128, 64, True),
                  (1, hq, hkv, 64, 256, d, True),
                  (1, hq, hkv, 80, 48, d, True),
                  (2, 2, 1, 77, 154, 48, False)):
        extra += [flash_case(shape, dt, rng, dev) for dt in (f32, bf16)]
    return {"lm-serve": serve_cases + extra, "lm-prefill-2048": long_cases}


def flash_exact_checks(cfg, rng, dev) -> None:
    """Rows with no live key come out as exact zeros; (B, S, H, D)
    activations read as permuted views give the bits of contiguous
    copies."""
    from repro_torch.kernels import flash_attention
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)

    out = flash_attention(t(1, hq, 80, d), t(1, hkv, 48, d), t(1, hkv, 48, d))
    views = [t(2, 48, h, d).transpose(1, 2) for h in (hq, hkv, hkv)]
    got = flash_attention(*views)
    copies = flash_attention(*(a.contiguous() for a in views))
    torch.cuda.synchronize()
    nonzero = int((out[:, :, :32] != 0).sum().item())
    differ = int((got != copies).sum().item())
    log(f"check flash_attention Sq=80 > Sk=48: {nonzero} nonzero outputs on "
        f"the 32 rows with no live key; permuted (B, S, H, D) views vs "
        f"contiguous copies: {differ} elements differ"
        + ("" if not (nonzero or differ) else "  FAIL"))
    assert not nonzero, "flash_attention: a row with no live key is not 0"
    assert not differ, "flash_attention: strided views change the result"


def lm_counts(kernels, want: dict[str, int], what: str) -> dict[str, int]:
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"{what}: launches {launches}")
    assert launches == {**dict.fromkeys(kernels, 0), **want}, (what,
                                                               launches)
    return launches


def lm_serve(cfg, kernels) -> dict[str, int]:
    """The LM path through its entry point, ``launch.serve.serve`` at the
    launcher's defaults and the published config: counts set to 0 just
    before, read just after."""
    from repro_torch.launch.serve import serve as serve_lm
    for fn in kernels.values():
        fn.launches = 0
    res = serve_lm(LM_ARCH, smoke=False, device="cuda")
    torch.cuda.synchronize()
    launches = lm_counts(kernels, {"flash_attention": LM_REQUESTS
                                   * cfg.n_layers}, f"{LM_ARCH} serve")
    log(f"{LM_ARCH} serve (launch.serve.serve, full config): "
        f"{json.dumps(res)}")
    assert res["requests"] == LM_REQUESTS
    assert res["tokens_generated"] == LM_REQUESTS * LM_MAX_NEW, res
    return launches


def lm_engine_run(cfg, params, kernels, card):
    """The same requests through a ``ServeEngine`` stepped here, timed on
    the host clock per step, per request and per token.  Returns the
    engine and its requests."""
    from repro_torch.launch.serve import prompts
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    batch = prompts(cfg.vocab, LM_REQUESTS, LM_PROMPT_LEN, 0)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=LM_MAX_NEW) for p in batch]
    first, done, steps = {}, {}, []
    while not all(r.done for r in reqs):
        t_a = time.perf_counter()
        eng.step()                        # ends in .tolist(): synchronized
        t_b = time.perf_counter()
        steps.append((t_b - t_a) * 1e3)
        for r in reqs:
            if r.out:
                first.setdefault(r.rid, t_b)
            if r.done:
                done.setdefault(r.rid, t_b)
        assert len(steps) <= LM_REQUESTS * LM_MAX_NEW, "did not converge"
    wall = time.perf_counter() - t0
    lm_counts(kernels, {"flash_attention": LM_REQUESTS * cfg.n_layers},
              f"{LM_ARCH} engine run")
    lat = [(done[r.rid] - t0) * 1e3 for r in reqs]
    ttft = [(first[r.rid] - t0) * 1e3 for r in reqs]
    per_tok = [(done[r.rid] - first[r.rid]) * 1e3 / (len(r.out) - 1)
               for r in reqs]

    def q(xs):
        qs = statistics.quantiles(xs, n=10)
        return (f"p50 {statistics.median(xs):.4f} ms, p10 {qs[0]:.4f}, "
                f"p90 {qs[-1]:.4f}, max {max(xs):.4f}")

    n_tok = sum(len(r.out) for r in reqs)
    log(f"{LM_ARCH} engine run (host clock): {len(reqs)} requests, "
        f"{len(steps)} steps, {n_tok} tokens in {wall:.4f} s "
        f"({n_tok / wall:.2f} tok/s)  [{card}]")
    log(f"  request latency (all submitted at t0): {q(lat)}")
    log(f"  time to first token: {q(ttft)}")
    log(f"  per token after the first, per request: {q(per_tok)}")
    log(f"  engine step (admissions + one decode step): {q(steps)}")
    return eng, reqs


def lm_parity(cfg, params, reqs) -> None:
    """Margin-aware parity of the served tokens against the plain path
    (``impl="naive"``, same weights): each request's prefill logits, and
    each engine token's plain logit against that position's maximum."""
    from repro_torch.models.transformer import lm_forward, lm_prefill
    from repro_torch.serve import ServeEngine
    dev = params["embed"].device
    worst_prefill = worst_gap = 0.0
    agree = total = 0
    for r in reqs:
        n = len(r.prompt)
        padded = np.zeros(ServeEngine._bucket(n), np.int64)
        padded[:n] = r.prompt
        tok = torch.as_tensor(padded, device=dev)[None]
        got, want = (lm_prefill(params, cfg, tokens=tok, max_len=LM_MAX_LEN,
                                impl=impl, last_index=n - 1)[0]
                     for impl in ("chunked", "naive"))
        worst_prefill = max(worst_prefill, rel_err(got, want)[1])
        seq = np.concatenate([r.prompt, r.out[:-1]])
        logits, _ = lm_forward(params, cfg, impl="naive",
                               tokens=torch.as_tensor(seq, device=dev)[None])
        rows = logits[0, n - 1:]                       # (len(out), V)
        out = torch.as_tensor(r.out, device=dev)
        gap = ((rows.amax(-1) - rows.gather(1, out[:, None])[:, 0])
               / rows.abs().amax(-1))
        worst_gap = max(worst_gap, gap.max().item())
        agree += int((rows.argmax(-1) == out).sum().item())
        total += len(r.out)
    ok = worst_prefill <= PREFILL_RTOL and worst_gap <= MARGIN_RTOL
    log(f"{LM_ARCH} parity vs the plain path: prefill logits rel up to "
        f"{worst_prefill:.3e} (limit {PREFILL_RTOL:g}); engine tokens "
        f"{agree}/{total} equal the plain argmax, the largest gap below "
        f"the plain maximum {worst_gap:.3e} of max|logits| (limit "
        f"{MARGIN_RTOL:g})" + ("" if ok else "  FAIL"))
    assert worst_prefill <= PREFILL_RTOL, "prefill logits disagree"
    assert worst_gap <= MARGIN_RTOL, "an engine token is off the plain max"


def as_fp32(tree):
    if isinstance(tree, dict):
        return {k: as_fp32(v) for k, v in tree.items()}
    return tree.float()


def long_prompt(cfg, dev) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, LONG_PROMPT)), device=dev)


def lm_fp32_parity(cfg, params, reqs) -> None:
    """Kernel path against plain path at full width with the weights in
    fp32, over every served prompt (padded to its bucket) and the
    2048-token prompt: the bf16 comparison is dominated by roundings the
    random model amplifies through its layers, the fp32 one holds the
    kernel's own error."""
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.serve import ServeEngine
    p32 = as_fp32(params)
    dev = p32["embed"].device
    inputs = []
    for r in reqs:
        n = len(r.prompt)
        padded = np.zeros(ServeEngine._bucket(n), np.int64)
        padded[:n] = r.prompt
        inputs.append((torch.as_tensor(padded, device=dev)[None], n - 1,
                       LM_MAX_LEN))
    inputs.append((long_prompt(cfg, dev), None, LONG_PROMPT))
    rels = []
    for tok, last, max_len in inputs:
        got, want = (lm_prefill(p32, cfg, tokens=tok, max_len=max_len,
                                impl=impl, last_index=last)[0]
                     for impl in ("chunked", "naive"))
        rels.append(rel_err(got, want)[1])
    ok = max(rels) <= E2E_RTOL
    log(f"{LM_ARCH} in fp32, kernel vs plain path prefill logits: rel up to "
        f"{max(rels[:-1]):.3e} over the {len(reqs)} served prompts, "
        f"{rels[-1]:.3e} at {LONG_PROMPT} tokens (limit {E2E_RTOL:g})"
        + ("" if ok else "  FAIL"))
    assert ok, "fp32 prefill logits disagree"


def lm_long_prefill(cfg, params, kernels, card) -> dict[str, int]:
    """One ``lm_prefill`` of a 2048-token prompt: counts set to 0 just
    before, read just after; logits against the plain path; host times
    of both paths in turns."""
    from repro_torch.models.transformer import lm_prefill
    tok = long_prompt(cfg, params["embed"].device)

    def run(impl):
        return lm_prefill(params, cfg, tokens=tok, max_len=LONG_PROMPT,
                          impl=impl)

    for fn in kernels.values():
        fn.launches = 0
    logits, caches, length = run("chunked")
    torch.cuda.synchronize()
    launches = lm_counts(kernels, {"flash_attention": cfg.n_layers},
                         f"{LM_ARCH} prefill of {LONG_PROMPT} tokens")
    assert tuple(logits.shape) == (1, cfg.vocab) and length == LONG_PROMPT
    assert torch.isfinite(logits).all(), "non-finite prefill logits"
    err, rel = rel_err(logits, run("naive")[0])
    log(f"{LM_ARCH} prefill of {LONG_PROMPT} tokens: kernel vs plain path "
        f"logits max|d|={err:.3e} rel={rel:.3e} (limit {PREFILL_RTOL:g})"
        + ("" if rel <= PREFILL_RTOL else "  FAIL"))
    assert rel <= PREFILL_RTOL, "2048-token prefill disagrees"
    times = {"chunked": [], "naive": []}
    for turn in range(3):
        for impl in (("chunked", "naive") if turn % 2 == 0
                     else ("naive", "chunked")):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            run(impl)
            torch.cuda.synchronize()
            times[impl].append((time.perf_counter() - t_a) * 1e3)
    log(f"{LM_ARCH} prefill of {LONG_PROMPT} tokens (host clock, "
        f"synchronized, 3 each): kernel path p50 "
        f"{statistics.median(times['chunked']):.4f} ms, plain path p50 "
        f"{statistics.median(times['naive']):.4f} ms  [{card}]")
    return launches


def lm_profiles(cfg, params, eng, card) -> None:
    """Device busy time and idle share of a served prefill (bucket 48),
    a decode step over all slots, and the 2048-token prefill."""
    from repro_torch.models.transformer import lm_decode_step, lm_prefill
    dev = params["embed"].device
    rng = np.random.default_rng(1)
    tok48 = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 48)), device=dev)
    tok_long = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LONG_PROMPT)),
                               device=dev)
    step_tok = torch.as_tensor(rng.integers(0, cfg.vocab, LM_SLOTS),
                               device=dev)
    lengths = torch.arange(LM_SLOTS, device=dev) * 8 + 40
    profile_window(lambda: lm_prefill(params, cfg, tokens=tok48,
                                      max_len=LM_MAX_LEN, last_index=40),
                   5, f"{LM_ARCH} prefills of a 48-token bucket", "prefill",
                   card)
    profile_window(lambda: lm_decode_step(params, cfg, step_tok, eng.caches,
                                          lengths),
                   10, f"{LM_ARCH} decode steps over {LM_SLOTS} slots",
                   "step", card)
    profile_window(lambda: lm_prefill(params, cfg, tokens=tok_long,
                                      max_len=LONG_PROMPT),
                   1, f"{LM_ARCH} prefill of {LONG_PROMPT} tokens", "prefill",
                   card)


def device_only_ms(fn, n: int = 40) -> float:
    """Mean device time of ``fn`` by CUDA events, with the host's launches
    queued behind a sleeping kernel, so that the host's launch rate does
    not show."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(30_000_000)               # ~15 ms: queue n launches
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def conv_sweep(card) -> None:
    """Every pixel tile and split-K factor of the shift-conv kernel at every
    distinct conv shape of b4, b5, b1, b2 and b3 (device time, checked
    against the plain version), beside the plan's choice; per task, the
    plan's sum over a request's convs against the best per layer."""
    from repro_torch.kernels import _build, ref
    lib = _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timed: dict[tuple, tuple[float, float]] = {}   # shape -> (plan, best)
    for task in ("b4", "b5", "b1", "b2", "b3-r50", "b3-r101"):
        plan_ms = best_ms = 0.0
        plan = task_plans(task)[0]
        shapes = dict(plan.meta["input_shapes"])
        for op in plan.ops:
            xin = tuple(shapes[op.inputs[0]])
            shapes[op.name] = op.out_shape
            if op.kind != "conv":
                continue
            w_shape, stride = op.weights["w"].shape, ref.pair(
                op.attrs["stride"])
            key = (xin, w_shape, stride, op.attrs["padding"])
            if key not in timed:
                timed[key] = sweep_shape(lib, dev, rng, *key, card)
            plan_ms += timed[key][0]
            best_ms += timed[key][1]
        log(f"conv sweep {task}: the plan's choice {plan_ms:.4f} ms of "
            f"device time per request, the best per layer {best_ms:.4f} ms "
            f"({plan_ms / best_ms - 1:+.1%})  [{card}]")


def sweep_shape(lib, dev, rng, x_shape, w_shape, stride, padding,
                card) -> tuple[float, float]:
    """Device time of one conv shape at every block tile and split,
    each result checked against the plain version -> (the plan's choice,
    the best), in ms."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.shift_conv import BK, launch_plan
    k1, k2, cin, cout = w_shape
    batch = x_shape[0] if len(x_shape) == 4 else 1
    H, W = x_shape[-2:]
    ho, wo, pad_t, _, pad_l, _ = ref.conv_geometry(
        H, W, k1, k2, stride=stride, padding=padding, dilation=(1, 1))
    x = torch.tensor(rng.standard_normal(x_shape), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.standard_normal(w_shape), dtype=torch.float32,
                     device=dev)
    want = ref.conv2d_ref(x, w, stride=stride, padding=padding)
    k_tiles = -(-k1 * k2 * cin // BK)
    chosen = launch_plan(x_shape, w_shape, stride=stride, padding=padding)
    times = {}
    for bm, bn, split in itertools.product((32, 64), (32, 64),
                                           range(1, k_tiles + 1)):
        tiles = -(-cout // bm) * -(-ho * wo // bn)
        if k_tiles % split or (tiles * split > 4096 and (bm, bn, split) != (
                chosen.bm, chosen.bn, chosen.split)):
            continue
        buf = torch.empty((split, *want.shape), device=dev)
        params = (ctypes.c_int * 20)(
            batch, cin, H, W, k1, k2, cout, 1, ho, wo, *stride, 1, 1,
            pad_t, pad_l, bm, bn, split, int((k1, k2, *stride) == (1,) * 4))

        def run():
            return lib.repro_shift_conv2d(
                x.data_ptr(), w.data_ptr(), buf.data_ptr(), params,
                torch.cuda.current_stream(dev).cuda_stream)
        assert run() == 0
        torch.cuda.synchronize()
        _, rel = rel_err(buf[0], want)
        assert rel <= KERNEL_RTOL, (x_shape, w_shape, bm, bn, split, rel)
        times[bm, bn, split] = device_only_ms(run)
    mine = times[chosen.bm, chosen.bn, chosen.split]
    (bbm, bbn, bsplit), best = min(times.items(), key=lambda kv: kv[1])
    log(f"conv sweep x{x_shape} w{w_shape} stride={stride}: plan tile "
        f"{chosen.bm}x{chosen.bn} split {chosen.split} of {k_tiles} K tiles "
        f"{mine:.5f} ms; best {bbm}x{bbn} split {bsplit} {best:.5f} ms; all "
        + " ".join(f"{bm}x{bn}/{sp}:{t:.4f}" for (bm, bn, sp), t in
                   sorted(times.items())) + f"  [{card}]")
    return mine, best


def ddmm_sweep(card) -> None:
    """Every column tile and K split of DDMM's tensor-core route at every
    distinct tensor-core call of the paths (device time, each checked
    against the plain version), beside the plan's choice; per task, the
    plan's sum over a request's calls against the best per call."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.ddmm import ACT_CODES, BK, MAX_SPLIT, y_layout
    lib = _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    timed: dict[tuple, tuple[float, float]] = {}
    for task in PER_REQUEST:
        plan_ms = best_ms = 0.0
        for case in task_cases(task, task_plans(task)[0], rng, dev):
            if case.kernel != "ddmm" or not case.per_request \
                    or case.plan.route != "mma":
                continue
            x, y, bias, res, act = case.args
            key = (tuple(x.shape), tuple(y.shape), tuple(y.stride()),
                   bias is not None, act)
            if key not in timed:
                timed[key] = sweep_ddmm(lib, x, y, bias, res, act, case.plan,
                                        card, ref, BK, MAX_SPLIT,
                                        y_layout(y), ACT_CODES[act])
            plan_ms += case.per_request * timed[key][0]
            best_ms += case.per_request * timed[key][1]
        if plan_ms:
            log(f"ddmm sweep {task}: the plan's choice {plan_ms:.4f} ms of "
                f"device time per request, the best per call {best_ms:.4f} "
                f"ms ({plan_ms / best_ms - 1:+.1%})  [{card}]")


def sweep_ddmm(lib, x, y, bias, res, act, chosen, card, ref, bk, max_split,
               layout, act_code) -> tuple[float, float]:
    """Device time of one DDMM call at every column tile and split ->
    (the plan's choice, the best), in ms."""
    m, k = x.shape
    n = y.shape[1]
    want = ref.ddmm_ref(x, y, bias=bias, residual=res, act=act)
    k_tiles = max(1, -(-k // bk))
    out = torch.empty_like(want)
    times = {}
    for bn in (32, 64):
        for split in range(1, min(max_split, k_tiles) + 1):
            kt_per = -(-k_tiles // split)
            if -(-k_tiles // kt_per) != split:
                continue
            params = (ctypes.c_int * 11)(m, k, n, layout[1], int(layout[0]),
                                         act_code, 0, chosen.bm, bn, kt_per,
                                         split)

            def run():
                return lib.repro_ddmm(
                    x.data_ptr(), y.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    None if res is None else res.data_ptr(), out.data_ptr(),
                    params, torch.cuda.current_stream().cuda_stream)
            assert run() == 0
            torch.cuda.synchronize()
            _, rel = rel_err(out, want)
            assert rel <= KERNEL_RTOL, (m, k, n, bn, split, rel)
            times[bn, split] = device_only_ms(run)
    mine = times[chosen.bn, chosen.split]
    (bbn, bsplit), best = min(times.items(), key=lambda kv: kv[1])
    log(f"ddmm sweep ({m},{k})@({k},{n}) y_strides={tuple(y.stride())}: "
        f"plan {chosen.bm}x{chosen.bn} split {chosen.split} of {k_tiles} K "
        f"stages {mine:.5f} ms; best {chosen.bm}x{bbn} split {bsplit} "
        f"{best:.5f} ms; all " + " ".join(
            f"{bn}/{sp}:{t:.4f}" for (bn, sp), t in sorted(times.items()))
        + f"  [{card}]")
    return mine, best


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (_build, ddmm, flash_attention, knn,
                                     sddmm, shift_conv2d, spdmm_rows)
    from repro_torch.kernels.flash_attention import MAX_D
    from repro_torch.kernels.knn import MAX_K
    from repro_torch.kernels.sddmm import BLOCK
    from repro_torch.models.transformer import init_lm
    # "spdmm" counts the entry the path calls, spdmm_rows
    kernels = {"shift_conv2d": shift_conv2d, "spdmm": spdmm_rows,
               "ddmm": ddmm, "knn": knn, "sddmm": sddmm,
               "flash_attention": flash_attention}

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
    assert lib.repro_sddmm_block() == BLOCK, \
        "csrc/sddmm.cu and sddmm.py disagree"
    assert lib.repro_flash_max_d() == MAX_D, \
        "csrc/flash_attention.cu and flash_attention.py disagree"
    if "--conv-sweep" in sys.argv[1:]:
        conv_sweep(card)
        return finish()
    if "--ddmm-sweep" in sys.argv[1:]:
        ddmm_sweep(card)
        return finish()

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
        exact_checks(task, rng, dev)
    lm_cfg = configs.get(LM_ARCH)
    lm_paths = lm_cases(lm_cfg, rng, dev)
    for path, path_cases in lm_paths.items():
        max_err[path] = {"flash_attention": max(
            check_case(case) for case in path_cases)}
    flash_exact_checks(lm_cfg, rng, dev)

    # ---- phase 3: serve each task's requests through the CUDA kernels ---
    requests = {task: task_requests(task, *plans[task]) for task in tasks}
    launches = {task: serve(task, *plans[task], requests[task], kernels)
                for task in tasks}
    launches["lm-serve"] = lm_serve(lm_cfg, kernels)
    lm_params = init_lm(0, lm_cfg, device="cuda")
    eng, lm_reqs = lm_engine_run(lm_cfg, lm_params, kernels, card)
    lm_parity(lm_cfg, lm_params, lm_reqs)
    lm_fp32_parity(lm_cfg, lm_params, lm_reqs)
    launches["lm-prefill-2048"] = lm_long_prefill(lm_cfg, lm_params,
                                                  kernels, card)

    # ---- phase 4: timing -----------------------------------------------
    rows = []
    for task in tasks:
        request_times(task, *plans[task], requests[task], card)
    lm_profiles(lm_cfg, lm_params, eng, card)
    for task in tasks:
        rows += kernel_rows(task, cases[task], launches[task],
                            PER_REQUEST[task], max_err[task], card)
    per_prefill = {"flash_attention": lm_cfg.n_layers}
    rows += kernel_rows(
        "lm-serve", lm_paths["lm-serve"], launches["lm-serve"], per_prefill,
        max_err["lm-serve"], card,
        unit=f"ms per {LM_ARCH} served request: its prefill's "
             f"{lm_cfg.n_layers} launches at its bucket, mean over the "
             f"{LM_REQUESTS} requests")
    rows += kernel_rows(
        "lm-prefill-2048", lm_paths["lm-prefill-2048"],
        launches["lm-prefill-2048"], per_prefill, max_err["lm-prefill-2048"],
        card, unit=f"ms per {LONG_PROMPT}-token {LM_ARCH} prefill: sum "
                   f"over its {lm_cfg.n_layers} launches")
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    return finish()


def finish() -> int:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
