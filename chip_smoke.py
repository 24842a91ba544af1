"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
plain attention path, and times kernels, requests and tokens.  Every
number printed is measured in this run.  The last line is the JSON result;
any failure exits nonzero before it.  Imports the port only
(``repro_torch``), never JAX.
"""
from __future__ import annotations

import dataclasses
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
# the fp32 rate outside the tensor cores, which is what these fp32 SIMT
# kernels (and their plain versions, with TF32 off) run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# the bf16 tensor-core peak: the least time for bf16 attention's products
BF16_FLOPS = 989e12

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
# Flash attention in bf16: kernel and plain version both compute in fp32
# from the same bf16 inputs and round the result once to bf16, so an
# element may differ by one bf16 ulp (2^-8 of itself) where the two fp32
# sums straddle a rounding boundary: within 2^-7 of max|plain|.
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

    def ddmm_at(x, y, gram=False):
        key = ("ddmm", tuple(x.shape), tuple(y.shape), gram)
        if key not in cases:
            cases[key] = ddmm_case(x, y, gram=gram, per_request=0)
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
            c, tt, v = xin                     # right_t: (V, C·T) operand
            key = ("spdmm", (v, c * tt), op.ell[0].shape)
            if key not in cases:
                idx, val = t(op.ell[0], torch.int32), t(op.ell[1])
                y = t(rng.standard_normal((v, c * tt)))
                cases[key] = spdmm_case(idx, val, y, per_request=0)
            cases[key].per_request += 1
        elif op.kernel == "cuda_ddmm" and op.kind == "mm":
            # the runtime calls the kernel without epilogue; bias and
            # activation follow in the shared epilogue
            ddmm_at(*map(t, mm_operands(op, xin, shapes, rng)))
        elif op.kernel == "cuda_sddmm" and "mask" not in op.weights:
            x = t(rng.standard_normal(xin))            # VIP: x @ xᵀ
            ddmm_at(x, x.T.contiguous(), gram=True)
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
    return list(cases.values()) + extra


def exact_checks(task, rng, dev) -> None:
    """Kernel results beyond the main path that must hold exactly: a
    batched conv equals its per-image calls (same arithmetic order, b1);
    SDDMM's dead tiles come out as exact zeros (vip-masked)."""
    from repro_torch.kernels import sddmm, shift_conv2d
    from repro_torch.kernels.sddmm import live_tiles

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    if task == "b1":
        for xs, ws, kw in (
                ((26, 1, 28, 28), (3, 3, 1, 64), dict(stride=1)),
                ((26, 64, 14, 14), (3, 3, 64, 64), dict(stride=1)),
                ((5, 8, 15, 25), (3, 2, 2, 8),
                 dict(stride=(2, 1), padding="VALID", groups=4,
                      dilation=(1, 2)))):
            x, w = t(rng.standard_normal(xs)), t(rng.standard_normal(ws))
            got = shift_conv2d(x, w, **kw)
            each = torch.stack([shift_conv2d(xi, w, **kw) for xi in x])
            torch.cuda.synchronize()
            differ = int((got != each).sum().item())
            log(f"check batched shift_conv2d x{xs} w{ws} {kw}: one launch "
                f"vs {xs[0]} per-image launches, {differ} elements differ"
                + ("" if not differ else "  FAIL"))
            assert not differ, "batched conv differs from per-image calls"
    elif task == "vip-masked":
        x, y = t(rng.standard_normal((256, 64))), t(rng.standard_normal(
            (64, 256)))
        mask = torch.zeros((256, 256), device=dev)
        mask[:128, :128] = 1.0
        got = sddmm(x, y, mask)
        torch.cuda.synchronize()
        dead = torch.cat([got[128:].flatten(), got[:128, 128:].flatten()])
        nonzero = int((dead != 0).sum().item())
        log(f"check sddmm dead tiles: mask live on [:128, :128] of 256x256, "
            f"{int(live_tiles(mask).sum())}/{live_tiles(mask).numel()} tiles "
            f"live, {nonzero} nonzero outputs outside"
            + ("" if not nonzero else "  FAIL"))
        assert not nonzero, "sddmm: a dead tile is not exactly zero"


def pad_mask(n: int) -> np.ndarray:
    """Ones with the last ``PAD_POINTS`` set to zero (padded points)."""
    mask = np.ones(n, np.float32)
    mask[-PAD_POINTS:] = 0.0
    return mask


def conv_case(x, w, kw, per_request) -> Case:
    from repro_torch.kernels import ref, shift_conv2d
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
        2.0 * batch * k1 * k2 * cin_g * cout * ho * wo, per_request)


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


def sddmm_case(x, y, mask, per_request) -> Case:
    from repro_torch.kernels import ref, sddmm
    from repro_torch.kernels.sddmm import live_tiles
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
        2.0 * nnz * k, per_request)


def ddmm_case(x, y, *, bias=None, residual=None, act=None, gram=False,
              per_request=0) -> Case:
    """``gram``: y is xᵀ (a VIP's x @ xᵀ), so the function reads x once."""
    from repro_torch.kernels import ddmm, ref
    m, k = x.shape
    n = y.shape[1]
    library = None
    if act is None and residual is None:
        library = ((lambda: torch.mm(x, y)) if bias is None  # noqa: E731
                   else (lambda: torch.addmm(bias, x, y)))
    nbytes = 4.0 * (x.numel() + (0 if gram else y.numel()) + m * n
                    + (n if bias is not None else 0)
                    + (m * n if residual is not None else 0))
    label = (f"ddmm ({m},{k})@({k},{n}) bias={bias is not None} "
             f"act={act} residual={residual is not None}"
             + (" y=xᵀ" if gram else ""))
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


def device_ms(fn, name: str, n: int = 20) -> float | None:
    """Mean device time of the kernels whose name holds ``name`` per call
    of ``fn``, over ``n`` profiled calls (None if none was recorded)."""
    fn()
    events = [e for e in device_events(fn, n) if name in e.name]
    if not events:
        return None
    return sum(e.time_range.end - e.time_range.start
               for e in events) / n / 1e3


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
                         flops=0.0, library=True, device=True)
              for name in SOURCES}
    for case in cases:
        ms = time_ms(case.run)
        plain = time_ms(case.plain)
        lib = time_ms(case.library) if case.library is not None else None
        bnd, by = bound_ms(case.nbytes, case.flops, case.rate)
        dev = (device_ms(case.run, "flash_kernel")
               if case.kernel == "flash_attention" else None)
        log(f"time {task} {case.label}: kernel {ms:.5f} ms"
            + ("" if dev is None else f" (device {dev:.5f} ms)")
            + f", plain {plain:.5f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{bnd:.5f} ms ({by}), x{case.per_request:g}/request  [{card}]")
        if case.per_request:
            tot = totals[case.kernel]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (_build, ddmm, flash_attention, knn,
                                     sddmm, shift_conv2d, spdmm)
    from repro_torch.kernels.flash_attention import MAX_D
    from repro_torch.kernels.knn import MAX_K
    from repro_torch.kernels.sddmm import BLOCK
    from repro_torch.models.transformer import init_lm
    kernels = {"shift_conv2d": shift_conv2d, "spdmm": spdmm, "ddmm": ddmm,
               "knn": knn, "sddmm": sddmm,
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
