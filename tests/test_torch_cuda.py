"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU; run them
on one with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The file imports no JAX (the GPU machine has
none); it also holds the shapes and input makers the CPU parity tests in
``tests/test_torch_kernels.py`` share.

The masked-VIP graph is ``chip_smoke.vip_masked_graph``: the tests build
the same graph the smoke run times.

Tolerance: ``max|Δ| <= 1e-5 · max|plain|`` — fp32 accumulation in another
order; TF32 is switched off for the plain versions.  KNN indices must be
equal exactly: the kernel repeats the plain version's fp32 arithmetic; so
must a batched shift-conv and its per-image calls (same arithmetic order),
and SDDMM's dead tiles must be exactly 0.  Requests end to end:
``1e-4 · max|plain plan|``.  Flash attention in bf16: ``2^-7 · max|plain|``
— kernel and plain version both compute from the same bf16 inputs with
fp32 sums (the kernel's p in three bf16 parts, fp32-level) and round
once to bf16, so an element can differ by one bf16 ulp (2^-8 of itself)
where the two sums straddle a rounding boundary; rows with no live key
must be exactly 0.  Shift-conv and DDMM run 3xTF32 on the tensor cores,
fp32-level (~2^-21 of each product): the same ``1e-5``; a DDMM product
stacked along M must equal its per-sample products bit for bit (the plan's
chunks follow K and N only), and so must a second call (split-K adds its
partials in order).  SpDMM's rows entry: ``1e-6 · max|plain|`` (five
multiply-adds an output, in the twin's order but fused).
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm, launch_plan as ddmm_plan
from repro_torch.kernels.flash_attention import (MAX_D, flash_attention,
                                                 takes)
from repro_torch.kernels.knn import WARP_MAX_K, knn
from repro_torch.kernels.sddmm import BLOCK, live_tiles, sddmm
from repro_torch.kernels.shift_conv import launch_plan, shift_conv2d
from repro_torch.kernels.spdmm import spdmm, spdmm_rows

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import (attn_calls, knn_adversarial,  # noqa: E402
                        tree_to, vip_masked_graph, window_mask)

RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
DDMM_SHAPES = [(1, 256, 60), (33, 257, 129), (100, 70, 130), (64, 64, 64)]
ACTS = [None, "relu", "gelu", "silu", "tanh"]
SPDMM_SHAPES = [(25, 25, 5, 300), (33, 57, 7, 129), (64, 100, 3, 1),
                (8, 8, 8, 17)]
# Every distinct DDMM call of the paths (b1-b6, b6-dyn, b3-r50/r101 and
# vip-masked) as the runtime makes it: (M, K, N, y a transposed view (a
# VIP's xᵀ), bias handed to the kernel, act handed to the kernel).
# tests/test_torch_kernels.py checks the list against the compiled plans.
DDMM_PATH = [
    (26, 64, 400, False, True, "relu"), (26, 400, 26, True, False, None),
    (26, 26, 400, False, False, None), (26, 800, 400, False, True, "relu"),
    (26, 400, 5, False, True, None),                              # b1
    (80, 80, 300, False, False, None), (80, 300, 1024, False, False, None),
    (80, 80, 1024, False, False, None),
    (80, 1024, 2048, False, True, None), (80, 2048, 1, False, False, None),
    (196, 512, 196, True, False, None),                           # b2
    (196, 196, 512, False, False, None),           # b3, vip-masked
    (196, 512, 512, False, False, "relu"), (512, 196, 512, True, False, None),
    (512, 512, 196, False, False, None),
    (512, 196, 196, False, False, "relu"),                        # b3
    (1, 256, 60, False, True, None),                              # b4
    (16384, 48, 48, False, False, None), (1, 48, 10, False, True, None),
    (1024, 3, 64, False, True, "relu"), (1024, 64, 64, False, True, "relu"),
    (1024, 64, 128, False, True, "relu"),
    (1024, 128, 256, False, True, "relu"),
    (1024, 256, 1024, False, True, "relu"),
    (1, 1024, 40, False, True, None),                             # b6
]
# b4's ELL right_t products: (C·T, V) views of its (C, T, V) activations
SPDMM_ROWS = [64 * 150, 128 * 150, 128 * 75, 256 * 75, 256 * 38]
CONV_CASES = [
    # (c_in, H, W, k1, k2, c_out, stride, padding, groups, dilation)
    (3, 16, 25, 1, 1, 8, (1, 1), "SAME", 1, (1, 1)),
    (8, 20, 25, 9, 1, 8, (1, 1), "SAME", 1, (1, 1)),
    (8, 19, 25, 9, 1, 16, (2, 1), "SAME", 1, (1, 1)),
    (6, 12, 25, 3, 3, 10, (1, 1), "VALID", 1, (1, 1)),
    (6, 13, 25, 3, 3, 10, (2, 2), "VALID", 1, (1, 1)),
    (8, 14, 25, 3, 3, 12, (1, 1), "SAME", 2, (2, 2)),
    (8, 15, 25, 3, 2, 8, (2, 1), "VALID", 4, (1, 2)),
]
# Every distinct conv layer of b2 (ResNet-50 at 224x224) and b3-r50 (its
# output-stride-16 variant), SAME padding: (c_in, H, W, k1, k2, c_out,
# stride).  tests/test_torch_kernels.py checks the list against the plans.
RESNET_CONVS = [
    (3, 224, 224, 7, 7, 64, 2),
    (64, 56, 56, 1, 1, 256, 1), (64, 56, 56, 1, 1, 64, 1),
    (64, 56, 56, 3, 3, 64, 1), (256, 56, 56, 1, 1, 64, 1),
    (256, 56, 56, 1, 1, 512, 2), (256, 56, 56, 1, 1, 128, 1),
    (128, 56, 56, 3, 3, 128, 2), (128, 28, 28, 1, 1, 512, 1),
    (512, 28, 28, 1, 1, 128, 1), (128, 28, 28, 3, 3, 128, 1),
    (512, 28, 28, 1, 1, 1024, 2), (512, 28, 28, 1, 1, 256, 1),
    (256, 28, 28, 3, 3, 256, 2), (256, 14, 14, 1, 1, 1024, 1),
    (1024, 14, 14, 1, 1, 256, 1), (256, 14, 14, 3, 3, 256, 1),
    (1024, 14, 14, 1, 1, 2048, 2), (1024, 14, 14, 1, 1, 512, 1),
    (512, 14, 14, 3, 3, 512, 2), (512, 7, 7, 1, 1, 2048, 1),
    (2048, 7, 7, 1, 1, 512, 1), (512, 7, 7, 3, 3, 512, 1),
    # b3-r50 only (stage 4 stays at 14x14)
    (1024, 14, 14, 1, 1, 2048, 1), (512, 14, 14, 3, 3, 512, 1),
    (512, 14, 14, 1, 1, 2048, 1), (2048, 14, 14, 1, 1, 512, 1),
    (512, 14, 14, 1, 1, 19, 1),
]
# (n, f, k, masked points, self_loops, integer coordinates): b6-dyn's shape,
# exact ties, self loops, a ragged n, b7-dyn's shape, the largest k
KNN_CASES = [
    (1024, 3, 20, 64, False, False),
    (1024, 3, 20, 0, False, True),
    (1024, 3, 20, 0, True, False),
    (1000, 3, 20, 64, False, False),
    (196, 192, 9, 0, False, False),
    (70, 5, WARP_MAX_K, 30, False, False),
    (33, 40, 7, 5, False, True),
]


# (M, K, N, mask density): the reference's three shapes (tests/
# test_kernels.py), the masked VIP's, ragged edges, density 1 and 0
SDDMM_SHAPES = [(128, 64, 128, 0.2), (256, 128, 256, 0.05),
                (100, 50, 70, 0.4), (196, 512, 196, 0.1),
                (33, 17, 65, 0.3), (37, 1, 31, 1.0), (64, 40, 96, 0.0)]


# (B, Hq, Hkv, Sq, Sk, D, causal): tests/test_kernels.py's six flash cases
# (GQA, ragged, continuation, non-causal), its decode shape, and Sq > Sk
# causal cases whose first rows see no key
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True),
    (2, 8, 2, 128, 128, 64, True),
    (1, 2, 2, 100, 100, 32, True),
    (1, 4, 1, 64, 256, 64, True),
    (1, 2, 2, 128, 128, 64, False),
    (2, 2, 1, 77, 154, 48, False),
    (2, 4, 4, 1, 300, 64, True),
    (1, 4, 2, 8, 4, 32, True),
    (2, 4, 1, 40, 24, 64, True),
]
# qwen3-0.6b's served prefills (buckets 16-48) and a 2048-token prompt
FLASH_SERVED = [(1, 16, 8, s, s, 128, True) for s in (16, 32, 48, 2048)]
# bf16 on the tensor cores: 2048 tokens at D 64 and 128, GQA 16/8, causal
# and not; ragged Sq (77, 100) that leave partial 16-row MMA tiles, alone
# and as continuations (Sq < Sk)
FLASH_BF16 = ([(1, 16, 8, 2048, 2048, d, c) for d in (64, 128)
               for c in (True, False)]
              + [(1, 16, 8, 77, 77, 128, True), (1, 16, 8, 100, 100, 64, True),
                 (2, 4, 2, 77, 100, 128, True),
                 (1, 16, 8, 100, 300, 128, True)])

# Head dims off the bf16 kernel's instantiations (64, 128): D = 80 runs
# under DP = 128 with its columns 80-127 masked, at zamba2-2.7b's shared
# attention (32 heads of 80, no GQA; the served exact prompt lengths and a
# 2048-token prompt), and D = 96 at GQA, ragged and non-causal shapes
FLASH_PADDED_D = ([(1, 32, 32, s, s, 80, True) for s in (8, 29, 47, 2048)]
                  + [(2, 4, 2, 77, 100, 96, True),
                     (1, 8, 8, 64, 64, 96, False)])

# v's head dim apart from q's and k's: (B, Hq, Hkv, Sq, Sk, D, DV, causal).
# deepseek-v3's MLA at its 128 heads of (192, 128): the served buckets (16,
# 32, 48) and a 2048-token prompt, a continuation, rows with no live key
# (Sq > Sk), non-causal at a ragged length; then DV < D and DV > D under
# the smaller instantiations (MLA's smoke config's (24, 16))
FLASH_DV = ([(1, 128, 128, s, s, 192, 128, True) for s in (16, 32, 48, 2048)]
            + [(1, 16, 16, 64, 256, 192, 128, True),
               (2, 8, 8, 80, 48, 192, 128, True),
               (1, 8, 8, 100, 100, 192, 128, False),
               (2, 4, 4, 37, 37, 24, 16, True),
               (1, 4, 2, 77, 100, 64, 128, True)])


# The flash backward (dq, dk, dv) on the card: llama3.2-1b's training shape,
# qwen3-0.6b's 2048-token shape (D 128), non-causal, continuations (Sq <
# Sk), rows with no live key (Sq > Sk), a ragged D and a decode row; then
# D = 128 at lengths off the bf16 kernel's 64-row tiles: a continuation,
# non-causal, dead rows and a decode row
FLASH_BWD = [(8, 32, 8, 128, 128, 64, True), (1, 16, 8, 2048, 2048, 128, True),
             (2, 4, 2, 77, 100, 64, False), (1, 4, 1, 64, 256, 64, True),
             (2, 4, 1, 40, 24, 64, True), (2, 2, 1, 77, 154, 48, False),
             (1, 4, 4, 100, 100, 32, True), (2, 4, 4, 1, 300, 64, True),
             (2, 8, 2, 100, 163, 128, True), (1, 4, 2, 130, 130, 128, False),
             (2, 4, 1, 150, 90, 128, True), (1, 8, 8, 1, 200, 128, True)]


# The last four dense archs' attention: group 1 (MHA) under (128, 128) at
# codeqwen1.5-7b's 32/32 heads and under (64, 64) at musicgen-medium's
# 24/24, and qwen2-72b's and chameleon-34b's 64/8 heads of 128, at a served
# bucket and 2048 tokens; the backward at the training shapes (batch 8 x
# 128) and 64/8 at 256 tokens
FLASH_DENSE = [(1, 32, 32, 48, 48, 128, True),
               (1, 32, 32, 2048, 2048, 128, True),
               (1, 24, 24, 32, 32, 64, True),
               (1, 24, 24, 2048, 2048, 64, True),
               (1, 64, 8, 16, 16, 128, True),
               (1, 64, 8, 2048, 2048, 128, True)]
FLASH_DENSE_BWD = [(8, 24, 24, 128, 128, 64, True),
                   (8, 32, 32, 128, 128, 128, True),
                   (1, 64, 8, 256, 256, 128, True)]


def flash_inputs(b, hq, hkv, sq, sk, d, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv or d))]


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def t(a):
    return torch.from_numpy(np.array(a))


def ddmm_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((m, k)).astype(f),
            rng.standard_normal((k, n)).astype(f),
            rng.standard_normal(n).astype(f),
            rng.standard_normal((m, n)).astype(f))


def ell_inputs(s1, s2, ell_l, seed, out_of_range=False):
    """ELL with padding slots (val 0) whose idx points at real rows, or,
    with ``out_of_range``, some past the last row and some negative."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s2, (s1, ell_l)).astype(np.int32)
    val = rng.standard_normal((s1, ell_l)).astype(np.float32)
    pad = rng.random((s1, ell_l)) < 0.3
    val[pad] = 0.0
    assert (idx[pad] != 0).any()
    if out_of_range:
        idx[pad] = np.where(rng.random(pad.sum()) < 0.5, s2 + 3, -1)
    return idx, val


def ddmm_path_inputs(m, k, n, y_t, seed=0):
    """x, y (a transposed view of an (n, k) matrix where ``y_t``), bias
    and residual for one path shape."""
    x, y, b, r = ddmm_inputs(m, k, n, seed)
    if y_t:
        y = np.ascontiguousarray(y.T).T
    return x, y, b, r


def t_strided(a, device):
    """``a`` on ``device`` with ``a``'s own strides (a transposed view
    stays one)."""
    if a.flags.c_contiguous:
        return t(a).to(device)
    return t(np.ascontiguousarray(a.T)).to(device).T


def conv_inputs(cin, h, w, k1, k2, cout, groups, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((cin, h, w)).astype(np.float32),
            rng.standard_normal((k1, k2, cin // groups, cout))
            .astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", DDMM_SHAPES + [(1000, 700, 300)])
def test_cuda_ddmm_matches_plain(cuda, m, k, n, act):
    x, y, b, r = (t(a).to(cuda) for a in ddmm_inputs(m, k, n))
    before = ddmm.launches
    got = ddmm(x, y, bias=b, residual=r, act=act)
    torch.cuda.synchronize()
    assert ddmm.launches == before + 1
    close(got.cpu(), ref.ddmm_ref(x, y, bias=b, residual=r, act=act).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS + ["handed"])
@pytest.mark.parametrize("case", DDMM_PATH, ids=str)
def test_cuda_ddmm_path_shapes_match_plain(cuda, case, act):
    """Every path shape, both routes and both y layouts, with bias,
    residual and each act, and with the epilogue the runtime hands the
    kernel there ("handed"), within 1e-5 of max|out| of the plain
    version."""
    m, k, n, y_t, bias, handed = case
    x, y, b, r = (t_strided(a, cuda) for a in ddmm_path_inputs(m, k, n, y_t))
    assert y.is_contiguous() != y_t
    if act == "handed":
        act, b, r = handed, b if bias else None, None
    before = ddmm.launches
    got = ddmm(x, y, bias=b, residual=r, act=act)
    torch.cuda.synchronize()
    assert ddmm.launches == before + 1
    close(got.cpu(), ref.ddmm_ref(x, y, bias=b, residual=r, act=act).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in DDMM_PATH if c[0] <= 196]
                         + [(5, 403, 7, True, True, "relu")], ids=str)
def test_cuda_ddmm_stacked_m_equals_per_sample_bit_for_bit(cuda, case):
    """The plan's chunks follow K and N only: four samples stacked along M
    give each sample's product bit for bit (tile height 16 -> 64 included:
    the classifiers at M = 1 against M = 4, b1's 26 against 104)."""
    m, k, n, y_t, bias, act = case
    rng = np.random.default_rng(m + k + n)
    x = t(rng.standard_normal((4 * m, k)).astype(np.float32)).to(cuda)
    _, y, b, _ = (t_strided(a, cuda) for a in ddmm_path_inputs(1, k, n, y_t))
    b = b if bias else None
    got = ddmm(x, y, bias=b, act=act)
    each = torch.cat([ddmm(x[i * m:(i + 1) * m], y, bias=b, act=act)
                      for i in range(4)])
    torch.cuda.synchronize()
    assert torch.equal(got, each)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in DDMM_PATH
                                  if ddmm_plan(*c[:3]).split > 1], ids=str)
def test_cuda_ddmm_split_k_is_reproducible_bit_for_bit(cuda, case):
    """Split-K partials are added in chunk order inside the cluster, no
    atomics: a second call gives the first call's bits."""
    m, k, n, y_t, bias, act = case
    x, y, b, _ = (t_strided(a, cuda) for a in ddmm_path_inputs(m, k, n, y_t))
    b = b if bias else None
    first = ddmm(x, y, bias=b, act=act)
    again = ddmm(x, y, bias=b, act=act)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 256, 1024), (26, 800, 400),
                                   (26, 400, 5), (1, 1024, 40)])
def test_cuda_ddmm_relu_keeps_nan(cuda, m, k, n):
    """relu propagates NaN on both routes, as torch.relu and jax.nn.relu
    do; the other rows are untouched."""
    x, y, b, _ = (t(a).to(cuda) for a in ddmm_inputs(m, k, n))
    x[m // 2] = float("nan")
    got = ddmm(x, y, bias=b, act="relu")
    torch.cuda.synchronize()
    assert torch.isnan(got[m // 2]).all()
    keep = torch.arange(m, device=cuda) != m // 2
    assert torch.isfinite(got[keep]).all()
    if m > 1:
        close(got[keep].cpu(),
              ref.ddmm_ref(x, y, bias=b, act="relu")[keep].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(26, 400, 26), (512, 196, 512),
                                   (33, 257, 129), (5, 403, 7)])
def test_cuda_ddmm_reads_a_transposed_view(cuda, m, k, n):
    """y as xᵀ-style view (the VIP's gram) gives a contiguous copy's
    result within 1e-5, both routes, K not a multiple of 4 included."""
    x, y, _, _ = ddmm_inputs(m, k, n)
    xt = t(x).to(cuda)
    view = t(np.ascontiguousarray(y.T)).to(cuda).T
    got = ddmm(xt, view)
    copy = ddmm(xt, view.contiguous())
    torch.cuda.synchronize()
    close(got.cpu(), copy.cpu())
    close(got.cpu(), ref.ddmm_ref(xt, view).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("r", SPDMM_ROWS + [37, 4])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_cuda_spdmm_rows_matches_plain(cuda, r, out_of_range):
    """The rows entry at b4's (C·T, V) shapes (and ragged R) within 1e-6
    of max|out| of its twin; out-of-range padding slots add nothing."""
    idx, val = ell_inputs(25, 25, 5, seed=r, out_of_range=out_of_range)
    x2 = np.random.default_rng(r).standard_normal((r, 25)).astype(np.float32)
    args = [t(a).to(cuda) for a in (idx, val, x2)]
    before = spdmm_rows.launches
    got = spdmm_rows(*args)
    torch.cuda.synchronize()
    assert spdmm_rows.launches == before + 1 and got.shape == (r, 25)
    close(got.cpu(), ref.spdmm_rows_ref(*args).cpu(), rtol=1e-6)
    close(got.cpu(), ref.spdmm_rows_ref(*(a.cpu() for a in args)), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("s1,s2,ell_l,n", SPDMM_SHAPES + [(25, 25, 5, 19200)])
def test_cuda_spdmm_matches_plain(cuda, s1, s2, ell_l, n):
    idx, val = ell_inputs(s1, s2, ell_l, seed=s1)
    y = np.random.default_rng(1).standard_normal((s2, n)).astype(np.float32)
    args = [t(a).to(cuda) for a in (idx, val, y)]
    before = spdmm.launches
    got = spdmm(*args)
    torch.cuda.synchronize()
    assert spdmm.launches == before + 1
    close(got.cpu(), ref.spdmm_ref(*args).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES + [
    (256, 75, 25, 9, 1, 256, (2, 1), "SAME", 1, (1, 1))], ids=str)
def test_cuda_shift_conv_matches_plain(cuda, case):
    cin, h, w, k1, k2, cout, stride, padding, groups, dil = case
    x, wt = (t(a).to(cuda) for a in
             conv_inputs(cin, h, w, k1, k2, cout, groups))
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dil)
    before = shift_conv2d.launches
    got = shift_conv2d(x, wt, **kw)
    torch.cuda.synchronize()
    assert shift_conv2d.launches == before + 1
    close(got.cpu(), ref.conv2d_ref(x, wt, **kw).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", RESNET_CONVS, ids=str)
def test_cuda_shift_conv_resnet_layers_match_plain(cuda, case):
    """Every layer shape of b2 and b3-r50 (split-K active on the 7x7 and
    14x14 layers) within 1e-5 of the plain version: 3xTF32 is fp32-level."""
    cin, h, w, k1, k2, cout, stride = case
    x, wt = (t(a).to(cuda) for a in conv_inputs(cin, h, w, k1, k2, cout, 1))
    before = shift_conv2d.launches
    got = shift_conv2d(x, wt, stride=stride)
    torch.cuda.synchronize()
    assert shift_conv2d.launches == before + 1
    close(got.cpu(), ref.conv2d_ref(x, wt, stride=stride).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (1, 28, 28, 3, 3, 64, 1), (1, 128, 128, 3, 3, 48, 1),
    (3, 150, 25, 1, 1, 64, 1), (3, 33, 47, 3, 3, 20, 2),
    (3, 224, 224, 7, 7, 64, 2)], ids=str)
def test_cuda_shift_conv_one_or_three_input_channels(cuda, case):
    """K of 3 to 147: the K tile is mostly zero padding."""
    cin, h, w, k1, k2, cout, stride = case
    x, wt = (t(a).to(cuda) for a in conv_inputs(cin, h, w, k1, k2, cout, 1))
    got = shift_conv2d(x, wt, stride=stride)
    torch.cuda.synchronize()
    close(got.cpu(), ref.conv2d_ref(x, wt, stride=stride).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(512, 7, 7, 3, 3, 512, 1),
                                  (2048, 7, 7, 1, 1, 512, 1),
                                  (256, 28, 28, 3, 3, 256, 2)], ids=str)
def test_cuda_split_k_shift_conv_is_reproducible_bit_for_bit(cuda, case):
    """Split-K sums its partials in a fixed order, without atomics: two
    calls give the same bits, and a batch gives each image's bits."""
    cin, h, w, k1, k2, cout, stride = case
    assert launch_plan((cin, h, w), (k1, k2, cin, cout),
                       stride=stride).split > 1
    rng = np.random.default_rng(cin)
    x = t(rng.standard_normal((3, cin, h, w)).astype(np.float32)).to(cuda)
    wt = t(rng.standard_normal((k1, k2, cin, cout))
           .astype(np.float32)).to(cuda)
    got = shift_conv2d(x, wt, stride=stride)
    again = shift_conv2d(x, wt, stride=stride)
    first = shift_conv2d(x[0], wt, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got[0], first)


def sddmm_inputs(m, k, n, density, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((m, k)).astype(f),
            rng.standard_normal((k, n)).astype(f),
            (rng.random((m, n)) < density).astype(f))


def knn_inputs(n, f, masked, ints, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (n, f)) if ints else rng.standard_normal((n, f))
    mask = np.ones(n, np.float32)
    mask[n - masked:] = 0.0
    return x.astype(np.float32), mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", KNN_CASES, ids=str)
def test_cuda_knn_matches_plain_exactly(cuda, case):
    n, f, k, masked, self_loops, ints = case
    x, mask = (t(a).to(cuda) for a in knn_inputs(n, f, masked, ints))
    kw = dict(mask=mask if masked else None, self_loops=self_loops)
    before = knn.launches
    got = knn(x, k, **kw)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.knn_ref(x, k, **kw).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.knn_ref(x.cpu(), k, mask=None if not
                                              masked else mask.cpu(),
                                              self_loops=self_loops).numpy())


@pytest.mark.cuda
def test_cuda_knn_ceiling_matches_the_kernel(cuda):
    """The warp route's largest k is the wrapper's WARP_MAX_K; the next k
    takes the sort route instead of a refusal (the reference takes every
    k <= N) and equals the plain version; k > N and float64 raise."""
    from repro_torch.kernels import _build
    assert _build.library().repro_knn_warp_k() == WARP_MAX_K
    x = t(knn_inputs(WARP_MAX_K + 1, 3, 0, False)[0]).to(cuda)
    got = knn(x, WARP_MAX_K + 1)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.knn_ref(x.cpu(), WARP_MAX_K + 1).numpy())
    with pytest.raises(ValueError, match="out of range"):
        knn(x, WARP_MAX_K + 2)
    with pytest.raises(TypeError):
        knn(torch.zeros((10, 3), device=cuda, dtype=torch.float64), 3)


# (name, N, F, k): chip_smoke.knn_adversarial's orders and ties, k at both
# ends, N below a warp and off the block's rows, b7-dyn's (196, 192)
KNN_ADVERSARIAL = [
    ("rising", 1024, 3, 20), ("falling", 1024, 3, 20),
    ("rising", 1024, 3, WARP_MAX_K), ("equal", 1024, 3, 20),
    ("equal", 300, 3, WARP_MAX_K), ("masked", 1024, 3, 20),
    ("normal", 1024, 3, 1), ("normal", 1024, 3, WARP_MAX_K),
    ("normal", 20, 3, 5), ("normal", 1001, 3, 20),
    ("normal", 196, 192, 9)]                       # b7-dyn's patches


@pytest.mark.cuda
@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("case", KNN_ADVERSARIAL, ids=str)
def test_cuda_knn_adversarial_orders_match_plain_exactly(cuda, case,
                                                         self_loops):
    name, n, f, k = case
    x, mask = knn_adversarial(name, n, f, np.random.default_rng(0))
    x = t(x).to(cuda)
    kw = dict(mask=None if mask is None else t(mask).to(cuda),
              self_loops=self_loops)
    got = knn(x, k, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.knn_ref(x, k, **kw).cpu().numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        ref.knn_ref(x.cpu(), k, mask=None if mask is None else t(mask),
                    self_loops=self_loops).numpy())


# The sort route (k > WARP_MAX_K), (name, N, F, k): k up to N in every
# order, a mask leaving 5 candidates (k > 5: +inf keys in index order), N
# off a power of two, wide features, and N past the shared-memory row
# (16384 keys), whose keys go through the global scratch in row chunks
KNN_SORT = [
    ("normal", 1024, 3, 65), ("rising", 1024, 3, 128),
    ("falling", 1024, 3, 512), ("equal", 1024, 3, 1024),
    ("masked", 1024, 3, 128), ("normal", 1001, 3, 1001),
    ("normal", 200, 40, 80), ("normal", 16500, 3, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("case", KNN_SORT, ids=str)
def test_cuda_knn_sort_route_matches_plain_exactly(cuda, case, self_loops):
    name, n, f, k = case
    x, mask = knn_adversarial(name, n, f, np.random.default_rng(1))
    x = t(x).to(cuda)
    kw = dict(mask=None if mask is None else t(mask).to(cuda),
              self_loops=self_loops)
    before = knn.launches
    got = knn(x, k, **kw)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.knn_ref(x, k, **kw).cpu().numpy())


@pytest.mark.cuda
def test_cuda_knn_two_calls_are_bit_equal(cuda):
    x, mask = (t(a).to(cuda) for a in knn_inputs(1024, 3, 64, True))
    got, again = knn(x, 20, mask=mask), knn(x, 20, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 5), device=cuda)
    with pytest.raises(TypeError):
        ddmm(x.double(), torch.zeros((5, 6), device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        ddmm(torch.zeros((5, 4), device=cuda).T, torch.zeros((5, 6),
                                                            device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ddmm(x, torch.zeros((5, 12), device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="CUDA"):
        ddmm(x, torch.zeros((5, 6)))
    with pytest.raises(TypeError):
        spdmm_rows(torch.zeros((25, 5), device=cuda, dtype=torch.int64),
                   torch.zeros((25, 5), device=cuda),
                   torch.zeros((40, 25), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,density", SDDMM_SHAPES)
def test_cuda_sddmm_matches_plain(cuda, m, k, n, density):
    x, y, mask = (t(a).to(cuda) for a in sddmm_inputs(m, k, n, density))
    before = sddmm.launches
    got = sddmm(x, y, mask)
    got_t = sddmm(x, y.T.contiguous().T, mask)       # y as a strided view
    torch.cuda.synchronize()
    assert sddmm.launches == before + 2
    want = ref.sddmm_ref(x, y, mask)
    close(got.cpu(), want.cpu())
    assert torch.equal(got, got_t)
    assert (got[mask == 0] == 0).all()


@pytest.mark.cuda
def test_cuda_sddmm_dead_tiles_are_exactly_zero(cuda):
    x, y, _ = (t(a).to(cuda) for a in sddmm_inputs(256, 64, 256, 0.0))
    mask = torch.zeros((256, 256), device=cuda)
    mask[:128, :128] = 1.0
    got = sddmm(x, y, mask)
    torch.cuda.synchronize()
    assert live_tiles(mask).sum().item() == (128 // BLOCK) ** 2
    assert (got[128:] == 0).all() and (got[:, 128:] == 0).all()
    close(got.cpu(), ref.sddmm_ref(x, y, mask).cpu())


@pytest.mark.cuda
def test_cuda_sddmm_tile_matches_the_kernel(cuda):
    from repro_torch.kernels import _build
    assert _build.library().repro_sddmm_block() == BLOCK
    with pytest.raises(TypeError):
        sddmm(torch.zeros((4, 5), device=cuda), torch.zeros((5, 6),
                                                             device=cuda),
              torch.zeros((4, 6), device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,density", [(100, 4096, 70, 0.3),
                                           (33, 4096, 65, 0.05)])
def test_cuda_sddmm_split_k_matches_plain(cuda, m, k, n, density):
    """K = 4096 splits into 8 chunks of 16 stages, summed in order across
    a cluster: within RTOL of the plain version, the same bits on a second
    call and through a transposed view of y."""
    from repro_torch.kernels.sddmm import launch_plan as sddmm_plan
    assert sddmm_plan(m, k, n).split == 8
    x, y, mask = (t(a).to(cuda) for a in sddmm_inputs(m, k, n, density))
    got = sddmm(x, y, mask)
    again = sddmm(x, y, mask)
    got_t = sddmm(x, y.T.contiguous().T, mask)
    torch.cuda.synchronize()
    close(got.cpu(), ref.sddmm_ref(x, y, mask).cpu())
    assert torch.equal(got, again) and torch.equal(got, got_t)


@pytest.mark.cuda
def test_cuda_sddmm_dead_tiles_stay_zero_over_non_finite_inputs(cuda):
    """NaN in x's rows and inf in y's columns that only dead tiles read:
    those outputs are exactly 0 (the plain version gives NaN there)."""
    x, y, _ = sddmm_inputs(256, 64, 256, 0.0)
    x[160:200] = np.nan
    y[:, 130:250] = np.inf
    mask = np.zeros((256, 256), np.float32)
    mask[:128, :128] = (np.random.default_rng(1).random((128, 128))
                        < 0.3)
    got = sddmm(*(t(a).to(cuda) for a in (x, y, mask)))
    torch.cuda.synchronize()
    got = got.cpu()
    assert (got[128:] == 0).all() and (got[:, 128:] == 0).all()
    want = ref.sddmm_ref(t(x[:128]), t(y[:, :128]), t(mask[:128, :128]))
    close(got[:128, :128], want)


@pytest.mark.cuda
def test_cuda_sddmm_at_b3_spatial_window(cuda):
    """b3-r50's spatial branch as the masked VIP calls it: (196, 512)
    nodes, y = xᵀ (a view), each patch's 5x5 window on 14x14."""
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((196, 512)).astype(np.float32)).to(cuda)
    mask = t(window_mask(14, 5)).to(cuda)
    before = sddmm.launches
    got = sddmm(x, x.T, mask)
    again = sddmm(x, x.T.contiguous(), mask)
    torch.cuda.synchronize()
    assert sddmm.launches == before + 2
    close(got.cpu(), ref.sddmm_ref(x, x.T, mask).cpu())
    assert torch.equal(got, again)
    assert (got[mask == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (26, 1, 28, 28, 3, 3, 64, 1, "SAME", 1, (1, 1)),
    (26, 64, 7, 7, 3, 3, 64, 1, "SAME", 1, (1, 1)),
    (3, 8, 15, 25, 3, 2, 8, (2, 1), "VALID", 4, (1, 2)),
    # b2's 7x7 and 14x14 layers: split-K active
    (4, 512, 7, 7, 3, 3, 512, 1, "SAME", 1, (1, 1)),
    (3, 1024, 14, 14, 1, 1, 256, 1, "SAME", 1, (1, 1))], ids=str)
def test_cuda_batched_shift_conv_equals_per_image_calls(cuda, case):
    b, cin, h, w, k1, k2, cout, stride, padding, groups, dil = case
    rng = np.random.default_rng(b)
    x = t(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(cuda)
    wt = t(rng.standard_normal((k1, k2, cin // groups, cout))
           .astype(np.float32)).to(cuda)
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dil)
    before = shift_conv2d.launches
    got = shift_conv2d(x, wt, **kw)
    torch.cuda.synchronize()
    assert shift_conv2d.launches == before + 1
    each = torch.stack([shift_conv2d(x[i], wt, **kw) for i in range(b)])
    assert torch.equal(got, each)
    close(got.cpu(), ref.conv2d_ref(x, wt, **kw).cpu())


@pytest.mark.cuda
def test_cuda_b4_request_runs_through_the_kernels(cuda):
    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs
    from repro_torch.gnncv.tasks import build_task
    plan = compile_graph(build_task("b4"), CompileOptions(kernels="cuda"))
    plain = compile_graph(build_task("b4"), CompileOptions(kernels="torch"))
    inputs = random_inputs(plan, seed=0)
    counts = (shift_conv2d.launches, spdmm_rows.launches, ddmm.launches)
    got = build_runner(plan, jit=False)(**inputs)[0]
    torch.cuda.synchronize()
    assert (shift_conv2d.launches - counts[0],
            spdmm_rows.launches - counts[1],
            ddmm.launches - counts[2]) == (18, 9, 1)
    close(got.cpu(), build_runner(plain, jit=False)(**inputs)[0].cpu(),
          rtol=1e-4)


@pytest.mark.cuda
def test_cuda_b4_spdmm_runs_on_views_without_copies(cuda, monkeypatch):
    """A b4 request runs 9 SpDMM launches, each on the (C·T, V) view of
    its op's input, its result the op's output as a view: no transposing
    copy in or out."""
    import dataclasses

    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs
    from repro_torch.core.runtime import matmul
    from repro_torch.gnncv.tasks import build_task
    plan = compile_graph(build_task("b4"), CompileOptions(kernels="cuda"))
    ell = [op for op in plan.ops if op.kernel == "cuda_ell_spdmm"]
    calls = []
    real = matmul.spdmm_rows

    def recording(idx, val, x2):
        out = real(idx, val, x2)
        calls.append((x2.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(matmul, "spdmm_rows", recording)
    names = [n for op in ell for n in (op.inputs[0], op.name)]
    run = build_runner(dataclasses.replace(plan, outputs=names),
                       free_dead=False, jit=False)
    before = spdmm_rows.launches
    outs = run(**random_inputs(plan, seed=0))
    torch.cuda.synchronize()
    assert spdmm_rows.launches - before == len(calls) == len(ell) == 9
    for j, (x2_ptr, out_ptr) in enumerate(calls):
        assert outs[2 * j].data_ptr() == x2_ptr
        assert outs[2 * j + 1].data_ptr() == out_ptr


def dyn_request(n, seed, pad=64):
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0.0
    return dict(points=np.random.default_rng(seed).standard_normal(
        (n, 3)).astype(np.float32), mask=mask)


# the masked VIP's standard-normal 512-feature nodes have self-affinities
# near 512 against neighbours' ±23: scaled by 2^-4, as chip_smoke.py scales
# them, the masked softmax mixes each window instead of picking the diagonal
VIP_SCALE = np.float32(2.0 ** -4)


@pytest.mark.cuda
@pytest.mark.parametrize("task,counts", [
    ("b6-dyn", (0, 0, 6, 1, 0)), ("b6", (0, 0, 6, 0, 0)),
    ("b5", (2, 0, 3, 0, 0)), ("b1", (4, 0, 11, 0, 0)),
    ("vip-masked", (0, 0, 1, 0, 1))])
def test_cuda_request_runs_through_the_kernels(cuda, task, counts):
    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task

    def graph():
        if task == "vip-masked":
            return vip_masked_graph(GraphBuilder)
        return (build_dynamic_task if task == "b6-dyn" else build_task)(task)

    plan = compile_graph(graph(), CompileOptions(kernels="cuda"))
    plain = compile_graph(graph(), CompileOptions(kernels="torch"))
    inputs = (dyn_request(1024, seed=0) if task == "b6-dyn"
              else random_inputs(plan, seed=0))
    if task == "vip-masked":
        inputs = {"nodes": inputs["nodes"] * VIP_SCALE}
    fns = (shift_conv2d, spdmm_rows, ddmm, knn, sddmm)
    before = [fn.launches for fn in fns]
    got = build_runner(plan, jit=False)(**inputs)[0]
    torch.cuda.synchronize()
    assert tuple(fn.launches - b for fn, b in zip(fns, before)) == counts
    if task == "vip-masked":                   # the softmax mixes neighbours
        nodes = inputs["nodes"]
        assert np.abs(got.cpu().numpy() - nodes).max() > \
            0.1 * np.abs(nodes).max()
    close(got.cpu(), build_runner(plain, jit=False)(**inputs)[0].cpu(),
          rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("model,ddmm_per_request", [
    ("g1_gcn", 2), ("g2_sage", 4), ("g3_gat", 2)])
def test_cuda_gnn_zoo_runs_through_the_kernels(cuda, model,
                                               ddmm_per_request):
    """g1-g3 on the reference test's mini graph (128 nodes, 512 edges, 32
    features, 7 classes): every linear through the DDMM kernel, the output
    within 1e-4 of the plain plan's, the graph replay equal to the eager
    run bit for bit."""
    from repro_torch import gcv
    from repro_torch.gnncv import GNN_ZOO
    from repro_torch.gnncv.graphs import GraphSpec
    graph = GNN_ZOO[model](GraphSpec("mini", 128, 512, 32, 7))
    m, plain = (gcv.compile(graph, kernels=k) for k in ("cuda", "torch"))
    feats = {"features": np.random.default_rng(1).standard_normal(
        (128, 32)).astype(np.float32)}
    before = ddmm.launches
    eager = m.runner(jit=False)(**feats)[0]
    torch.cuda.synchronize()
    assert ddmm.launches - before == ddmm_per_request
    assert eager.shape == (128, 7) and torch.isfinite(eager).all()
    close(eager.cpu(), plain.run(**feats)[0].cpu(), rtol=1e-4)
    m.warmup()
    assert torch.equal(m.run(**feats)[0], eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_SERVED + FLASH_DENSE,
                         ids=str)
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    b, hq, hkv, sq, sk, d, causal = case
    q, k, v = (t(a).to(cuda, dtype) for a in flash_inputs(*case[:6]))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal)
    close(got.float().cpu(), want.float().cpu(),
          rtol=RTOL if dtype == torch.float32 else BF16_RTOL)
    if causal and sq > sk:
        assert (got[:, :, :sq - sk] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16, ids=str)
def test_cuda_flash_attention_bf16_tensor_cores_match_plain(cuda, case):
    """The bf16 tensor-core kernel at 2048 tokens (D 64 and 128, causal and
    not) and at ragged Sq, within BF16_RTOL of the plain version."""
    b, hq, hkv, sq, sk, d, causal = case
    q, k, v = (t(a).to(cuda, torch.bfloat16)
               for a in flash_inputs(*case[:6], seed=sq + d))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=causal)
    close(got.float().cpu(), want.float().cpu(), rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_PADDED_D, ids=str)
def test_cuda_flash_attention_padded_head_dims_match_plain(cuda, case,
                                                           dtype):
    """D = 80 (zamba2's shared attention) and D = 96 launch the kernel
    instantiated for the next size up, within the flash tolerances."""
    b, hq, hkv, sq, sk, d, causal = case
    q, k, v = (t(a).to(cuda, dtype)
               for a in flash_inputs(*case[:6], seed=sq + d))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.attention_ref(q, k, v, causal=causal)
    close(got.float().cpu(), want.float().cpu(),
          rtol=RTOL if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_DV, ids=str)
def test_cuda_flash_attention_with_its_own_v_head_dim_matches_plain(
        cuda, case, dtype):
    """v's head dim apart from q's: MLA's (192, 128) instantiation at
    deepseek-v3's shapes, and DV != D under (64, 64) and (128, 128); one
    launch, output ``(B, Hq, Sq, DV)``, within the flash tolerances; rows
    with no live key exactly 0."""
    b, hq, hkv, sq, sk, d, dv, causal = case
    q, k, v = (t(a).to(cuda, dtype)
               for a in flash_inputs(b, hq, hkv, sq, sk, d, seed=sq + d,
                                     dv=dv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, sq, dv)
    want = ref.attention_ref(q, k, v, causal=causal)
    close(got.float().cpu(), want.float().cpu(),
          rtol=RTOL if dtype == torch.float32 else BF16_RTOL)
    if causal and sq > sk:
        assert (got[:, :, :sq - sk] == 0).all()


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_dqk_apart_from_dv(cuda):
    """The backward takes the forward's head-dim pairs (``MAX_D_BWD``, the
    library's ``repro_flash_bwd_takes``), MLA's (192, 128) and DV != D
    within them; a q·k or v head dim past every pair raises ``ValueError``
    naming the pairs, launching nothing (the plain version takes any pair
    on CPU tensors)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (MAX_D_BWD,
                                                     flash_attention_bwd)
    lib = _build.library()
    assert all(bool(lib.repro_flash_bwd_takes(d, dv))
               == takes(d, dv, MAX_D_BWD)
               for d in range(0, 260, 4) for dv in range(0, 260, 4))
    before = flash_attention_bwd.launches
    for d, dv in ((192, 136), (200, 128), (192, 192)):
        q, k, v = (t(a).to(cuda, torch.bfloat16)
                   for a in flash_inputs(1, 4, 4, 16, 16, d, dv=dv))
        out = torch.zeros((1, 4, 16, dv), device=cuda, dtype=torch.bfloat16)
        lse = torch.zeros((1, 4, 16), device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))
    assert flash_attention_bwd.launches == before


# The backward with v's head dim apart from q's: deepseek-v3's training
# shape (batch 8 x 128 tokens, 128 heads of (192, 128)) and a 2048-token
# prompt, a continuation, rows with no live key, non-causal at a ragged
# length, GQA; then DV != D under (64, 64) and (128, 128) (MLA's smoke
# config's (24, 16)) and zamba2's D = 80 under DP = 128
FLASH_BWD_DV = [(8, 128, 128, 128, 128, 192, 128, True),
                (1, 128, 128, 2048, 2048, 192, 128, True),
                (1, 16, 16, 64, 256, 192, 128, True),
                (2, 8, 8, 80, 48, 192, 128, True),
                (1, 8, 8, 100, 100, 192, 128, False),
                (2, 8, 2, 77, 130, 192, 128, True),
                (2, 4, 4, 37, 37, 24, 16, True),
                (1, 4, 2, 77, 100, 64, 128, True),
                (1, 32, 32, 128, 128, 80, 80, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD_DV, ids=str)
def test_cuda_flash_bwd_with_its_own_v_head_dim_matches_plain(cuda, case,
                                                              dtype):
    """dq, dk, dv at (D, DV) pairs apart (MLA's (192, 128) among them), with
    v and the grads' v side read as MLA holds them: v a strided view of the
    decompressed kv ``(B, S, H, nope + DV)`` and k's nope part beside it;
    within RTOL (fp32) or BF16_RTOL (bf16) of ``attention_bwd_ref``, a
    second call bit for bit, dv laid out as ``torch.empty_like(v)``."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    b, hq, hkv, sq, sk, d, dv, causal = case
    rng = np.random.default_rng(sq + d)
    q = t(rng.standard_normal((b, sq, hq, d)).astype(np.float32)).to(
        cuda, dtype).transpose(1, 2)
    kv = t(rng.standard_normal((b, sk, hkv, d + dv)).astype(np.float32)).to(
        cuda, dtype)
    k, v = (x.transpose(1, 2) for x in (kv[..., :d], kv[..., d:]))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    dout = t(rng.standard_normal(out.shape).astype(np.float32)).to(cuda,
                                                                   dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert got[2].stride() == torch.empty_like(v).stride()
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all() and torch.equal(g, a)
        close(g.float().cpu(), w.float().cpu(), rtol=rtol)
    if causal and sq > sk:
        assert (got[0][:, :, :sq - sk] == 0).all()


@pytest.mark.cuda
def test_cuda_wide_dot_keeps_the_fp32_product(cuda):
    """``layers.dot`` of bf16 operands on the card (cuBLAS, fp32 out):
    within 1e-5 of max| of the widened fp32 product (the sums' order), a
    2-D weight and a stack of experts; its grads (the fp32 cotangent in two
    bf16 parts) within one bf16 step (2^-8 of max|want|) of the widened
    product's grads, which round the same fp32 sums once."""
    from repro_torch.models.layers import dot
    rng = np.random.default_rng(0)
    for xs, ws in (((4, 96, 512), (512, 384)), ((80, 256), (4, 256, 192))):
        x, w = (t(rng.standard_normal(s).astype(np.float32)).to(
            cuda, torch.bfloat16).requires_grad_(True) for s in (xs, ws))
        got = dot(x, w)
        x32, w32 = (a.detach().float().requires_grad_(True) for a in (x, w))
        want = torch.matmul(x32, w32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        close(got.detach().cpu(), want.detach().cpu(), rtol=1e-5)
        g = t(rng.standard_normal(want.shape).astype(np.float32)).to(cuda)
        dx, dw = torch.autograd.grad(got, (x, w), g)
        wx, ww = torch.autograd.grad(want, (x32, w32), g)
        for a, b in ((dx, wx), (dw, ww)):
            assert a.dtype == torch.bfloat16
            close(a.float().cpu(), b.to(torch.bfloat16).float().cpu(),
                  rtol=2.0 ** -8)


@pytest.mark.cuda
def test_cuda_moe_smoke_serve_runs_through_the_kernel(cuda):
    """deepseek-v3's and grok-1's fp32 smoke configs served on the card:
    every prefill launches the kernel once per layer (MLA at (24, 16));
    the served tokens equal greedy decoding of the plain path's full
    forward."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serve import ServeEngine
    for arch in ("deepseek-v3-671b", "grok-1-314b"):
        cfg = configs.get_smoke(arch)
        params = init_lm(0, cfg, device="cuda")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 9, 20)]
        eng = ServeEngine(cfg, params, slots=2, max_len=64)
        before = flash_attention.launches
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        assert flash_attention.launches - before == \
            len(prompts) * cfg.n_layers
        for r in reqs:
            toks = torch.as_tensor(np.concatenate([r.prompt, r.out[:-1]]),
                                   device=cuda)
            logits, aux = lm_forward(params, cfg, toks[None], impl="naive")
            assert aux.item() > 0
            assert r.out == logits[0, len(r.prompt) - 1:].argmax(-1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["tri", "chunked_scan"])
@pytest.mark.parametrize("shape", [(2, 64, 8, 2, 32, 16),
                                   (1, 2048, 32, 32, 128, 512)], ids=str)
def test_cuda_plain_attention_cores_match_naive(cuda, shape, impl):
    """The plain ``tri`` and ``chunked_scan`` cores on the card in fp32
    (several chunks; codeqwen1.5-7b's heads at 2048 tokens), causal,
    within RTOL of the naive core; a continuation (Sq < Sk) too."""
    from repro_torch.models.attention import ATTN_IMPLS, naive_attention
    b, s, hq, hkv, d, chunk = shape
    rng = np.random.default_rng(s)
    q, k, v = (t(rng.standard_normal(sh).astype(np.float32)).to(cuda)
               for sh in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    core = ATTN_IMPLS[impl]
    with torch.no_grad():
        for qs, off in ((q, 0), (q[:, s // 2:], s // 2)):
            got = core(qs, k, v, causal=True, offset=off)
            want = naive_attention(qs, k, v, causal=True, offset=off)
            assert got.shape == want.shape and got.device == q.device
            close(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-72b", "codeqwen1.5-7b",
                                  "chameleon-34b", "musicgen-medium"])
def test_cuda_dense_smoke_serve_runs_through_the_kernel(cuda, arch):
    """The last four dense archs' fp32 smoke configs on the card: every
    served prefill launches the kernel once a layer and the tokens equal
    greedy decoding of the plain path's full forward; chameleon's and
    musicgen's prefill from embeddings through the kernel within 1e-4 of
    the plain path's, and a decode step from it at each row's length."""
    from repro_torch import configs
    from repro_torch.data import synthetic_embeds
    from repro_torch.models.transformer import (init_lm, lm_decode_step,
                                                lm_forward, lm_prefill)
    from repro_torch.serve import ServeEngine
    cfg = configs.get_smoke(arch)
    params = init_lm(0, cfg, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 9, 20)]
    eng = ServeEngine(cfg, params, slots=2, max_len=64)
    before = flash_attention.launches
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    assert flash_attention.launches - before == len(prompts) * cfg.n_layers
    for r in reqs:
        toks = torch.as_tensor(np.concatenate([r.prompt, r.out[:-1]]),
                               device=cuda)
        logits, _ = lm_forward(params, cfg, toks[None], impl="naive")
        assert r.out == logits[0, len(r.prompt) - 1:].argmax(-1).tolist()
    if cfg.embed_inputs:
        return
    x = synthetic_embeds(3, 2, 16, cfg.d_model, device=cuda)
    last = torch.tensor([9, 15], device=cuda)
    runs = []
    for impl in ("chunked", "naive"):
        before = flash_attention.launches
        logits, cache, length = lm_prefill(params, cfg, embeds=x, max_len=32,
                                           impl=impl, last_index=last)
        launched = flash_attention.launches - before
        step, _ = lm_decode_step(params, cfg, logits.argmax(-1), cache,
                                 length)
        runs.append((logits, step, launched))
    (lk, sk, nk), (lp, sp, npl) = runs
    assert (nk, npl) == (cfg.n_layers, 0)
    close(lk.cpu(), lp.cpu(), rtol=1e-4)
    close(sk.cpu(), sp.cpu(), rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_misaligned_bf16_views(cuda):
    """bf16 k/v/q rows go through 16-byte copies: a base or a stride off a
    16-byte boundary raises; nothing is copied and nothing falls back."""
    wide = torch.zeros((1, 2, 8, 40), device=cuda, dtype=torch.bfloat16)
    odd = torch.zeros((1, 2, 8, 36), device=cuda, dtype=torch.bfloat16)
    ok = wide[..., :32]                      # rows 80 bytes apart: aligned
    before = flash_attention.launches
    for bad in (wide[..., 1:33], odd[..., :32]):
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(bad, ok, ok)
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(ok, bad, ok)
    assert flash_attention.launches == before
    flash_attention(ok, ok, ok)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_attention_reads_permuted_views(cuda, dtype):
    """(B, S, H, D) activations passed as permuted views give the same bits
    as contiguous copies, and the output keeps q's layout."""
    rng = np.random.default_rng(5)
    q, k, v = (t(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
               for s in ((2, 48, 16, 128), (2, 48, 8, 128), (2, 48, 8, 128)))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    got = flash_attention(*views)
    copies = flash_attention(*(a.contiguous() for a in views))
    torch.cuda.synchronize()
    assert torch.equal(got, copies)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import _build
    lib = _build.library()
    assert all(bool(lib.repro_flash_takes(d, dv)) == takes(d, dv)
               for d in range(0, 260, 4) for dv in range(0, 260, 4))
    for d, dv in ((MAX_D[-1][0] + 8, 64), (64, MAX_D[-1][1] + 8)):
        z = torch.zeros((1, 2, 8, d), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(z, z, torch.zeros((1, 2, 8, dv), device=cuda))
    h = torch.zeros((1, 2, 8, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    q = torch.zeros((1, 2, 8, 32), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                        q, q)


@pytest.mark.cuda
def test_cuda_smoke_serve_runs_through_the_kernel(cuda):
    """Every prefill launches the kernel once per layer; the served tokens
    equal greedy decoding of the plain path's full forward (fp32 smoke
    config)."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serve import ServeEngine
    cfg = configs.get_smoke("qwen3-0.6b")
    params = init_lm(0, cfg, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 9, 12, 7, 20)]
    eng = ServeEngine(cfg, params, slots=3, max_len=64)
    before = flash_attention.launches
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    assert flash_attention.launches - before == len(prompts) * cfg.n_layers
    for r in reqs:
        toks = torch.as_tensor(np.concatenate([r.prompt, r.out[:-1]]),
                               device=cuda)
        logits, _ = lm_forward(params, cfg, toks[None], impl="naive")
        assert r.out == logits[0, len(r.prompt) - 1:].argmax(-1).tolist()



@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_cuda_recurrent_smoke_engines_give_the_cpu_tokens(cuda, arch):
    """The smoke zamba2 and xlstm (fp32) served on the card emit the CPU
    port's tokens from the same weights; zamba2's prefills launch the
    flash kernel once per shared-block application, xlstm's none."""
    from repro_torch import configs
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ServeEngine
    cfg = configs.get_smoke(arch)
    params = init_lm(0, cfg, device="cpu")
    on_card = tree_to(params, cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 9, 12, 7, 20)]
    outs = []
    for p in (params, on_card):
        eng = ServeEngine(cfg, p, slots=3, max_len=64)
        before = flash_attention.launches
        reqs = [eng.submit(x, max_new=6) for x in prompts]
        eng.run()
        launched = flash_attention.launches - before
        outs.append([r.out for r in reqs])
    n_apps = (cfg.n_layers // cfg.shared_attn_every
              if cfg.shared_attn_every else 0)
    assert launched == len(prompts) * n_apps
    assert outs[1] == outs[0]

# ------------------------------------ CUDA graphs and batched execution --
# Small configs of every GNN-CV path: the graph runner equals the eager
# runner, and a batch equals its per-sample runs, bit for bit (the kernels'
# launch plans follow the per-sample problem; the other ops loop per
# sample or compute each element as its per-sample call does).
GRAPH_TASKS = ["b1", "b2", "b3-r50", "b4", "b5", "b6", "b6-dyn",
               "vip-masked"]


def small_plan(task):
    from repro_torch.core import CompileOptions, compile_graph
    from repro_torch.core.ir import GraphBuilder
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task
    if task == "vip-masked":
        graph = vip_masked_graph(GraphBuilder, side=8, feat=16, win=3)
    elif task == "b6-dyn":
        graph = build_dynamic_task(task, small=True)
    else:
        graph = build_task(task, small=True)
    return compile_graph(graph, CompileOptions(kernels="cuda"))


def small_requests(task, plan, n):
    from repro_torch.core.executor import random_inputs
    if task == "b6-dyn":
        pts = plan.meta["input_shapes"]["points"][0]
        return [dyn_request(pts, seed=s, pad=pts // 16) for s in range(n)]
    reqs = [random_inputs(plan, seed=s) for s in range(n)]
    if task == "vip-masked":
        reqs = [{"nodes": r["nodes"] * np.float32(0.25)} for r in reqs]
    return reqs


def assert_equal_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("task", GRAPH_TASKS)
def test_cuda_graph_runner_equals_eager_bit_for_bit(cuda, task):
    from repro_torch.core import build_runner
    plan = small_plan(task)
    eager, graph = build_runner(plan, jit=False), build_runner(plan)
    assert graph.jit and not eager.jit
    for req in small_requests(task, plan, 3):
        assert_equal_outputs(graph(**req), eager(**req))
    assert graph.trace_count() == 1 and eager.trace_count() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("task", GRAPH_TASKS)
def test_cuda_graph_records_the_launches_of_one_eager_request(cuda, task):
    """``<fn>.captured``, counted where each wrapper launches its kernel,
    gives the launches a graph records: those of one eager request."""
    from repro_torch import kernels as K
    from repro_torch.core import build_runner
    plan = small_plan(task)
    req = small_requests(task, plan, 1)[0]
    fns = [K.shift_conv2d, K.ddmm, K.spdmm, K.spdmm_rows, K.knn, K.sddmm]
    eager = build_runner(plan, jit=False)
    eager(**req)
    for fn in fns:
        fn.launches = fn.captured = 0
    eager(**req)
    walked = [fn.launches for fn in fns]
    assert sum(walked) > 0 and not any(fn.captured for fn in fns)
    graph = build_runner(plan)
    for fn in fns:
        fn.captured = 0
    assert graph.aot_compile() is not None
    assert [fn.captured for fn in fns] == walked


@pytest.mark.cuda
@pytest.mark.parametrize("task", GRAPH_TASKS)
def test_cuda_batch_equals_per_sample_runs_bit_for_bit(cuda, task):
    from repro_torch.core import build_runner
    from repro_torch.core.executor import stack_inputs
    plan = small_plan(task)
    reqs = small_requests(task, plan, 4)
    one = build_runner(plan, jit=False)
    singles = [one(**r) for r in reqs]
    for jit in (False, True):
        batched = build_runner(plan, batch=4, jit=jit)(**stack_inputs(reqs))
        for j, out in enumerate(batched):
            for i in range(4):
                assert torch.equal(out[i], singles[i][j]), (jit, i, j)


def replica_mesh():
    """Every card, or two replicas on cuda:0 where there is one."""
    from repro_torch.launch.mesh import make_data_mesh
    n = torch.cuda.device_count()
    return make_data_mesh(n if n > 1 else [torch.device("cuda", 0)] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("task", GRAPH_TASKS)
def test_cuda_sharded_batch_equals_per_sample_runs_bit_for_bit(cuda, task):
    """A batch split over the mesh's replicas (each a graph of its rows, on
    its stream) equals the per-sample runs bit for bit, one capture per
    replica."""
    from repro_torch.core import build_runner
    from repro_torch.core.executor import stack_inputs
    plan = small_plan(task)
    mesh = replica_mesh()
    n = 2 * mesh.size
    reqs = small_requests(task, plan, n)
    one = build_runner(plan, jit=False)
    singles = [one(**r) for r in reqs]
    run = build_runner(plan, batch=n, mesh=mesh)
    assert run.jit and run.mesh == mesh and run.resident.replicas == mesh.size
    for _ in range(2):
        for j, out in enumerate(run(**stack_inputs(reqs))):
            assert out.device == mesh.devices[0]
            for i in range(n):
                assert torch.equal(out[i], singles[i][j]), (i, j)
    assert [r.trace_count() for r in run.replicas] == [1] * mesh.size


@pytest.mark.cuda
def test_cuda_sharded_serve_equals_batch_1_runs(cuda):
    from repro_torch import gcv
    from repro_torch.gnncv.tasks import build_task
    graphs = {t: build_task(t, small=True) for t in ("b4", "b6")}
    mesh = replica_mesh()
    eng = gcv.serve(graphs, mesh=mesh, max_batch=8, warmup=True)
    assert eng.stats()["warmed"] == len(graphs) * len(eng.buckets())
    one = {t: gcv.compile(graphs[t]) for t in graphs}
    reqs = []
    for k in range(11):
        t = ("b4", "b6")[k % 2]
        ins = small_requests(t, one[t].plan, k // 2 + 1)[-1]
        reqs.append(eng.submit(t, **ins))
    assert eng.run() == len(reqs)
    for r in reqs:
        for got, want in zip(r.result, one[r.task].run(**r.inputs)):
            assert np.array_equal(got, want.cpu().numpy()), r.task
    st = eng.stats()
    assert st["devices"] == mesh.size
    assert sum(st["pad_per_device"]) == st["padded"]


@pytest.mark.cuda
def test_cuda_launch_on_a_card_not_current_raises(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    x = torch.randn(8, 8, device="cuda:1")
    with torch.cuda.device(0), pytest.raises(RuntimeError,
                                             match="current device"):
        ddmm(x, x)
    with torch.cuda.device(1):
        assert torch.equal(ddmm(x, x), ddmm(x, x))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["b7", "b7-dyn"])
def test_cuda_traced_vig_runs_through_the_kernels(cuda, task):
    """b7 and b7-dyn at their small configs, traced by ``gcv.compile(fn,
    example)`` on the card: their launches per request, the plain plan
    within 1e-4, graph == eager and batch 4 == batch 1 bit for bit, and
    b7-dyn's KNN indices equal to ``knn_ref`` on the same embeddings."""
    import dataclasses

    from repro_torch import gcv
    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs, stack_inputs
    from repro_torch.gnncv.torch_tasks import (TRACED_SMALL_CONFIGS,
                                               TRACED_TASKS)
    cfg = TRACED_SMALL_CONFIGS[task]
    model = gcv.compile(*TRACED_TASKS[task](**cfg))
    assert model.device.type == "cuda"
    assert model.plan.meta["frontend"] == "tracer"
    plain = compile_graph(model.graph, CompileOptions(kernels="torch"))
    reqs = [random_inputs(model.plan, seed=s) for s in range(4)]
    fns = (shift_conv2d, spdmm_rows, ddmm, knn, sddmm)
    eager = build_runner(model.plan, jit=False)
    before = [fn.launches for fn in fns]
    singles = [eager(**r) for r in reqs]
    torch.cuda.synchronize()
    per_request = (1, 0, 4 * cfg["blocks"] + 1, int(task == "b7-dyn"), 0)
    assert tuple(fn.launches - b for fn, b in zip(fns, before)) == \
        tuple(4 * n for n in per_request)
    run_plain = build_runner(plain, jit=False)
    for r, out in zip(reqs, singles):
        close(out[0].cpu(), run_plain(**r)[0].cpu(), rtol=1e-4)
        assert_equal_outputs(model.run(**r), out)
    for jit in (False, True):
        batched = model.batched(4, jit=jit)(**stack_inputs(reqs))
        for j, out in enumerate(batched):
            for i in range(4):
                assert torch.equal(out[i], singles[i][j]), (jit, i, j)
    if task == "b7-dyn":
        op = next(o for o in model.plan.ops if o.kind == "knn_graph")
        probe = build_runner(dataclasses.replace(
            model.plan, outputs=[op.inputs[0], op.name]), free_dead=False,
            jit=False)
        for r in reqs:
            h, idx = probe(**r)
            assert torch.equal(idx, ref.knn_ref(h, cfg["knn"]))


@pytest.mark.cuda
def test_cuda_graph_outputs_are_copies(cuda):
    from repro_torch.core import build_runner
    plan = small_plan("b6")
    run = build_runner(plan)
    a_req, b_req = small_requests("b6", plan, 2)
    a = run(**a_req)[0]
    kept = a.clone()
    b = run(**b_req)[0]
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, kept) and not torch.equal(a, b)
    assert torch.equal(b, build_runner(plan, jit=False)(**b_req)[0])


@pytest.mark.cuda
def test_cuda_graph_reads_swaps_in_place_and_recaptures_once_to_unalias(
        cuda):
    from repro_torch.core import build_runner, compile_graph
    from repro_torch.core.ir import GraphBuilder
    rng = np.random.default_rng(1)
    w1, w2 = (rng.standard_normal((8, 8)).astype(np.float32)
              for _ in range(2))
    b = GraphBuilder("alias_swap")
    x = b.input((4, 8), name="x")
    h = b.linear(x, w1, b=np.zeros(8, np.float32), name="l1")
    h = b.linear(h, w2, b=np.zeros(8, np.float32), name="l2")
    plan = compile_graph(b.output(h))
    req = {"x": rng.standard_normal((4, 8)).astype(np.float32)}
    run = build_runner(plan)
    assert run.aot_compile() is not None and run.trace_count() == 1
    base = run(**req)[0]
    eager = build_runner(plan, jit=False)
    run.resident.swap("l2", "w", w2 * 2.0)               # in place
    eager.resident.swap("l2", "w", w2 * 2.0)
    got = run(**req)[0]
    assert not torch.equal(got, base)
    assert torch.equal(got, eager(**req)[0]) and run.trace_count() == 1
    delta = np.full(8, 0.5, np.float32)
    run.resident.swap("l1", "b", delta)                  # un-aliases
    eager.resident.swap("l1", "b", delta)
    assert run.resident.slots[("l1", "b")] != run.resident.slots[("l2", "b")]
    assert torch.equal(run(**req)[0], eager(**req)[0])
    assert run.trace_count() == 2
    run(**req)
    assert run.trace_count() == 2


@pytest.mark.cuda
def test_cuda_trace_count_is_frozen_after_aot_compile(cuda):
    from repro_torch.core import build_runner
    from repro_torch.core.executor import stack_inputs
    plan = small_plan("b6")
    for batch in (None, 4):
        run = build_runner(plan, batch=batch, jit=True)
        g = run.aot_compile()
        assert g is not None and run.trace_count() == 1
        reqs = small_requests("b6", plan, 4)
        for _ in range(3):
            run(**(stack_inputs(reqs) if batch else reqs[0]))
        assert run.trace_count() == 1 and run.aot_compile() is g


@pytest.mark.cuda
def test_cuda_coo_sums_give_the_same_bits_every_call(cuda):
    """b5's COO sums (and the segment sum alone) give one result over 10
    calls and across batch sizes: the row order fixes the order of
    addition, where ``index_add_``'s atomics changed it run to run."""
    from repro_torch.core import build_runner
    from repro_torch.core.executor import stack_inputs
    from repro_torch.core.runtime.elementwise import segment_sum
    from repro_torch.core.runtime.residency import host_row_order
    plan = small_plan("b5")
    reqs = small_requests("b5", plan, 4)
    run = build_runner(plan, jit=False)
    first = run(**reqs[0])[0]
    for _ in range(9):
        assert torch.equal(run(**reqs[0])[0], first)
    for batch in (2, 4):
        out = build_runner(plan, batch=batch, jit=False)(
            **stack_inputs(reqs[:batch]))[0]
        assert torch.equal(out[0], first)
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 500, 20000).astype(np.int32)
    perm, lengths = (torch.from_numpy(a).to(cuda)
                     for a in host_row_order(seg, 500))
    for width in ((), (48,)):
        x = torch.from_numpy(rng.standard_normal((20000, *width)).astype(
            np.float32)).to(cuda)[perm]
        want = segment_sum(x, lengths)
        for _ in range(9):
            assert torch.equal(segment_sum(x, lengths), want)
        close(want.cpu(), segment_sum(x.cpu(), lengths.cpu()), rtol=1e-6)


# --------------------------------------------- the GNN-CV serving engine --
def small_engine(tasks, **kw):
    """A ``gcv.serve`` engine on the card over small plans, warmed."""
    from repro_torch import gcv
    return gcv.serve({t: small_plan(t) for t in tasks}, max_batch=4,
                     warmup=True, **kw)


def hold_stream(eng, ms: float = 200.0):
    """Keep the engine's serving stream busy for about ``ms``, so what is
    queued behind it cannot have finished when the host looks."""
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(int(ms * 1e-3 * 1.98e9))


@pytest.mark.cuda
def test_cuda_dispatch_returns_before_its_event_completes(cuda):
    eng = small_engine(["b6"])
    plan = eng.plans["b6"]
    reqs = [eng.submit("b6", **r) for r in small_requests("b6", plan, 4)]
    hold_stream(eng)
    assert eng.dispatch() == 4
    _, pending, _ = eng._inflight[-1]
    assert not pending.event.query() and not eng._oldest_ready()
    assert eng.metrics.counter("dispatch_returned_ahead").value == 1
    assert eng.poll() == (0, 0) and not reqs[0].done
    assert eng.harvest() == 4 and all(r.done for r in reqs)
    single = eng.models["b6"]
    for r in reqs:
        for got, want in zip(r.result, single.run(**r.inputs)):
            assert np.array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_pinned_slots_are_not_reused_early(cuda):
    """Two batches of one bucket in flight hold two page-locked slots; a
    slot goes back to its free list only at its batch's harvest."""
    eng = small_engine(["b4"], pipeline_depth=2)
    plan = eng.plans["b4"]
    reqs = small_requests("b4", plan, 8)
    for r in reqs:
        eng.submit("b4", **r)
    hold_stream(eng)
    assert eng.dispatch() == 4 and eng.dispatch() == 4
    slots = [p.slot for _, p, _ in eng._inflight]
    assert slots[0] is not slots[1]
    for a, b in zip(slots[0].inputs.values(), slots[1].inputs.values()):
        assert a.is_pinned() and a.data_ptr() != b.data_ptr()
    assert eng._slots[("b4", 4)] == []          # both in flight
    eng.harvest()
    assert eng._slots[("b4", 4)] == [slots[0]]
    eng.harvest()
    assert eng._slots[("b4", 4)] == [slots[0], slots[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["b4", "b6-dyn", "b1"])
def test_cuda_two_inflight_batches_of_one_bucket_stay_distinct(cuda, task):
    """Two batches replay one bucket's graph back to back on the serving
    stream while the card is held: each request's result equals its own
    batch-1 run bit for bit."""
    eng = small_engine([task], pipeline_depth=2)
    plan = eng.plans[task]
    reqs = [eng.submit(task, **r) for r in small_requests(task, plan, 8)]
    hold_stream(eng)
    assert eng.dispatch() == 4 and eng.dispatch() == 4
    assert eng.inflight() == 8
    assert eng.run() == 8
    single = eng.models[task]
    for r in reqs:
        for got, want in zip(r.result, single.run(**r.inputs)):
            assert np.array_equal(got, want.cpu().numpy())


def bwd_operands(case, dtype, dev, seed=0):
    """q, k, v, the forward's out and lse (by the kernel) and a random
    dout for one backward case."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q, k, v = (t(a).to(dev, dtype) for a in flash_inputs(*case[:6], seed))
    dout = t(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(dev, dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=case[6], return_lse=True)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_BWD + FLASH_DENSE_BWD, ids=str)
def test_cuda_flash_bwd_matches_plain(cuda, case, dtype):
    """dq, dk, dv of the backward kernel against ``attention_bwd_ref`` on
    the same q, k, v, out, lse and dout: within RTOL of each max|plain| in
    fp32, BF16_RTOL in bf16 (both sum in fp32 and round once); a second
    call gives the same bits (no atomics); the forward's LSE matches
    ``attention_lse_ref`` within 1e-5 of max|lse| (-inf on rows with no
    live key)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    causal = case[6]
    q, k, v, out, lse, dout = bwd_operands(case, dtype, cuda)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        close(g.float().cpu(), w.float().cpu(), rtol=rtol)
    _, want_lse = ref.attention_lse_ref(q, k, v, causal=causal)
    dead = torch.isneginf(want_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    close(lse[~dead].cpu(), want_lse[~dead].cpu(), rtol=1e-5)
    if causal and case[3] > case[4]:
        assert (got[0][:, :, :case[3] - case[4]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_forward_is_unchanged_by_the_lse(cuda, dtype):
    """The serving forward (no LSE pointer) and the training forward (LSE
    written) give the same output bits."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    for case in (FLASH_BWD[0], FLASH_BWD[1], FLASH_BWD[4]):
        q, k, v = (t(a).to(cuda, dtype) for a in flash_inputs(*case[:6]))
        plain = flash_attention(q, k, v, causal=case[6])
        with_lse, _ = flash_attention_fwd(q, k, v, causal=case[6],
                                          return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(plain, with_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_flash_fn_reads_permuted_views_and_strided_dout(cuda, dtype):
    """``FlashAttentionFn`` on (B, S, H, D) activations as permuted views,
    with a permuted dout and an expanded one (the gradient of a sum): the
    same bits as contiguous copies, grads laid out like their inputs, and
    equal to the plain twin within tolerance.  The permuted views are
    16-byte aligned, as the bf16 kernels need; the expanded dout (head-dim
    stride 0) is copied before the kernel reads it."""
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_bwd)
    rng = np.random.default_rng(7)
    shapes = ((2, 128, 32, 64), (2, 128, 8, 64), (2, 128, 8, 64))
    base = [t(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
            for s in shapes]
    dout = t(rng.standard_normal(shapes[0]).astype(np.float32)).to(
        cuda, dtype).transpose(1, 2)

    def grads(make, g):
        leaves = [a.clone().requires_grad_(True) for a in base]
        out = FlashAttentionFn.apply(*make(leaves), True, None)
        out.backward(g(out))
        return [a.grad for a in leaves]

    before = flash_attention_bwd.launches
    views = grads(lambda ls: [a.transpose(1, 2) for a in ls],
                  lambda out: dout)
    copies = grads(lambda ls: [a.transpose(1, 2).contiguous() for a in ls],
                   lambda out: dout.contiguous())
    summed = grads(lambda ls: [a.transpose(1, 2) for a in ls],
                   lambda out: torch.ones((), device=cuda,
                                          dtype=dtype).expand(out.shape))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 3
    for a, b in zip(views, copies):
        assert torch.equal(a, b) and a.is_contiguous()
    assert all(torch.isfinite(g).all() for g in summed)
    q, k, v = (a.transpose(1, 2) for a in base)
    out, lse = ref.attention_lse_ref(q, k, v)
    want = ref.attention_bwd_ref(q, k, v, out, lse, dout)
    for got, w in zip(views, want):
        close(got.transpose(1, 2).float().cpu(), w.float().cpu(),
              rtol=RTOL if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.cuda
def test_cuda_flash_bwd_refuses_misaligned_bf16_operands(cuda):
    """The bf16 backward stages its tiles by 16-byte copies: a q, k, v,
    out or dout whose base or a stride is off a 16-byte boundary raises,
    launching nothing; nothing falls back to another kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    q, k, v, out, lse, dout = bwd_operands((1, 2, 2, 8, 8, 32, True),
                                           torch.bfloat16, cuda)
    wide = torch.zeros((1, 2, 8, 40), device=cuda, dtype=torch.bfloat16)
    bad = wide[..., 1:33]
    before = flash_attention_bwd.launches
    args = [q, k, v, out, lse, dout]
    for i in (0, 1, 2, 3, 5):
        with pytest.raises(ValueError, match="aligned"):
            flash_attention_bwd(*args[:i], bad, *args[i + 1:])
    assert flash_attention_bwd.launches == before


@pytest.mark.cuda
def test_cuda_flash_fn_copies_a_misaligned_bf16_dout(cuda):
    """``FlashAttentionFn.backward`` copies a bf16 dout that is not 16-byte
    aligned (here a view one element past an aligned base) instead of
    refusing it: the grads equal those of the same dout, aligned, bit for
    bit, and the kernel launched once for each."""
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention_bwd)
    case = (2, 8, 2, 100, 100, 64, True)
    base = [t(a).to(cuda, torch.bfloat16)
            for a in flash_inputs(*case[:6], seed=3)]
    g = t(np.random.default_rng(4).standard_normal(
        (2, 8, 100, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    flat = torch.empty(g.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.data_ptr() % 16

    def grads(dout):
        leaves = [a.clone().requires_grad_(True) for a in base]
        FlashAttentionFn.apply(*leaves, True, None).backward(dout)
        return [a.grad for a in leaves]

    before = flash_attention_bwd.launches
    got, want = grads(shifted), grads(g)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-0.6b", "zamba2-2.7b",
                                  "xlstm-350m", "deepseek-v3-671b",
                                  "grok-1-314b"])
def test_cuda_train_step_kernel_path_matches_plain(cuda, arch):
    """One fp32 ``lm_loss`` + grads of the smoke config on the card: the
    kernel path (``impl="chunked"``, forward and backward kernels) against
    the plain path (``"naive"``, autograd through plain attention): loss
    within 1e-6 relative, every grad leaf within 1e-4 of its max|plain|;
    the backward kernel launches once an attention call (a layer, or a
    zamba2 shared-block application; none for xlstm)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.train.optim import tree_leaves
    cfg = configs.get_smoke(arch)
    params = init_lm(0, cfg, device=cuda)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64)), device=cuda)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    results = {}
    for impl in ("chunked", "naive"):
        before = flash_attention_bwd.launches
        loss, _ = lm_loss(params, cfg, batch, impl=impl)
        results[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        assert flash_attention_bwd.launches - before == (
            attn_calls(cfg) if impl == "chunked" else 0)
    (l_k, g_k), (l_p, g_p) = results["chunked"], results["naive"]
    assert abs(l_k - l_p) <= 1e-6 * abs(l_p)
    for a, b in zip(g_k, g_p):
        close(a.cpu(), b.cpu(), rtol=1e-4)
