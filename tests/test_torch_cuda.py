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
from repro_torch.kernels.flash_attention import MAX_D, flash_attention
from repro_torch.kernels.knn import MAX_K, knn
from repro_torch.kernels.sddmm import BLOCK, live_tiles, sddmm
from repro_torch.kernels.shift_conv import launch_plan, shift_conv2d
from repro_torch.kernels.spdmm import spdmm, spdmm_rows

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import (knn_adversarial, vip_masked_graph,  # noqa: E402
                        window_mask)

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
    (70, 5, MAX_K, 30, False, False),
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


def flash_inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


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
    from repro_torch.kernels import _build
    assert _build.library().repro_knn_max_k() == MAX_K
    with pytest.raises(ValueError, match="ceiling"):
        knn(torch.zeros((MAX_K + 1, 3), device=cuda), MAX_K + 1)
    with pytest.raises(TypeError):
        knn(torch.zeros((10, 3), device=cuda, dtype=torch.float64), 3)


# (name, N, F, k): chip_smoke.knn_adversarial's orders and ties, k at both
# ends, N below a warp and off the block's rows, b7-dyn's (196, 192)
KNN_ADVERSARIAL = [
    ("rising", 1024, 3, 20), ("falling", 1024, 3, 20),
    ("rising", 1024, 3, MAX_K), ("equal", 1024, 3, 20),
    ("equal", 300, 3, MAX_K), ("masked", 1024, 3, 20),
    ("normal", 1024, 3, 1), ("normal", 1024, 3, MAX_K),
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
    got = build_runner(plan)(**inputs)[0]
    torch.cuda.synchronize()
    assert (shift_conv2d.launches - counts[0],
            spdmm_rows.launches - counts[1],
            ddmm.launches - counts[2]) == (18, 9, 1)
    close(got.cpu(), build_runner(plain)(**inputs)[0].cpu(), rtol=1e-4)


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
                       free_dead=False)
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
    got = build_runner(plan)(**inputs)[0]
    torch.cuda.synchronize()
    assert tuple(fn.launches - b for fn, b in zip(fns, before)) == counts
    if task == "vip-masked":                   # the softmax mixes neighbours
        nodes = inputs["nodes"]
        assert np.abs(got.cpu().numpy() - nodes).max() > \
            0.1 * np.abs(nodes).max()
    close(got.cpu(), build_runner(plain)(**inputs)[0].cpu(), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_SERVED, ids=str)
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
    assert _build.library().repro_flash_max_d() == MAX_D
    z = torch.zeros((1, 2, 8, MAX_D + 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(z, z, z)
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
