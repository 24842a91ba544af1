"""The port's hand-written CUDA kernels against their plain versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU; run them
on one with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.  The file imports no JAX (the GPU machine has
none); it also holds the shapes and input makers the CPU parity tests in
``tests/test_torch_kernels.py`` share.

Tolerance: ``max|Δ| <= 1e-5 · max|plain|`` — fp32 accumulation in another
order; TF32 is switched off for the plain versions.  KNN indices must be
equal exactly: the kernel repeats the plain version's fp32 arithmetic.
Requests end to end: ``1e-4 · max|plain plan|``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.knn import MAX_K, knn
from repro_torch.kernels.shift_conv import shift_conv2d
from repro_torch.kernels.spdmm import spdmm

RTOL = 1e-5
DDMM_SHAPES = [(1, 256, 60), (33, 257, 129), (100, 70, 130), (64, 64, 64)]
ACTS = [None, "relu", "gelu", "silu", "tanh"]
SPDMM_SHAPES = [(25, 25, 5, 300), (33, 57, 7, 129), (64, 100, 3, 1),
                (8, 8, 8, 17)]
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


def ell_inputs(s1, s2, ell_l, seed):
    """ELL with padding slots (val 0) whose idx points at real rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, s2, (s1, ell_l)).astype(np.int32)
    val = rng.standard_normal((s1, ell_l)).astype(np.float32)
    pad = rng.random((s1, ell_l)) < 0.3
    val[pad] = 0.0
    assert (idx[pad] != 0).any()
    return idx, val


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


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 5), device=cuda)
    with pytest.raises(TypeError):
        ddmm(x.double(), torch.zeros((5, 6), device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        ddmm(torch.zeros((5, 4), device=cuda).T, torch.zeros((5, 6),
                                                            device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        ddmm(x, torch.zeros((5, 6)))


@pytest.mark.cuda
def test_cuda_b4_request_runs_through_the_kernels(cuda):
    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs
    from repro_torch.gnncv.tasks import build_task
    plan = compile_graph(build_task("b4"), CompileOptions(kernels="cuda"))
    plain = compile_graph(build_task("b4"), CompileOptions(kernels="torch"))
    inputs = random_inputs(plan, seed=0)
    counts = (shift_conv2d.launches, spdmm.launches, ddmm.launches)
    got = build_runner(plan)(**inputs)[0]
    torch.cuda.synchronize()
    assert (shift_conv2d.launches - counts[0], spdmm.launches - counts[1],
            ddmm.launches - counts[2]) == (18, 9, 1)
    close(got.cpu(), build_runner(plain)(**inputs)[0].cpu(), rtol=1e-4)


def dyn_request(n, seed, pad=64):
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0.0
    return dict(points=np.random.default_rng(seed).standard_normal(
        (n, 3)).astype(np.float32), mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("task,counts", [
    ("b6-dyn", (0, 0, 6, 1)), ("b6", (0, 0, 6, 0)), ("b5", (2, 0, 3, 0))])
def test_cuda_request_runs_through_the_kernels(cuda, task, counts):
    from repro_torch.core import CompileOptions, build_runner, compile_graph
    from repro_torch.core.executor import random_inputs
    from repro_torch.gnncv.tasks import build_dynamic_task, build_task
    build = build_dynamic_task if task == "b6-dyn" else build_task
    plan = compile_graph(build(task), CompileOptions(kernels="cuda"))
    plain = compile_graph(build(task), CompileOptions(kernels="torch"))
    inputs = (dyn_request(1024, seed=0) if task == "b6-dyn"
              else random_inputs(plan, seed=0))
    fns = (shift_conv2d, spdmm, ddmm, knn)
    before = [fn.launches for fn in fns]
    got = build_runner(plan)(**inputs)[0]
    torch.cuda.synchronize()
    assert tuple(fn.launches - b for fn, b in zip(fns, before)) == counts
    close(got.cpu(), build_runner(plain)(**inputs)[0].cpu(), rtol=1e-4)
