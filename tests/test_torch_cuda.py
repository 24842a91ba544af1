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
— kernel and plain version both compute in fp32 from the same bf16 inputs
and round once to bf16, so an element can differ by one bf16 ulp (2^-8 of
itself) where the two fp32 sums straddle a rounding boundary; rows with no
live key must be exactly 0.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.flash_attention import MAX_D, flash_attention
from repro_torch.kernels.knn import MAX_K, knn
from repro_torch.kernels.sddmm import BLOCK, live_tiles, sddmm
from repro_torch.kernels.shift_conv import shift_conv2d
from repro_torch.kernels.spdmm import spdmm

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import vip_masked_graph, window_mask  # noqa: E402,F401

RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
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
@pytest.mark.parametrize("case", [
    (26, 1, 28, 28, 3, 3, 64, 1, "SAME", 1, (1, 1)),
    (26, 64, 7, 7, 3, 3, 64, 1, "SAME", 1, (1, 1)),
    (3, 8, 15, 25, 3, 2, 8, (2, 1), "VALID", 4, (1, 2))], ids=str)
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
    fns = (shift_conv2d, spdmm, ddmm, knn, sddmm)
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
