"""The port's kernels (``repro_torch.kernels``) against the JAX reference.

The same numpy inputs go through the port's plain versions (what every
wrapper runs on a CPU tensor) and through the reference's Pallas kernels in
interpret mode and its ``kernels/ref.py`` oracles, as the reference's own
tests run them.  Tolerance: ``max|Δ| <= 1e-5 · max|ref|`` (fp32
accumulation in another order).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ddmm import ddmm as jddmm
from repro.kernels.shift_conv import shift_conv2d as jshift_conv2d
from repro.kernels.spdmm import dense_to_ell as jdense_to_ell
from repro.kernels.spdmm import spdmm as jspdmm
from repro_torch.core.passes.select import dense_to_ell
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.shift_conv import shift_conv2d
from repro_torch.kernels.spdmm import spdmm
from test_torch_cuda import (ACTS, CONV_CASES, DDMM_SHAPES, SPDMM_SHAPES,
                             close, conv_inputs, ddmm_inputs, ell_inputs, t)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Keep torch's CPU ops on one thread: the suite runs in parallel
    workers, and some of its neighbours time themselves against SLOs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ ddmm --
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", DDMM_SHAPES)
def test_ddmm_matches_pallas_and_ref(m, k, n, act):
    x, y, b, r = ddmm_inputs(m, k, n)
    got = ddmm(t(x), t(y), bias=t(b), residual=t(r), act=act).numpy()
    jx, jy, jb, jr = map(jnp.asarray, (x, y, b, r))
    close(got, jddmm(jx, jy, bias=jb, residual=jr, act=act,
                     interpret=True))
    close(got, jref.ddmm_ref(jx, jy, bias=jb, residual=jr, act=act))


def test_ddmm_without_epilogue_and_gelu_is_tanh_form():
    x, y, _, _ = ddmm_inputs(20, 30, 40, seed=1)
    close(ddmm(t(x), t(y)).numpy(), x @ y)
    z = np.linspace(-4, 4, 101).astype(np.float32)
    g = ref.ACTS["gelu"](t(z)).numpy()
    close(g, jax.nn.gelu(jnp.asarray(z)))            # jax default: tanh
    erf_form = torch.nn.functional.gelu(t(z)).numpy()
    assert np.abs(g - erf_form).max() > 1e-5


# ----------------------------------------------------------------- spdmm --
@pytest.mark.parametrize("s1,s2,ell_l,n", SPDMM_SHAPES)
def test_spdmm_matches_pallas_and_ref(s1, s2, ell_l, n):
    idx, val = ell_inputs(s1, s2, ell_l, seed=s1)
    y = np.random.default_rng(1).standard_normal((s2, n)).astype(np.float32)
    got = spdmm(t(idx), t(val), t(y)).numpy()
    ji, jv, jy = jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y)
    close(got, jspdmm(ji, jv, jy, interpret=True))
    close(got, jref.spdmm_ref(ji, jv, jy))
    dense = np.zeros((s1, s2), np.float32)
    np.add.at(dense, (np.arange(s1)[:, None], idx), val)
    close(got, dense @ y)


@pytest.mark.parametrize("density", [0.05, 0.3, 1.0])
def test_dense_to_ell_bit_identical(density):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((25, 40)).astype(np.float32)
    a *= rng.random(a.shape) < density
    idx, val = dense_to_ell(a)
    jidx, jval = jdense_to_ell(a)
    assert idx.dtype == np.int32 and val.dtype == np.float32
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_array_equal(val, np.asarray(jval))


# ------------------------------------------------------------ shift_conv --
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_shift_conv_matches_pallas_and_lax(case):
    cin, h, w, k1, k2, cout, stride, padding, groups, dil = case
    x, wt = conv_inputs(cin, h, w, k1, k2, cout, groups)
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dil)
    got = shift_conv2d(t(x), t(wt), **kw).numpy()
    jx, jw = jnp.asarray(x), jnp.asarray(wt)
    close(got, jshift_conv2d(jx, jw, interpret=True, **kw))
    close(got, jref.conv2d_ref(jx, jw, **kw))


def test_conv_geometry_matches_lowering():
    # SAME keeps ceil(H/s); the TF split puts the odd pad row at the bottom
    assert ref.conv_geometry(150, 25, 9, 1, stride=(2, 1), padding="SAME",
                             dilation=(1, 1)) == (75, 25, 3, 4, 0, 0)
    assert ref.conv_geometry(75, 25, 9, 1, stride=(2, 1), padding="SAME",
                             dilation=(1, 1)) == (38, 25, 4, 4, 0, 0)
    assert ref.conv_geometry(10, 10, 3, 3, stride=1, padding="VALID",
                             dilation=2) == (6, 6, 0, 0, 0, 0)
    with pytest.raises(ValueError):
        ref.conv_geometry(10, 10, 3, 3, stride=1, padding="FULL",
                          dilation=1)


# ------------------------------------------------------ wrapper contract --
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = (ddmm.launches, spdmm.launches, shift_conv2d.launches)
    x, y, _, _ = ddmm_inputs(4, 5, 6)
    ddmm(t(x), t(y))
    idx, val = ell_inputs(4, 4, 2, seed=0)
    spdmm(t(idx), t(val), t(y[:4]))
    xc, wc = conv_inputs(3, 5, 5, 3, 3, 4, 1)
    shift_conv2d(t(xc), t(wc))
    assert (ddmm.launches, spdmm.launches, shift_conv2d.launches) == before


def test_non_cuda_device_raises_instead_of_falling_back():
    x = torch.empty((4, 5), device="meta")
    y = torch.empty((5, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ddmm(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        shift_conv2d(torch.empty((3, 5, 5), device="meta"),
                     torch.empty((3, 3, 3, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        spdmm(torch.empty((4, 2), dtype=torch.int32, device="meta"),
              torch.empty((4, 2), device="meta"), y)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(5, 6))
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(4, 6), bias=torch.zeros(5))
    with pytest.raises(ValueError):
        spdmm(torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 3),
              torch.zeros(4, 4))
    with pytest.raises(ValueError):
        shift_conv2d(torch.zeros(6, 5, 5), torch.zeros(3, 3, 4, 4),
                     groups=2)
    with pytest.raises(ValueError):
        ddmm(torch.zeros(3, 4), torch.zeros(4, 6), act="swish")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
