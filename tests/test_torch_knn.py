"""The port's KNN (``repro_torch.kernels.knn``) against the reference.

On the CPU the wrapper runs its plain version (``ref.knn_ref``), which must
give the reference's indices **exactly**: the JAX ``knn_ref``
(``lax.top_k``), the Pallas ``knn`` in interpret mode and the numpy oracle
``graphs.knn_indices``, on every case, ties included.  Mirrors
``tests/test_knn_kernel.py``; inputs come from numpy seeds.  Also the
wrapper's rejections, and that a CPU tensor launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnncv.graphs import knn_indices
from repro.kernels.knn import knn as pallas_knn
from repro.kernels.knn import knn_ref as jax_knn_ref
from repro_torch.kernels import ref
from repro_torch.kernels.knn import MAX_K, knn
from test_torch_cuda import knn_adversarial

SHAPES = [(64, 3, 5), (100, 16, 12), (130, 3, 20), (300, 8, 9)]


def points(n, f, seed):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(
        np.float32)


def port(x, k, **kw):
    kw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for key, v in kw.items()}
    return knn(torch.from_numpy(x), k, **kw).numpy()


def reference(x, k, mask=None, self_loops=False, interpret=False):
    m = None if mask is None else jnp.asarray(mask)
    if interpret:
        return np.asarray(pallas_knn(jnp.asarray(x), k=k, mask=m,
                                     self_loops=self_loops, interpret=True))
    return np.asarray(jax_knn_ref(jnp.asarray(x), k=k, mask=m,
                                  self_loops=self_loops))


@pytest.mark.parametrize("n,f,k", SHAPES)
def test_knn_matches_reference_exactly(n, f, k):
    x = points(n, f, seed=n)
    got = port(x, k)
    assert got.dtype == np.int32 and got.shape == (n, k)
    np.testing.assert_array_equal(got, reference(x, k))
    np.testing.assert_array_equal(got, reference(x, k, interpret=True))
    np.testing.assert_array_equal(got, knn_indices(x, k))


def test_knn_at_b6_dyn_shape_with_padding_mask():
    """1024 points, k=20, the last 64 masked (a 960-point cloud padded to
    a 1024 bucket), for four seeds."""
    mask = np.ones(1024, np.float32)
    mask[-64:] = 0.0
    for seed in range(4):
        x = points(1024, 3, seed)
        got = port(x, 20, mask=mask)
        np.testing.assert_array_equal(got, reference(x, 20, mask=mask))
        assert mask[got].all()


@pytest.mark.parametrize("self_loops", [False, True])
@pytest.mark.parametrize("name,k", [("rising", 20), ("falling", 20),
                                    ("rising", MAX_K), ("equal", 20),
                                    ("equal", MAX_K), ("masked", 20),
                                    ("normal", 1)])
def test_knn_adversarial_orders_match_reference(name, k, self_loops):
    """The card's adversarial cases (``chip_smoke.knn_adversarial``):
    collinear points visited farthest-first, all points equal, almost
    every candidate masked, k = 1 and k = MAX_K."""
    x, mask = knn_adversarial(name, 200, 3, np.random.default_rng(0))
    kw = dict(mask=mask, self_loops=self_loops)
    got = port(x, k, **kw)
    np.testing.assert_array_equal(got, reference(x, k, **kw))
    np.testing.assert_array_equal(got, knn_indices(x, k, **kw))


def test_integer_coordinates_break_ties_toward_lower_index():
    """Integer coordinates give many exact distance ties."""
    x = np.random.default_rng(5).integers(-2, 3, (120, 3)).astype(
        np.float32)
    got = port(x, 12)
    np.testing.assert_array_equal(got, reference(x, 12))
    np.testing.assert_array_equal(got, reference(x, 12, interpret=True))
    np.testing.assert_array_equal(got, knn_indices(x, 12))
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    for i in range(len(x)):
        row = d[i, got[i]]
        assert (np.diff(row) >= 0).all()
        ties = np.diff(row) == 0
        assert (np.diff(got[i])[ties] > 0).all()


def test_duplicate_points_list_clones_in_index_order():
    base = points(8, 3, seed=9)
    x = np.concatenate([base, base, base])
    got = port(x, 5)
    np.testing.assert_array_equal(got, reference(x, 5))
    assert list(got[0][:2]) == [8, 16]


@pytest.mark.parametrize("n,k", [(64, 5), (100, 12)])
def test_self_loops(n, k):
    x = points(n, 3, seed=k)
    got = port(x, k, self_loops=True)
    np.testing.assert_array_equal(got, reference(x, k, self_loops=True))
    np.testing.assert_array_equal(got, knn_indices(x, k, self_loops=True))
    np.testing.assert_array_equal(got[:, 0], np.arange(n))
    assert not (port(x, k) == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("masked_frac", [0.25, 0.5])
def test_mask_excludes_candidates(masked_frac):
    n, k = 96, 7
    rng = np.random.default_rng(11)
    x = points(n, 5, seed=12)
    mask = (rng.random(n) >= masked_frac).astype(np.float32)
    mask[:k + 1] = 1.0
    got = port(x, k, mask=mask)
    np.testing.assert_array_equal(got, reference(x, k, mask=mask))
    np.testing.assert_array_equal(got, reference(x, k, mask=mask,
                                                 interpret=True))
    np.testing.assert_array_equal(got, knn_indices(x, k, mask=mask))
    assert mask[got].all()


def test_masked_rows_still_emit_indices():
    n, k = 40, 3
    x = points(n, 3, seed=13)
    mask = np.ones(n, np.float32)
    mask[30:] = 0.0
    got = port(x, k, mask=mask)
    assert got.shape == (n, k) and (got[30:] < 30).all()
    np.testing.assert_array_equal(got, reference(x, k, mask=mask))


def test_mask_may_be_a_column():
    x = points(50, 3, seed=14)
    mask = np.ones((50, 1), np.float32)
    mask[40:] = 0.0
    np.testing.assert_array_equal(port(x, 6, mask=mask),
                                  reference(x, 6, mask=mask[:, 0]))


def test_bf16_points_are_upcast():
    x = points(100, 3, seed=15)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = knn(xb, 9).numpy()
    want = np.asarray(jax_knn_ref(jnp.asarray(x, jnp.bfloat16), k=9))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, port(xb.float().numpy(), 9))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="out of range"):
        knn(x, 0)
    with pytest.raises(ValueError, match="out of range"):
        knn(x, 11)
    with pytest.raises(ValueError, match="ceiling"):
        knn(torch.zeros((MAX_K + 1, 3)), MAX_K + 1)
    with pytest.raises(ValueError, match="mask"):
        knn(x, 3, mask=torch.ones(9))
    with pytest.raises(ValueError, match=r"\(N, F\)"):
        knn(torch.zeros(10), 3)


def test_cpu_tensors_launch_nothing():
    before = knn.launches
    knn(torch.from_numpy(points(30, 3, seed=16)), 4)
    assert knn.launches == before


def test_plain_version_needs_no_wrapper():
    x = points(64, 3, seed=17)
    np.testing.assert_array_equal(
        ref.knn_ref(torch.from_numpy(x), 5).numpy(), reference(x, 5))
