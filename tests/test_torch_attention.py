"""The port's flash-attention wrapper (on CPU tensors: its plain version,
``repro_torch.kernels.ref.attention_ref``) against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs.

Cases (``FLASH_CASES``, shared with the card tests): the six of
``tests/test_kernels.py::test_flash_attention_matches_ref`` (GQA, ragged,
continuation, non-causal), its decode shape, and ``Sq > Sk`` causal cases
whose first rows have no live key (the Pallas kernel gives 0 there, and so
must the port).  Tolerances are the reference test's own:
2e-5 in fp32, 3e-2 in bf16 (both round the fp32 result to bf16 once; the
scores sum in another order).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (flash_chunked_attention,
                                          naive_attention)
from test_torch_cuda import FLASH_CASES, flash_inputs

TOL = {np.float32: 2e-5, ml_dtypes.bfloat16: 3e-2}
TORCH_DTYPE = {np.float32: torch.float32, ml_dtypes.bfloat16: torch.bfloat16}


def inputs(b, hq, hkv, sq, sk, d, dtype, seed=0):
    return [a.astype(dtype) for a in flash_inputs(b, hq, hkv, sq, sk, d,
                                                   seed)]


def to_torch(a):
    return torch.from_numpy(a.astype(np.float32)).to(
        TORCH_DTYPE[a.dtype.type])


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES, ids=str)
def test_flash_wrapper_matches_pallas_interpret(b, hq, hkv, sq, sk, d,
                                                causal, dtype):
    q, k, v = inputs(b, hq, hkv, sq, sk, d, dtype)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=64,
                                bk=128, interpret=True), np.float32)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v),
                          causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    if causal and sq > sk:
        dead = sq - sk
        assert (want[:, :, :dead] == 0).all()
        assert (got[:, :, :dead] == 0).all()


def test_attention_ref_is_finite_where_the_reference_is_not():
    """The reference's ``attention_ref`` gives NaN on a row with no live
    key; the port's plain version follows the kernel and gives 0."""
    from repro.kernels.ref import attention_ref as jax_ref
    q, k, v = inputs(1, 4, 2, 8, 4, 32, np.float32)
    theirs = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True))
    ours = ref.attention_ref(*map(to_torch, (q, k, v)), causal=True)
    assert np.isnan(theirs[:, :, :4]).all()
    assert (ours[:, :, :4] == 0).all()
    np.testing.assert_allclose(ours[:, :, 4:].numpy(), theirs[:, :, 4:],
                               rtol=2e-5, atol=2e-5)


def test_flash_wrapper_rejects_bad_shapes():
    q = torch.zeros((1, 4, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 8, 32)),
                        torch.zeros((1, 3, 8, 32)))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 2, 8, 16)),
                        torch.zeros((1, 2, 8, 16)))


@pytest.mark.parametrize("sq,sk", [(16, 16), (48, 48), (8, 40)])
def test_flash_layout_matches_naive(sq, sk):
    """The model's ``(B, S, H, hd)`` flash path against ``naive_attention``
    (the decode oracle) at the causal offset ``Sk - Sq``."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, sq, 8, 64), (2, sk, 2, 64), (2, sk, 2, 64)))
    got = flash_chunked_attention(q, k, v, causal=True, offset=sk - sq)
    want = naive_attention(q, k, v, causal=True, offset=sk - sq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="offset"):
        flash_chunked_attention(q, k, v, causal=True, offset=sk - sq + 1)
