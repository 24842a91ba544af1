"""The port's flash-attention wrapper (on CPU tensors: its plain version,
``repro_torch.kernels.ref.attention_ref``) against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs; and the training
path's backward (``attention_bwd_ref`` and ``FlashAttentionFn`` on CPU
tensors) against ``jax.vjp`` of the reference's ``flash_attention_xla``.

Cases (``FLASH_CASES``, shared with the card tests): the six of
``tests/test_kernels.py::test_flash_attention_matches_ref`` (GQA, ragged,
continuation, non-causal), its decode shape, and ``Sq > Sk`` causal cases
whose first rows have no live key (the Pallas kernel gives 0 there, and so
must the port).  Tolerances are the reference test's own:
2e-5 in fp32, 3e-2 in bf16 (both round the fp32 result to bf16 once; the
scores sum in another order).  The backward (``BWD_CASES``: GQA groups 1,
2 and 4, causal and not, ``Sq == Sk`` and ``Sq < Sk``, D 32 and 64) must
give dq, dk and dv within 1e-5 of each max|ref| in fp32 (the same math,
summed in another order); the LSE within 1e-6 of max|lse|.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.models.attention import _flash_fwd_impl, flash_attention_xla
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
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


# (B, Hq, Hkv, Sq, Sk, D, causal): GQA groups 1, 2 and 4, causal and not,
# Sq == Sk and Sq < Sk (a continuation), D 32 and 64
BWD_CASES = [
    (2, 4, 4, 32, 32, 32, True), (2, 4, 2, 32, 32, 64, True),
    (1, 8, 2, 48, 48, 32, True), (2, 4, 2, 16, 48, 64, True),
    (1, 4, 1, 24, 40, 32, True), (2, 4, 4, 32, 32, 64, False),
    (1, 8, 2, 20, 36, 32, False), (1, 4, 2, 1, 40, 64, True),
]
BWD_RTOL = 1e-5


def jax_vjp(q, k, v, dout, causal):
    """The reference's training attention and its vjp, on (B, Hq, S, D)
    numpy inputs: ``flash_attention_xla`` takes (B, S, H, D) and aligns
    query i with key i + offset, here ``Sk - Sq``."""
    tr = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, dout)]
    off = k.shape[2] - q.shape[2]
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(
        a, b, c, causal, off), *tr[:3])
    grads = vjp(tr[3])
    _, lse = _flash_fwd_impl(*tr[:3], causal, off, None, 512)
    back = [np.asarray(g).transpose(0, 2, 1, 3) for g in grads]
    return np.asarray(out).transpose(0, 2, 1, 3), np.asarray(lse), back


def bwd_inputs(case, seed=0):
    q, k, v = flash_inputs(*case[:6], seed)
    dout = np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)
    return q, k, v, dout


def close_to(got, want, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", BWD_CASES, ids=str)
def test_attention_bwd_matches_jax_vjp(b, hq, hkv, sq, sk, d, causal):
    """``attention_lse_ref`` + ``attention_bwd_ref`` (the plain twins) and
    ``FlashAttentionFn`` on CPU tensors against ``jax.vjp`` of the
    reference's ``flash_attention_xla``."""
    case = (b, hq, hkv, sq, sk, d, causal)
    q, k, v, dout = bwd_inputs(case)
    want_out, want_lse, want = jax_vjp(q, k, v, dout, causal)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    out, lse = ref.attention_lse_ref(tq, tk, tv, causal=causal)
    close_to(out, want_out, BWD_RTOL)
    close_to(lse, want_lse, 1e-6)
    plain = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdout, causal=causal)
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    fn_out = FlashAttentionFn.apply(*leaves, causal, None)
    fn_out.backward(tdout)
    close_to(fn_out, want_out, BWD_RTOL)
    for got_plain, leaf, w in zip(plain, leaves, want):
        assert got_plain.shape == w.shape
        close_to(got_plain, w, BWD_RTOL)
        close_to(leaf.grad, w, BWD_RTOL)


def test_flash_fwd_and_bwd_wrappers_run_the_twins_on_the_cpu():
    """On CPU tensors the wrappers return exactly their plain versions,
    and launch (count) nothing."""
    q, k, v, dout = map(torch.from_numpy, bwd_inputs(BWD_CASES[1]))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    want_out, want_lse = ref.attention_lse_ref(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert torch.equal(flash_attention_fwd(q, k, v), want_out)
    for got, want in zip(flash_attention_bwd(q, k, v, out, lse, dout),
                         ref.attention_bwd_ref(q, k, v, out, lse, dout)):
        assert torch.equal(got, want)
    assert (flash_attention.launches,
            flash_attention_bwd.launches) == before


def test_rows_with_no_live_key_get_zero_gradient():
    """Sq > Sk, causal: the first Sq - Sk rows see no key.  Their output is
    0, their LSE -inf, and their gradient 0 (not NaN); the other rows'
    gradients equal those of the same attention over the live rows alone
    (the reference's vjp at Sq = Sk)."""
    b, hq, hkv, sq, sk, d = 2, 4, 2, 40, 24, 32
    dead = sq - sk
    q, k, v, dout = bwd_inputs((b, hq, hkv, sq, sk, d, True))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, True, None)
    out.backward(torch.from_numpy(dout))
    _, lse = ref.attention_lse_ref(*(a.detach() for a in leaves))
    assert (out[:, :, :dead] == 0).all()
    assert torch.isneginf(lse[:, :, :dead]).all()
    assert torch.isfinite(lse[:, :, dead:]).all()
    assert all(torch.isfinite(a.grad).all() for a in leaves)
    assert (leaves[0].grad[:, :, :dead] == 0).all()
    _, _, want = jax_vjp(np.ascontiguousarray(q[:, :, dead:]), k, v,
                         np.ascontiguousarray(dout[:, :, dead:]), True)
    close_to(leaves[0].grad[:, :, dead:], want[0], BWD_RTOL)
    close_to(leaves[1].grad, want[1], BWD_RTOL)
    close_to(leaves[2].grad, want[2], BWD_RTOL)


def test_flash_bwd_wrapper_rejects_bad_operands():
    q, k, v, dout = map(torch.from_numpy, bwd_inputs(BWD_CASES[1]))
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[:, :, 1:], dout)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse.double(), dout)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, dout[:, :, 1:])


def test_chunked_attention_trains_through_the_autograd_function():
    """``flash_chunked_attention`` on (B, S, H, D) activations that need
    grad goes through ``FlashAttentionFn``; its grads equal the
    reference's vjp; without grad it is the plain forward."""
    b, hq, hkv, s, d = 2, 8, 2, 32, 32
    q, k, v, dout = bwd_inputs((b, hq, hkv, s, s, d, True), seed=3)
    act = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
           .requires_grad_(True) for a in (q, k, v)]
    out = flash_chunked_attention(*act, causal=True)
    inner = out.grad_fn.next_functions[0][0]      # under the transpose
    assert type(inner).__name__ == "FlashAttentionFnBackward"
    out.backward(torch.from_numpy(dout.transpose(0, 2, 1, 3).copy()))
    _, _, want = jax_vjp(q, k, v, dout, True)
    for a, w in zip(act, want):
        close_to(a.grad.transpose(1, 2), w, BWD_RTOL)
    with torch.no_grad():
        plain = flash_chunked_attention(*act, causal=True)
    assert plain.grad_fn is None
    assert torch.equal(plain, out.detach())
