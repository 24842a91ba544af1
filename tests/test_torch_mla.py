"""The port's MLA (multi-head latent attention) and the flash forward with
v's head dim apart from q's, against the JAX package, on the CPU.

``repro_torch.models.attention``'s ``_mla_qkr``, ``mla_forward`` (the
``naive`` core and ``chunked``, the flash wrapper, against the reference's
``flash_attention_xla`` path) and ``mla_decode`` (the absorbed decode; a
row past the cache's end dropped) against ``repro.models.attention`` on
deepseek-v3's fp32 smoke config, with the reference's weights.  Then the
flash wrapper on CPU tensors (its plain version) with DV != D, forward
and backward (``FlashAttentionFn``), against ``flash_attention_xla`` and
its vjp: the Pallas kernel asserts ``k.shape == v.shape`` and cannot serve
here.  Tolerance 1e-5 of max|ref| (the same fp32 math summed in another
order); the LSE within 1e-6 of max|lse|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro.models.attention import flash_attention_xla
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (MAX_D, MAX_D_BWD,
                                                 FlashAttentionFn,
                                                 _out_like, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd, takes)
from repro_torch.models import attention
from test_torch_lm import both, close

ARCH = "deepseek-v3-671b"


def mla_params(layer=0, stage="stage_0"):
    cfg, rp, pcfg, pp = both(ARCH)
    return (cfg, jax.tree.map(lambda a: a[layer], rp[stage]["attn"]), pcfg,
            {k: a[layer] for k, a in pp[stage]["attn"].items()})


def x_and_positions(cfg, b, s, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return x, np.broadcast_to(np.arange(s), (b, s)).copy()


def test_mla_projections_match_the_reference():
    cfg, ra, pcfg, pa = mla_params()
    x, pos = x_and_positions(cfg, 2, 13)
    want = rattn._mla_qkr(ra, jnp.asarray(x), jnp.asarray(pos), cfg)
    got = attention._mla_qkr(pa, torch.from_numpy(x), torch.from_numpy(pos),
                             pcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


@pytest.mark.parametrize("layer,stage", [(0, "stage_0"), (1, "stage_1")])
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_mla_forward_matches_the_reference(impl, layer, stage):
    """q·k over nope + rope (24 at the smoke config), v of 16, scale
    1/sqrt(24); ``chunked`` is the flash wrapper against the reference's
    ``flash_attention_xla``, ``naive`` against its ``naive_attention``."""
    cfg, ra, pcfg, pa = mla_params(layer if stage == "stage_1" else 0,
                                   stage)
    x, pos = x_and_positions(cfg, 2, 20, seed=layer + 1)
    want = rattn.mla_forward(ra, jnp.asarray(x), jnp.asarray(pos), cfg,
                             impl=impl)
    got = attention.mla_forward(pa, torch.from_numpy(x),
                                torch.from_numpy(pos), pcfg, impl=impl)
    close(got, want)


def test_mla_chunked_runs_the_flash_wrapper_at_192_over_128_shapes(
        monkeypatch):
    """``chunked`` hands the wrapper q and k of nope + rope and v of
    v_head_dim, as permuted views of the model's activations, with the
    MLA scale."""
    cfg, ra, pcfg, pa = mla_params()
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    x, pos = x_and_positions(cfg, 1, 9)
    with torch.no_grad():
        attention.mla_forward(pa, torch.from_numpy(x), torch.from_numpy(pos),
                              pcfg)
    m = cfg.mla
    qk = m.nope_head_dim + m.rope_head_dim
    assert seen == [((1, cfg.n_heads, 9, qk), (1, cfg.n_heads, 9, qk),
                     (1, cfg.n_heads, 9, m.v_head_dim), 1 / np.sqrt(qk))]


def test_mla_decode_matches_the_reference_and_drops_past_the_end():
    """The absorbed decode from caches of ckv and kr at per-row lengths;
    a row at the cache's end writes nothing."""
    cfg, ra, pcfg, pa = mla_params()
    m = cfg.mla
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((3, 12, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((3, 12, m.rope_head_dim)).astype(np.float32)
    lengths = np.array([4, 11, 12], np.int32)
    want, wc, wk = rattn.mla_decode(ra, jnp.asarray(x), jnp.asarray(ckv),
                                    jnp.asarray(kr), jnp.asarray(lengths),
                                    cfg)
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got, gc, gk = attention.mla_decode(pa, torch.from_numpy(x), tc, tk,
                                       torch.as_tensor(lengths), pcfg)
    assert gc is tc and gk is tk                      # written in place
    close(got, want)
    close(gc, wc)
    close(gk, wk)
    assert torch.equal(gc[2], torch.from_numpy(ckv[2]))     # dropped row
    assert torch.equal(gk[2], torch.from_numpy(kr[2]))


def test_mla_decode_equals_the_forward_at_each_position():
    """Prefill-free decoding token by token from empty caches (float64:
    no rounding) gives the decompressed forward's outputs."""
    cfg, ra, pcfg, pa = mla_params()
    pa = {k: v.double() for k, v in pa.items()}
    x, pos = x_and_positions(cfg, 2, 10, seed=9)
    xt = torch.from_numpy(x).double()
    want = attention.mla_forward(pa, xt, torch.from_numpy(pos), pcfg,
                                 impl="naive")
    m = cfg.mla
    ckv = torch.zeros((2, 10, m.kv_lora_rank), dtype=torch.float64)
    kr = torch.zeros((2, 10, m.rope_head_dim), dtype=torch.float64)
    for t in range(10):
        got, ckv, kr = attention.mla_decode(pa, xt[:, t:t + 1], ckv, kr, t,
                                            pcfg)
        err = (got[:, 0] - want[:, t]).abs().max()
        assert err <= 1e-12 * want.abs().max(), (t, err)


# ------------------------------------------- the flash wrapper, DV != D --
# (B, Hq, Hkv, Sq, Sk, D, DV, causal): MLA's (192, 128) at a few heads, a
# continuation, rows with no live key, GQA, DV above D, non-causal
DV_CASES = [
    (1, 4, 4, 20, 20, 192, 128, True), (2, 4, 4, 8, 24, 192, 128, True),
    (1, 2, 2, 30, 12, 192, 128, True), (2, 4, 2, 16, 16, 24, 16, True),
    (1, 4, 1, 12, 20, 32, 64, True), (1, 2, 2, 9, 17, 48, 32, False),
]


def dv_inputs(case, seed=0):
    b, hq, hkv, sq, sk, d, dv, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv),
                      (b, hq, sq, dv))]


def xla(q, k, v, dout, causal):
    """``flash_attention_xla`` (the reference's ``chunked``) on (B, H, S, D)
    inputs, its LSE and its vjp; query i aligned with key i + Sk - Sq."""
    tr = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v, dout)]
    off = k.shape[2] - q.shape[2]
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(
        a, b, c, causal, off), *tr[:3])
    _, lse = rattn._flash_fwd_impl(*tr[:3], causal, off, None, 512)
    back = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(tr[3])]
    return np.asarray(out).transpose(0, 2, 1, 3), np.asarray(lse), back


@pytest.mark.parametrize("case", DV_CASES, ids=str)
def test_flash_wrapper_with_dv_matches_flash_attention_xla(case):
    """Output ``(B, Hq, Sq, DV)``, LSE and the grads of q, k, v through
    ``FlashAttentionFn`` (the plain versions on CPU tensors); rows with no
    live key give 0 (``flash_attention_xla`` gives the mean of v there, so
    only the live rows are compared)."""
    *_, sq, sk, d, dv, causal = case
    q, k, v, dout = dv_inputs(case)
    want, want_lse, want_grads = xla(q, k, v, dout, causal)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    live = slice(max(0, sq - sk) if causal else 0, None)
    out, lse = flash_attention_fwd(tq, tk, tv, causal=causal,
                                   return_lse=True)
    assert out.shape == (q.shape[0], q.shape[1], sq, dv)
    assert torch.equal(out, flash_attention(tq, tk, tv, causal=causal))
    close(out[:, :, live], want[:, :, live])
    close(lse[:, :, live], want_lse[:, :, live], rtol=1e-6)
    assert (out[:, :, :live.start] == 0).all()
    if live.start:
        return                     # the reference's vjp differs there
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    FlashAttentionFn.apply(*leaves, causal, None).backward(tdout)
    plain = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdout,
                                  causal=causal)
    for leaf, p, w in zip(leaves, plain, want_grads):
        assert leaf.grad.shape == w.shape and p.shape == w.shape
        close(leaf.grad, w)
        assert torch.equal(leaf.grad, p)


def test_the_kernel_takes_mlas_head_dims_and_no_larger():
    """``MAX_D``'s pairs: (128, 128) and (192, 128), and the backward's
    ``MAX_D_BWD`` the same pairs (the library's ``repro_flash_takes`` and
    ``repro_flash_bwd_takes`` are checked against them on the card)."""
    assert MAX_D == ((128, 128), (192, 128))
    assert MAX_D_BWD == MAX_D
    for pairs in (MAX_D, MAX_D_BWD):
        assert takes(192, 128, pairs) and takes(128, 128, pairs)
        assert takes(80, 80, pairs) and takes(24, 16, pairs)
        assert takes(64, 128, pairs) and takes(136, 64, pairs)
        assert not takes(192, 136, pairs) and not takes(200, 64, pairs)
        assert not takes(0, 64, pairs) and not takes(64, 0, pairs)


# (B, Hq, Hkv, Sq, Sk, D, DV, causal): MLA's (192, 128), causal and not,
# GQA, a continuation, rows with no live key
BWD_DV_CASES = [(2, 4, 4, 24, 24, 192, 128, True),
                (1, 4, 2, 16, 40, 192, 128, True),
                (1, 2, 2, 30, 12, 192, 128, True),
                (1, 4, 4, 17, 17, 192, 128, False)]


@pytest.mark.parametrize("case", BWD_DV_CASES, ids=str)
def test_attention_bwd_ref_at_mlas_head_dims_matches_jax_vjp(case):
    """The backward's plain version (what the kernel is held to on the
    card), called directly at (192, 128) with the forward's out and LSE:
    dq, dk, dv within 1e-5 of each max| of ``jax.vjp`` of
    ``flash_attention_xla``, on the live rows (the reference's mask value
    gives rows with no live key a mean of v, the port 0 and zero grads)."""
    *_, sq, sk, d, dv, causal = case
    q, k, v, dout = dv_inputs(case, seed=4)
    tq, tk, tv, tdout = map(torch.from_numpy, (q, k, v, dout))
    dead = max(0, sq - sk) if causal else 0
    tdout[:, :, :dead] = 0
    _, _, want = xla(q, k, v, tdout.numpy(), causal)
    out, lse = ref.attention_lse_ref(tq, tk, tv, causal=causal)
    got = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdout, causal=causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        if name == "dq":
            g, w = g[:, :, dead:], w[:, :, dead:]
        close(g, w, rtol=1e-5)


def test_the_output_keeps_qs_layout_with_its_own_head_dim():
    q = torch.zeros((2, 9, 4, 24)).transpose(1, 2)        # (B, H, S, D)
    out = _out_like(q, 16)
    assert out.shape == (2, 4, 9, 16)
    assert out.transpose(1, 2).is_contiguous()
    c = _out_like(torch.zeros((2, 4, 9, 24)), 16)
    assert c.is_contiguous() and c.shape == (2, 4, 9, 16)


def test_the_wrappers_reject_mismatched_kv():
    q, k = torch.zeros((1, 4, 8, 32)), torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, torch.zeros((1, 2, 9, 16)))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, k, torch.zeros((1, 1, 8, 32)))
    v = torch.zeros((1, 2, 8, 16))
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, out, lse, torch.zeros_like(q))
