"""bf16 products of the port keep the reference's fp32 result.

The reference's ``layers.dot`` and ``moe_dense``'s expert products pass
``preferred_element_type=float32``: a bf16 product is its fp32 sum,
unrounded, and its VJP is ``dx = bf16(g @ wᵀ)``, ``dw = bf16(xᵀ @ g)``
with the fp32 cotangent ``g`` unrounded.  The port's ``layers.dot``
(``WideDot``) does the same; on the CPU it widens the operands, which is
the reference's arithmetic, so:
  * forwards within ``FWD_RTOL`` = 1e-6 of max|ref| (a bf16-rounded
    product, as the port's ``dot`` gave before, sits about 2e-3 away);
  * the VJP of a 2-D weight bit for bit;
  * the experts' form (``moe._experts``' up projections, ``"td,edf->tef"``):
    the weight's grad bit for bit, and x's grad (a sum over experts and
    columns) bit for bit but where the two packages' fp32 sums, taken in
    other orders, round to other bf16 values: each such entry must be the
    rounding of a value within the fp32 summation bound of the exact sum
    (``equal_but_sum_order``).
The end-to-end bf16 gap of each ported smoke arch against the reference's
bf16 forward is printed, not asserted (``-s`` shows it): other roundings
(norms, attention, the residual stream) set it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models.layers import dot as ref_dot
from repro.models.moe import moe_dense as ref_moe_dense
from repro.models.transformer import init_lm as ref_init
from repro.models.transformer import lm_forward as ref_forward
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.layers import WideDot, dot
from repro_torch.models.transformer import lm_forward
from repro_torch.models.weights import from_reference

FWD_RTOL = 1e-6
SHAPES = [((64, 256), (256, 96)), ((2, 32, 256), (256, 96)),
          ((3, 5, 7, 64), (64, 40))]
# (tokens, experts, d, d_ff_expert)
EXPERTS = [(48, 4, 128, 96), (17, 8, 64, 32)]


def pair(a: np.ndarray):
    """The same bf16 values (round to nearest even from fp32) in both."""
    return (torch.tensor(a).bfloat16(),
            jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def npf(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def fwd_rel(got, want) -> float:
    return float(np.abs(npf(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("xs,ws", SHAPES, ids=["2d", "3d", "4d"])
def test_dot_keeps_the_fp32_product_and_its_vjp(xs, ws):
    rng = np.random.default_rng(0)
    x, rx = pair(rng.standard_normal(xs, dtype=np.float32))
    w, rw = pair(rng.standard_normal(ws, dtype=np.float32))
    want, vjp = jax.vjp(ref_dot, rx, rw)
    want = np.asarray(want)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = dot(xg, wg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert fwd_rel(got, want) <= FWD_RTOL
    g = 3 * rng.standard_normal(want.shape, dtype=np.float32)
    rdx, rdw = vjp(jnp.asarray(g))
    dx, dw = torch.autograd.grad(got, (xg, wg), torch.tensor(g))
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_array_equal(npf(dx), npf(rdx))
    np.testing.assert_array_equal(npf(dw), npf(rdw))


def test_dot_without_grad_is_the_same_product():
    """No autograd record (serving): the same fp32 bits as ``WideDot``."""
    rng = np.random.default_rng(1)
    x, _ = pair(rng.standard_normal((2, 9, 64), dtype=np.float32))
    w, _ = pair(rng.standard_normal((64, 24), dtype=np.float32))
    with torch.no_grad():
        plain = dot(x, w)
    assert torch.equal(plain, WideDot.apply(x, w))


def test_dot_keeps_fp32_and_float64_on_matmul():
    """fp32 and float64 operands keep ``torch.matmul``'s product (a stack
    of experts as one batched product, the same bits on the CPU)."""
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.float64):
        x = torch.tensor(rng.standard_normal((5, 16)), dtype=dt)
        for ws in ((16, 8), (3, 16, 8)):
            w = torch.tensor(rng.standard_normal(ws), dtype=dt)
            got = dot(x, w)
            assert got.dtype == dt
            assert torch.equal(got, torch.matmul(x, w))


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
                   - 7)


def equal_but_sum_order(got: np.ndarray, want: np.ndarray,
                        exact: np.ndarray, abssum: np.ndarray,
                        terms: int) -> int:
    """Entries where the two bf16 results differ must each be the bf16
    rounding of a value within the fp32 summation error bound
    (``terms`` · 2^-24 · Σ|products|) of the exact sum: each package
    rounds its own fp32 sum.  -> the count of such entries."""
    differ = got != want
    tol = terms * 2.0 ** -24 * abssum[differ]
    for v in (got[differ], want[differ]):
        top = np.maximum(np.abs(v), np.abs(exact[differ]))
        assert (np.abs(v - exact[differ]) <= bf16_ulp(top) / 2 + tol).all()
    return int(differ.sum())


@pytest.mark.parametrize("n,E,d,ff", EXPERTS)
def test_expert_up_projections_keep_the_fp32_product(n, E, d, ff):
    """``moe._experts``' products ``dot(tb, wg)``, ``dot(tb, wi)`` against
    ``moe_dense``'s ``einsum("td,edf->tef", preferred_element_type=f32)``
    (the port keeps ``(E, n, ff)``)."""
    rng = np.random.default_rng(3)
    t, rt = pair(rng.standard_normal((n, d), dtype=np.float32))
    w, rw = pair(rng.standard_normal((E, d, ff), dtype=np.float32))

    def up(t, w):
        return jnp.einsum("td,edf->tef", t, w,
                          preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(up, rt, rw)
    want = np.asarray(want).transpose(1, 0, 2)
    tg, wg = t.clone().requires_grad_(), w.clone().requires_grad_()
    got = dot(tg, wg)
    assert got.dtype == torch.float32 and got.shape == (E, n, ff)
    assert fwd_rel(got, want) <= FWD_RTOL
    g = rng.standard_normal((E, n, ff), dtype=np.float32)
    rdt, rdw = vjp(jnp.asarray(g.transpose(1, 0, 2)))
    dt, dw = torch.autograd.grad(got, (tg, wg), torch.tensor(g))
    np.testing.assert_array_equal(npf(dw), npf(rdw))
    gw = g.astype(np.float64), npf(w).astype(np.float64)
    exact = np.einsum("enf,edf->nd", *gw)
    abssum = np.einsum("enf,edf->nd", *map(np.abs, gw))
    differ = equal_but_sum_order(npf(dt), npf(rdt), exact, abssum, E * ff)
    print(f"experts ({n}, {E}, {d}, {ff}): x's grad differs at {differ} "
          f"of {dt.numel()} entries, each within its fp32 sums' rounding")


def test_experts_match_moe_dense_in_bf16():
    """The whole expert pass of a bf16 model: the port's ``moe_dense``
    against the reference's on the same weights and tokens, bit for bit
    but where a bf16 rounding tie of one side's fp32 sums lands otherwise
    (each output one bf16 step at most, on under 1% of the entries)."""
    cfg = rconfigs.get_smoke("grok-1-314b")
    rng = np.random.default_rng(4)
    mo = cfg.moe
    d, ff = cfg.d_model, mo.d_ff_expert
    arrays = {"router": rng.standard_normal((d, mo.n_experts)) / d ** 0.5,
              "wi": rng.standard_normal((mo.n_experts, d, ff)) / d ** 0.5,
              "wg": rng.standard_normal((mo.n_experts, d, ff)) / d ** 0.5,
              "wo": rng.standard_normal((mo.n_experts, ff, d)) / ff ** 0.5}
    x = rng.standard_normal((2, 24, d))
    port = {k: pair(v.astype(np.float32))[0] for k, v in arrays.items()}
    ref = {k: pair(v.astype(np.float32))[1] for k, v in arrays.items()}
    out, _ = moe.moe_dense(port, pair(x.astype(np.float32))[0], cfg)
    want, _ = ref_moe_dense(ref, pair(x.astype(np.float32))[1], cfg)
    got, want = npf(out), npf(want)
    differ = got != want
    gap = np.abs(got - want)[differ]
    assert (gap <= np.abs(want[differ]) * 2.0 ** -7 * (1 + 1e-6)).all()
    assert differ.mean() < 1e-2, differ.mean()
    print(f"moe_dense bf16: {int(differ.sum())} of {got.size} outputs one "
          f"bf16 step apart")


@pytest.mark.parametrize("arch", configs.PORTED)
def test_bf16_end_to_end_gap_is_printed(arch):
    """A bf16 ``lm_forward`` of the smoke arch against the reference's bf16
    forward on the same weights and tokens, as a share of max|logits| of
    the fp32 forward of those weights: printed, and only its finiteness
    asserted (the smoke deepseek-v3's sigmoid top-2 routing turns the
    projections' last-bit differences into expert flips: 2.769e-01, where
    its MLA and MoE blocks alone agree to a few entries in 10^3)."""
    cfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    rp = ref_init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16))
    want = npf(ref_forward(rp, cfg, jnp.asarray(tokens))[0])
    r32 = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    c32 = dataclasses.replace(cfg, dtype="float32")
    scale = np.abs(npf(ref_forward(r32, c32, jnp.asarray(tokens))[0])).max()
    pp = from_reference(pcfg, jax.tree.map(npf, rp),
                        device=torch.device("cpu"))
    with torch.no_grad():
        got = npf(lm_forward(pp, pcfg, torch.as_tensor(tokens))[0])
    gap = float(np.abs(got - want).max() / scale)
    print(f"{arch}: bf16 logits vs the reference's bf16 forward: "
          f"{gap:.3e} of max|fp32 logits|")
    assert np.isfinite(got).all() and np.isfinite(gap)


def test_expert_grads_take_every_token_at_once(monkeypatch):
    """Where a grad is wanted ``moe_dense`` takes all tokens in one block,
    whatever ``BLOCK_ELEMS`` says, so each expert weight's grad is one
    fp32 product over every token rounded once (blocks of 3 tokens would
    add bf16 grads in bf16: most entries a bf16 step or more off).  The
    grads equal the unblocked ones bit for bit, and the reference's VJP of
    its ``moe_dense`` but where one side's fp32 sums, taken in another
    order, round otherwise: on under 1% of the entries, each within a bf16
    step of itself or, where the sum cancels, 2^-16 of the leaf's max."""
    cfg = rconfigs.get_smoke("grok-1-314b")
    rng = np.random.default_rng(6)
    mo = cfg.moe
    d, ff = cfg.d_model, mo.d_ff_expert
    arrays = {"router": rng.standard_normal((d, mo.n_experts)) / d ** 0.5,
              "wi": rng.standard_normal((mo.n_experts, d, ff)) / d ** 0.5,
              "wg": rng.standard_normal((mo.n_experts, d, ff)) / d ** 0.5,
              "wo": rng.standard_normal((mo.n_experts, ff, d)) / ff ** 0.5}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    g = rng.standard_normal((2, 24, d)).astype(np.float32)
    names = ("wg", "wi", "wo")

    def port_grads():
        port = {k: pair(v.astype(np.float32))[0] for k, v in arrays.items()}
        for k in names:
            port[k].requires_grad_()
        out, _ = moe.moe_dense(port, pair(x)[0], cfg)
        return torch.autograd.grad(out, [port[k] for k in names],
                                   pair(g)[0])

    whole = port_grads()
    monkeypatch.setattr(moe, "BLOCK_ELEMS", 3 * mo.n_experts * ff)
    assert moe.token_block(cfg) == 3
    blocked = port_grads()
    for a, b in zip(blocked, whole):
        assert torch.equal(a, b)
    ref = {k: pair(v.astype(np.float32))[1] for k, v in arrays.items()}

    def ref_out(ws):
        return ref_moe_dense({**ref, **dict(zip(names, ws))},
                             pair(x)[1], cfg)[0]

    _, vjp = jax.vjp(ref_out, [ref[k] for k in names])
    (want,) = vjp(pair(g)[1])
    for name, a, b in zip(names, whole, want):
        got, want_ = npf(a), npf(b)
        differ = got != want_
        gap = np.abs(got - want_)[differ]
        assert (gap <= np.abs(want_[differ]) * 2.0 ** -7 * (1 + 1e-6)
                + np.abs(want_).max() * 2.0 ** -16).all()
        assert differ.mean() < 1e-2, (name, differ.mean())
        print(f"moe_dense bf16 {name} grad: {int(differ.sum())} of "
              f"{got.size} entries one bf16 step from the reference's")
