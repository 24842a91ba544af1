"""The port's recurrent blocks (``repro_torch/models/ssm.py``) against the
JAX package's ``repro/models/ssm.py``, on the CPU.

Inputs are made with numpy from a seed, parameters by the reference's
``init_*`` and carried across as they are.  Every function must agree
with its reference within RTOL of max|ref| in fp32 (the same arithmetic,
summed in another order).  The reference's own properties
(``tests/test_ssm.py``: the chunked form equals the token loop at any
chunk, a step equals the loop, a state handed over mid-sequence equals
one pass) are then held on the port alone, within the reference's 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch import configs
from repro_torch.models import ssm

RTOL = 1e-5
PROP_TOL = 1e-4


def close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def near(a, b, tol=PROP_TOL):
    """``np.testing.assert_allclose(a, b, rtol=tol, atol=tol)``, as the
    reference's property tests hold them."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def ssd_inputs(seed=0, b=2, S=32, H=4, P=8, G=2, N=4):
    """``tests/test_ssm.py``'s inputs: dt > 0 by softplus, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    D = rng.standard_normal((H,)).astype(np.float32)
    return x, dt, A, B, C, D


def mlstm_inputs(seed=0, b=2, S=32, H=2, P=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, S, H, P)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, S, H)).astype(np.float32)
    lf = -np.logaddexp(0, -(rng.standard_normal((b, S, H)) + 2.0)) \
        .astype(np.float32)                                # log_sigmoid
    return q, k, v, li, lf


def both(args):
    return [jnp.asarray(a) for a in args], [t(a) for a in args]


# ------------------------------------------------------------ elementary --
def test_softplus_is_jax_softplus_past_the_threshold():
    """``F.softplus`` turns into the identity above 20; jax's does not."""
    x = np.array([-50.0, -3.0, 0.0, 3.0, 19.5, 20.5, 40.0, 90.0], np.float32)
    got = ssm.softplus(t(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_tail else None
    want, wtail = rssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        tail=None if tail is None else jnp.asarray(tail))
    got, gtail = ssm._causal_conv(t(x), t(w), t(b),
                                  tail=None if tail is None else t(tail))
    close(got, want)
    close(gtail, wtail)


# ------------------------------------------------------------------- SSD --
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_seq_matches_reference(with_state):
    args = ssd_inputs(seed=2, S=12)
    state = np.random.default_rng(3).standard_normal(
        (2, 4, 4, 8)).astype(np.float32) if with_state else None
    (jr, tr) = both(args)
    want, ws = rssm.ssd_seq(*jr, state=None if state is None
                            else jnp.asarray(state))
    got, gs = ssm.ssd_seq(*tr, state=None if state is None else t(state))
    close(got, want)
    close(gs, ws)


@pytest.mark.parametrize("S,chunk", [(32, 4), (32, 8), (32, 16), (32, 32),
                                     (32, 64), (19, 8)])
def test_ssd_chunked_matches_reference(S, chunk):
    args = ssd_inputs(seed=4, S=S)
    state = np.random.default_rng(5).standard_normal(
        (2, 4, 4, 8)).astype(np.float32)
    jr, tr = both(args)
    want, ws = rssm.ssd_chunked(*jr, chunk=chunk, state=jnp.asarray(state))
    got, gs = ssm.ssd_chunked(*tr, chunk=chunk, state=t(state))
    close(got, want)
    close(gs, ws)


def test_ssd_chunked_grads_stay_finite_over_a_published_chunk():
    """zamba2's 128-token chunk at its init's ranges (A = -exp(A_log),
    A_log = log U(1, 16); dt in [1e-3, 0.1] plus headroom): the pairs above
    the chunk's diagonal reach exp(+200), past fp32.  The port masks them
    before the exp: every grad finite, and the ones the reference keeps
    finite (x, B, C, D) within RTOL of its; the reference's grads of dt and
    A are NaN there (its mask follows the exp)."""
    rng = np.random.default_rng(6)
    b, S, H, P, G, N = 1, 128, 8, 16, 1, 16
    args = [rng.standard_normal((b, S, H, P)).astype(np.float32),
            (0.05 + 0.1 * rng.random((b, S, H))).astype(np.float32),
            (-1 - 15 * rng.random(H)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32),
            np.ones(H, np.float32)]
    cot = rng.standard_normal((b, S, H, P)).astype(np.float32)

    def ref(*a):
        return jnp.vdot(rssm.ssd_chunked(*a, chunk=S)[0], jnp.asarray(cot))

    want = jax.grad(ref, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [t(a).requires_grad_(True) for a in args]
    y, _ = ssm.ssd_chunked(*leaves, chunk=S)
    got = torch.autograd.grad((y * t(cot)).sum(), leaves)
    assert all(torch.isfinite(g).all() for g in got)
    finite = [bool(jnp.isfinite(w).all()) for w in want]
    assert finite == [True, False, False, True, True, True]
    for g, w, ok in zip(got, want, finite):
        if ok:
            close(g, w)


def test_ssd_step_matches_reference():
    x, dt, A, B, C, D = ssd_inputs(seed=6, S=1)
    state = np.random.default_rng(7).standard_normal(
        (2, 4, 4, 8)).astype(np.float32)
    one = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, state)
    jr, tr = both(one)
    want, ws = rssm.ssd_step(*jr)
    got, gs = ssm.ssd_step(*tr)
    close(got, want)
    close(gs, ws)


# ----------------------------------------------------------------- mLSTM --
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_seq_matches_reference(with_state):
    args = mlstm_inputs(seed=8, S=12)
    rng = np.random.default_rng(9)
    state = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
             rng.standard_normal((2, 2, 8)).astype(np.float32),
             rng.standard_normal((2, 2)).astype(np.float32)) \
        if with_state else None
    jr, tr = both(args)
    want, ws = rssm.mlstm_seq(*jr, state=None if state is None
                              else tuple(map(jnp.asarray, state)))
    got, gs = ssm.mlstm_seq(*tr, state=None if state is None
                            else tuple(map(t, state)))
    close(got, want)
    for g, w in zip(gs, ws):
        close(g, w)


@pytest.mark.parametrize("S,chunk", [(32, 4), (32, 8), (32, 16), (32, 32),
                                     (19, 8)])
def test_mlstm_chunked_matches_reference(S, chunk):
    args = mlstm_inputs(seed=10, S=S)
    jr, tr = both(args)
    want, ws = rssm.mlstm_chunked(*jr, chunk=chunk)
    got, gs = ssm.mlstm_chunked(*tr, chunk=chunk)
    close(got, want)
    for g, w in zip(gs, ws):
        close(g, w)


def test_mlstm_step_matches_reference():
    """Two steps from a fresh state (``m = NEG``: ``exp(-m)`` is inf on
    the first, as in the reference)."""
    q, k, v, li, lf = mlstm_inputs(seed=11, S=2)
    jst = tst = None
    for i in range(2):
        one = (q[:, i], k[:, i], v[:, i], li[:, i], lf[:, i])
        jr, tr = both(one)
        want, jst = rssm.mlstm_step(*jr, jst)
        got, tst = ssm.mlstm_step(*tr, tst)
        close(got, want)
        for g, w in zip(tst, jst):
            close(g, w)


# ---------------------------------------------------------------- blocks --
def block_params(init, cfg, seed):
    """The reference's parameters and the same values as tensors."""
    p = init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return p, {k: t(v) for k, v in p.items()}


def handed_over(run, x, split):
    """``run(x, state)`` over ``[0, split)`` then ``[split, S)`` with the
    state carried: the outputs joined, and the last state."""
    y1, s1 = run(x[:, :split], None)
    y2, s2 = run(x[:, split:], s1)
    return np.concatenate([np.asarray(y1), np.asarray(y2)], 1), s2


@pytest.mark.parametrize("impl", ["chunked", "seq"])
def test_mamba2_forward_matches_reference(impl):
    """The whole sequence, then 11 tokens and 9 more from the handed-over
    state, each against the reference run the same way."""
    cfg = rconfigs.get_smoke("zamba2-2.7b")
    pcfg = configs.get_smoke("zamba2-2.7b")
    rp, tp = block_params(rssm.init_mamba2, cfg, 1)
    x = np.random.default_rng(12).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    for split in (None, 11):
        if split is None:
            want, ws = rssm.mamba2_forward(rp, jnp.asarray(x), cfg, impl=impl)
            got, gs = ssm.mamba2_forward(tp, t(x), pcfg, impl=impl)
        else:
            want, ws = handed_over(lambda a, s: rssm.mamba2_forward(
                rp, jnp.asarray(a), cfg, state=s, impl=impl), x, split)
            got, gs = handed_over(lambda a, s: ssm.mamba2_forward(
                tp, t(a), pcfg, state=s, impl=impl), x, split)
        close(got, want)
        for name in ("conv", "ssm"):
            close(gs[name], ws[name])


@pytest.mark.parametrize("impl", ["chunked", "seq"])
def test_mlstm_block_matches_reference(impl):
    cfg = rconfigs.get_smoke("xlstm-350m")
    pcfg = configs.get_smoke("xlstm-350m")
    rp, tp = block_params(rssm.init_mlstm, cfg, 2)
    x = np.random.default_rng(13).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    for split in (None, 10):
        if split is None:
            want, ws = rssm.mlstm_block(rp, jnp.asarray(x), cfg, impl=impl)
            got, gs = ssm.mlstm_block(tp, t(x), pcfg, impl=impl)
        else:
            want, ws = handed_over(lambda a, s: rssm.mlstm_block(
                rp, jnp.asarray(a), cfg, state=s, impl=impl), x, split)
            got, gs = handed_over(lambda a, s: ssm.mlstm_block(
                tp, t(a), pcfg, state=s, impl=impl), x, split)
        close(got, want)
        for name in ("conv", "C", "n", "m"):
            close(gs[name], ws[name])


def test_slstm_block_matches_reference():
    cfg = rconfigs.get_smoke("xlstm-350m")
    pcfg = configs.get_smoke("xlstm-350m")
    rp, tp = block_params(rssm.init_slstm, cfg, 3)
    x = np.random.default_rng(14).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32)
    for split in (None, 6):
        if split is None:
            want, ws = rssm.slstm_block(rp, jnp.asarray(x), cfg)
            got, gs = ssm.slstm_block(tp, t(x), pcfg)
        else:
            want, ws = handed_over(lambda a, s: rssm.slstm_block(
                rp, jnp.asarray(a), cfg, state=s), x, split)
            got, gs = handed_over(lambda a, s: ssm.slstm_block(
                tp, t(a), pcfg, state=s), x, split)
        close(got, want)
        for name in ("c", "n", "m", "h"):
            close(gs[name], ws[name])


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_init_and_state_trees_match_the_reference(kind):
    """Keys, shapes and dtypes of ``init_*`` and ``*_init_state`` under a
    bf16 model: the gate and decay leaves and the states stay fp32."""
    arch = "zamba2-2.7b" if kind == "mamba2" else "xlstm-350m"
    cfg = rconfigs.get_smoke(arch)
    pcfg = configs.get_smoke(arch)
    rp = getattr(rssm, f"init_{kind}")(jax.random.PRNGKey(0), cfg,
                                      jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    ours = getattr(ssm, f"init_{kind}")(gen, pcfg, torch.bfloat16)
    rs = getattr(rssm, f"{kind}_init_state")(cfg, 3, jnp.bfloat16)
    st = getattr(ssm, f"{kind}_init_state")(pcfg, 3, torch.bfloat16,
                                            device="cpu")
    for mine, theirs in ((ours, rp), (st, rs)):
        assert sorted(mine) == sorted(theirs)
        for name, leaf in theirs.items():
            assert tuple(mine[name].shape) == leaf.shape, name
            assert str(mine[name].dtype).split(".")[-1] == str(leaf.dtype), \
                name
    for name, leaf in rs.items():          # initial states are constants
        close(st[name], np.asarray(leaf, np.float32), rtol=0.0)
    for name in ("A_log", "D", "if_bias", "bias"):
        if name in rp:                     # deterministic leaves
            close(ours[name], np.asarray(rp[name]))


# ---------------------------------- the reference's properties, port alone --
@pytest.mark.parametrize("chunk", [4, 8, 16, 32, 64])
def test_ssd_chunked_equals_seq(chunk):
    args = [t(a) for a in ssd_inputs(seed=20)]
    y1, s1 = ssm.ssd_seq(*args)
    y2, s2 = ssm.ssd_chunked(*args, chunk=chunk)
    near(y1, y2)
    near(s1, s2)


@pytest.mark.parametrize("split", [1, 7, 8, 13, 24, 31])
def test_ssd_state_handoff(split):
    x, dt, A, B, C, D = (t(a) for a in ssd_inputs(seed=21))
    y_full, s_full = ssm.ssd_seq(x, dt, A, B, C, D)
    y1, s1 = ssm.ssd_chunked(x[:, :split], dt[:, :split], A, B[:, :split],
                             C[:, :split], D, chunk=8)
    y2, s2 = ssm.ssd_chunked(x[:, split:], dt[:, split:], A, B[:, split:],
                             C[:, split:], D, chunk=8, state=s1)
    near(torch.cat([y1, y2], 1), y_full)
    near(s2, s_full)


def test_ssd_step_equals_seq():
    x, dt, A, B, C, D = (t(a) for a in ssd_inputs(seed=22, S=8))
    y_ref, s_ref = ssm.ssd_seq(x, dt, A, B, C, D)
    s = torch.zeros_like(s_ref)
    ys = []
    for i in range(8):
        y, s = ssm.ssd_step(x[:, i], dt[:, i], A, B[:, i], C[:, i], D, s)
        ys.append(y)
    near(torch.stack(ys, 1), y_ref)
    near(s, s_ref)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mlstm_chunked_equals_seq(chunk):
    args = [t(a) for a in mlstm_inputs(seed=23)]
    h1, (C1, n1, m1) = ssm.mlstm_seq(*args)
    h2, (C2, n2, m2) = ssm.mlstm_chunked(*args, chunk=chunk)
    near(h1, h2)
    near(C1, C2)


@pytest.mark.parametrize("split", [4, 8, 12, 20, 28])
def test_mlstm_state_handoff(split):
    q, k, v, li, lf = (t(a) for a in mlstm_inputs(seed=24))
    h_full, st_full = ssm.mlstm_seq(q, k, v, li, lf)
    h1, st1 = ssm.mlstm_chunked(q[:, :split], k[:, :split], v[:, :split],
                                li[:, :split], lf[:, :split], chunk=8)
    h2, st2 = ssm.mlstm_chunked(q[:, split:], k[:, split:], v[:, split:],
                                li[:, split:], lf[:, split:], chunk=8,
                                state=st1)
    near(torch.cat([h1, h2], 1), h_full, 2e-4)
    near(st2[0], st_full[0], 2e-4)


def test_mlstm_step_equals_seq():
    q, k, v, li, lf = (t(a) for a in mlstm_inputs(seed=25, S=6))
    h_ref, _ = ssm.mlstm_seq(q, k, v, li, lf)
    st, hs = None, []
    for i in range(6):
        h, st = ssm.mlstm_step(q[:, i], k[:, i], v[:, i], li[:, i],
                               lf[:, i], st)
        hs.append(h)
    near(torch.stack(hs, 1), h_ref)


def test_mamba2_prefill_then_decode_equals_one_pass():
    cfg = configs.get_smoke("zamba2-2.7b")
    _, params = block_params(rssm.init_mamba2, rconfigs.get_smoke(
        "zamba2-2.7b"), 1)
    x = t(np.random.default_rng(26).standard_normal((2, 12, cfg.d_model)))
    y_full, st_full = ssm.mamba2_forward(params, x, cfg)
    _, st = ssm.mamba2_forward(params, x[:, :11], cfg)
    y_tok, st2 = ssm.mamba2_forward(params, x[:, 11:], cfg, state=st,
                                    impl="seq")
    near(y_tok, y_full[:, 11:])
    near(st2["ssm"], st_full["ssm"])


def test_slstm_state_handoff():
    cfg = configs.get_smoke("xlstm-350m")
    _, params = block_params(rssm.init_slstm, rconfigs.get_smoke(
        "xlstm-350m"), 2)
    x = t(np.random.default_rng(27).standard_normal((2, 10, cfg.d_model)))
    y_full, st_full = ssm.slstm_block(params, x, cfg)
    y1, st1 = ssm.slstm_block(params, x[:, :6], cfg)
    y2, st2 = ssm.slstm_block(params, x[:, 6:], cfg, state=st1)
    near(torch.cat([y1, y2], 1), y_full)
    near(st2["c"], st_full["c"])
