"""The port's training path (``repro_torch.train``, ``repro_torch.data``,
``repro_torch.launch.train``) against the JAX package, on the CPU.

Weights are the reference's ``init_lm`` carried across with
``from_reference``; batches are the reference pipeline's, as numpy (the two
pipelines draw different streams by design).  Tolerances, fp32 smoke
configs:
  * three AdamW steps, each taken by both packages from the reference's
    state of that step (carried in by ``from_reference`` and
    ``opt_state_from_reference``): params within ``PARAM_RTOL`` = 1e-5 of
    each leaf's max|ref| (the same math summed in other orders); fp32
    moments within ``MOMENT_RTOL`` = 1e-4 of max|ref| (v squares the
    grads' rounding); int8 codes equal on at least 99.9% of entries and
    never more than one code apart but under 2^-16 of a block's absmax,
    scales within ``SCALE_RTOL`` = 1e-5 of
    each leaf's max scale (a scale is a block's absmax of the new moment,
    which carries the grads' last-bit differences: about 1.6e-6 measured);
    the loss of each step within ``LOSS_RTOL`` = 1e-6 relative.  With fp32
    moments the three steps also run free, each package on its own state,
    to ``PARAM_RTOL``.  With int8 moments a free run is held only loosely
    (``int8_params_close``): one code apart is a factor 2^(24/126) = 1.141
    in a moment entry, so a code that rounds the other way in one package
    changes that entry's later updates by up to 14%;
  * checkpoints carried across packages restore bit for bit, and two more
    steps match the other package's own run within ``PARAM_RTOL``;
  * a resumed run of the port's launcher equals a straight run bit for
    bit.
The AdamW steps and the checkpoints across packages run on the dense pair
and on the four FAMILIES (zamba2, xLSTM, deepseek-v3's MLA + MoE, grok-1's
GQA + MoE), whose parameters are compared in AdamW's unit and whose
grad-borne quantities at their grads' accuracy (``LR_BAND``,
``FLIP_SHARE``, ``GRAD_ACCURACY``: the dense pair's tolerances above do
not change).  AdamW's in-place update gives the same bits whether a leaf's
rows go in one chunk or in several.
The file also mirrors each case of ``tests/test_train.py`` on the port.
"""
import functools
import gc
import json
import os
import signal
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import TokenPipeline as RefPipeline
from repro.models.transformer import init_lm as ref_init
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import adamw as ref_adamw
from repro.train import build_train_step as ref_build_train_step
from repro.train import sgd as ref_sgd
from repro.train.optim import QTensor as RefQTensor
from repro.train.optim import cosine_schedule as ref_cosine
from repro.train.optim import dequantize_i8 as ref_dequantize
from repro.train.optim import quantize_i8 as ref_quantize
from repro_torch import configs
from test_torch_lm import with_qkv_biases
from repro_torch.data import TokenPipeline, synthetic_embeds
from repro_torch.launch.train import main, train
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.models.weights import (from_reference,
                                        opt_state_from_reference,
                                        opt_state_to_reference, to_reference)
from repro_torch.train import (CheckpointManager, adamw, build_train_step,
                               sgd)
from repro_torch.train.optim import (QTensor, cosine_schedule,
                                     dequantize_i8, quantize_i8, tree_leaves,
                                     tree_unflatten)

# the dense GQA archs: qwen2 and codeqwen with their qkv biases non-zero
# (``test_torch_lm.with_qkv_biases``), chameleon and musicgen trained from
# embeddings fed from outside (``ref_batch``)
ARCHS = ["qwen3-0.6b", "llama3.2-1b", "qwen2-72b", "codeqwen1.5-7b",
         "chameleon-34b", "musicgen-medium"]
# the families trained on the card since the dense pair: the recurrent
# (zamba2's Mamba2 + shared attention, xLSTM), MLA + MoE, GQA + MoE
FAMILIES = ["zamba2-2.7b", "xlstm-350m", "deepseek-v3-671b", "grok-1-314b"]
CPU = torch.device("cpu")
PARAM_RTOL = 1e-5
MOMENT_RTOL = 1e-4
LOSS_RTOL = 1e-6
SCALE_RTOL = 1e-5
CODES_EQUAL = 0.999
SMALL_CODE = 43          # |code| of 2^-16 of the block absmax: (24-16)·126/24+1
# int8 moments, free runs: entries within PARAM_RTOL (99.69% measured
# after four steps) and the worst entry (1.8e-4 of max|ref| measured)
INT8_WITHIN = 0.99
INT8_WORST = 1e-3
# The FAMILIES' parameters are compared in AdamW's own unit (``params_close``
# with ``lr_sum``).  AdamW scales each entry's step to about lr whatever its
# leaf's scale, so a grad near 0 whose fp32 sums differ between the packages
# moves its entry by a share of lr, however small the leaf: the zero-
# initialised conv biases of zamba2 and xLSTM hold nothing but such steps,
# and there PARAM_RTOL of max|ref| is far below one fp32 ulp of a step.  So
# each entry must sit within PARAM_RTOL of max|ref| plus LR_BAND of the
# steps' summed lr (up to 4.7% measured on the smoke configs), but for at
# most FLIP_SHARE of all entries: grads whose sign the two packages do not
# agree on (xLSTM's first step: 12 of 284952 entries, each within twice the
# lr, the most a sign can move a first step) and, with int8 moments run
# free, a second moment that rounds to code 0 in one package only, which
# moves its entry by lr·m/eps (deepseek-v3: 1 of 220240, 37 lr).
LR_BAND = 0.1
FLIP_SHARE = 1e-4
# How far an arch's fp32 grads sit from exact, where that is above the other
# tolerances: the sLSTM's exponential gates leave xLSTM's grads 2.6e-4 (the
# reference's, against its own float64 ones) to 4.4e-4 (the port's) of
# their leaf's max from exact at batch 4 x 32.  Its grad norm (4.9e-5
# apart measured), fp32 moments (5.9e-4) and int8 moments' scales are held
# to this, and their codes equal on 1 - 20x this (1.2% of codes differ at
# the first step; a code is 14% wide).
GRAD_ACCURACY = {"xlstm-350m": 1e-3}


def close(got, want, rtol):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def ref_tree(tree):
    """numpy leaves and port ``QTensor``s -> jax arrays and the
    reference's ``QTensor``s."""
    if isinstance(tree, dict):
        return {k: ref_tree(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return RefQTensor(jnp.asarray(tree.codes), jnp.asarray(tree.scale))
    return jnp.asarray(tree)


def ref_batch(cfg, step, batch=4, seq=32, seed=1):
    """The reference pipeline's batch ``step``; for an arch fed embeddings
    from outside (``embed_inputs=False``) its labels beside standard
    normal embeddings from a numpy seed of ``(seed, step)``, in place of
    the tokens."""
    b = RefPipeline(cfg.vocab, seq, batch, seed=seed).batch(step)
    out = {k: np.array(v) for k, v in b.items()}
    if not cfg.embed_inputs:
        del out["tokens"]
        out["embeds"] = np.random.default_rng([seed, step]).standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return out


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def ref_setup(arch, quantized, peak):
    """The reference's (cfg, params, opt, jitted step), built once per
    arguments in a worker: its trees are immutable, and the tests of one
    (arch, moments) share the step's compilation."""
    cfg = rconfigs.get_smoke(arch)
    ropt = ref_adamw(ref_cosine(peak, warmup=2, total=10),
                     quantized=quantized)
    return (cfg, with_qkv_biases(cfg, ref_init(jax.random.PRNGKey(0), cfg)),
            ropt, jax.jit(ref_build_train_step(cfg, ropt)))


def setup(arch, quantized, *, peak=3e-4):
    """-> reference (cfg, params, opt, jitted step) and port (cfg, params,
    opt, step), from the same weights and schedule."""
    cfg, rp, ropt, rstep = ref_setup(arch, quantized, peak)
    pcfg = configs.get_smoke(arch)
    pp = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
    popt = adamw(cosine_schedule(peak, warmup=2, total=10),
                 quantized=quantized)
    return ((cfg, rp, ropt, rstep),
            (pcfg, pp, popt, build_train_step(pcfg, popt)))


def assert_moments_match(ours, theirs, acc=None):
    """fp32 moments within MOMENT_RTOL; int8 codes equal on CODES_EQUAL of
    the entries and at most one code apart, scales within SCALE_RTOL.  With
    ``acc`` (``GRAD_ACCURACY``): moments and scales within ``acc`` where
    that is larger, codes equal on ``1 - 20·acc`` of each leaf, and at
    most ``acc`` of all entries more than one code apart (a grad whose
    sign the packages disagree on gives its first moment the other
    sign)."""
    moment_rtol, scale_rtol = MOMENT_RTOL, SCALE_RTOL
    codes_equal, apart, total = CODES_EQUAL, 0, 0
    if acc is not None:
        moment_rtol, scale_rtol = max(moment_rtol, acc), max(scale_rtol, acc)
        codes_equal = 1 - 20 * acc
    flat = jax.tree_util.tree_flatten(
        theirs, is_leaf=lambda x: isinstance(x, RefQTensor))[0]
    mine = tree_leaves(ours)
    assert len(flat) == len(mine)
    for o, t in zip(mine, flat):
        if isinstance(t, RefQTensor):
            got, want = o.codes.numpy().astype(int), np.asarray(t.codes,
                                                                 int)
            assert got.shape == want.shape
            assert (got == want).mean() >= codes_equal
            # one code apart, but for entries under 2^-16 of their
            # block's absmax (|code| <= SMALL_CODE), where the moments' own
            # last-bit differences (about 2^-20 of the leaf's largest
            # entry) are several code steps
            small = (np.abs(got) <= SMALL_CODE) & (np.abs(want) <= SMALL_CODE)
            apart += int(((np.abs(got - want) > 1) & ~small).sum())
            total += got.size
            close(o.scale, t.scale, scale_rtol)
        else:
            close(o, t, moment_rtol)
    assert apart <= (acc or 0.0) * total, (apart, total)


def params_close(ours, theirs, quantized, lr_sum=None):
    """Each leaf within PARAM_RTOL of its max|ref|; after free-running
    int8 steps, INT8_WITHIN of the entries so and all within INT8_WORST.
    With ``lr_sum`` (the FAMILIES; the summed lr of the steps the two
    packages took apart): every entry within PARAM_RTOL of its leaf's
    max|ref| plus LR_BAND · ``lr_sum``, but for at most FLIP_SHARE of all
    entries, which with fp32 moments stay within twice ``lr_sum``."""
    mine = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    if lr_sum is not None:
        outside, total = 0, 0
        for path, want in jax.tree_util.tree_flatten_with_path(theirs)[0]:
            want = np.asarray(want)
            err = np.abs(mine[path].detach().numpy() - want)
            base = PARAM_RTOL * np.abs(want).max()
            outside += int((err > base + LR_BAND * lr_sum).sum())
            total += err.size
            if not quantized:
                assert err.max() <= base + 2 * lr_sum, path
        assert outside <= FLIP_SHARE * total, (outside, total)
        return
    for path, want in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        if not quantized:
            close(mine[path], want, PARAM_RTOL)
            continue
        want = np.asarray(want)
        err = np.abs(mine[path].detach().numpy() - want)
        top = np.abs(want).max()
        assert (err <= PARAM_RTOL * top).mean() >= INT8_WITHIN, path
        assert err.max() <= INT8_WORST * top, path


# ------------------------------------------------------------ quantization --
@pytest.mark.parametrize("rows,last", [(1, 1), (2, 255), (3, 256), (4, 700),
                                       (1, 513)])
def test_quantize_roundtrip_error_bound(rows, last):
    """The reference's bound (log-spaced codes: under 7% relative error
    down to absmax · 2^-20, signs kept), and the reference's codes and
    scales on the same input."""
    rng = np.random.default_rng(rows * 1000 + last)
    x = (rng.standard_normal((rows, last)) * 3.0).astype(np.float32)
    codes, scale = quantize_i8(torch.from_numpy(x))
    y = dequantize_i8(codes, scale, x.shape).numpy()
    assert y.shape == x.shape and codes.dtype == torch.int8
    big = np.abs(x) > scale.numpy().max() * 2.0 ** -20
    rel = np.abs(x - y)[big] / np.abs(x)[big]
    assert rel.max() < 0.07, rel.max()
    assert np.all(np.sign(y[big]) == np.sign(x[big]))
    rc, rs = ref_quantize(jnp.asarray(x))
    assert (codes.numpy() == np.asarray(rc)).mean() >= CODES_EQUAL
    assert np.abs(codes.numpy().astype(int) - np.asarray(rc, int)).max() <= 1
    close(scale, rs, 1e-6)
    close(y, ref_dequantize(rc, rs, x.shape), 1e-6)


def test_quantized_adam_tracks_fp32():
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    opt_f = adamw(1e-2, weight_decay=0.0)
    opt_q = adamw(1e-2, weight_decay=0.0, quantized=True)
    pf, pq = {"w": w0.clone()}, {"w": w0.clone()}
    sf, sq = opt_f.init(pf), opt_q.init(pq)
    for _ in range(10):
        g = {"w": torch.from_numpy(
            rng.standard_normal((64, 512)).astype(np.float32))}
        sf, _ = opt_f.update(g, sf, pf)
        sq, _ = opt_q.update(g, sq, pq)
    rel = float((pf["w"] - pq["w"]).norm() / (pf["w"] - w0).norm())
    assert rel < 0.10, rel
    assert isinstance(sq["m"]["w"], QTensor)
    assert sq["m"]["w"].codes.dtype == torch.int8
    assert int(sq["step"]) == 10 and sq["step"].dtype == torch.int32


def test_cosine_schedule_matches_the_reference():
    """The reference's shape checks, and its values at steps 0-120 within
    two fp32 ulps (3e-7 relative: torch's and XLA's fp32 ``cos`` differ in
    the last bits at a few steps)."""
    lr = cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(lr(torch.tensor(10, dtype=torch.int32))) - 1e-3) < 1e-9
    assert float(lr(torch.tensor(100, dtype=torch.int32))) < 2e-4
    steps = np.arange(121, dtype=np.int32)
    ours = lr(torch.from_numpy(steps)).numpy()
    theirs = np.asarray(ref_cosine(1e-3, warmup=10, total=100)(
        jnp.asarray(steps)))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=3e-7, atol=0)


# -------------------------------------------------------------- train step --
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_three_adamw_steps_match_the_reference(arch, quantized):
    """Each step from the reference's state of that step; the FAMILIES'
    parameters in AdamW's unit and xLSTM's grad-borne quantities at its
    grads' accuracy (the module's note)."""
    (cfg, rp, ropt, rstep), (pcfg, _, popt, pstep) = setup(arch, quantized)
    acc = GRAD_ACCURACY.get(arch)
    rs = ropt.init(rp)
    for i in range(3):
        batch = ref_batch(cfg, i)
        pp = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
        ps = opt_state_from_reference(pcfg, jax.tree.map(np.asarray, rs),
                                      device=CPU)
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pp, ps, pm = pstep(pp, ps, port_batch(batch))
        assert abs(pm["loss"].item() - float(rm["loss"])) \
            <= LOSS_RTOL * abs(float(rm["loss"]))
        close(pm["lr"], rm["lr"], 1e-7)
        close(pm["grad_norm"], rm["grad_norm"], max(1e-5, acc or 0.0))
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        params_close(pp, rp, False,
                     float(rm["lr"]) if arch in FAMILIES else None)
        assert_moments_match(ps["m"], rs["m"], acc)
        assert_moments_match(ps["v"], rs["v"], acc)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adamw_update_is_the_same_in_row_chunks(monkeypatch, quantized,
                                                dtype):
    """The in-place update, a leaf's rows a chunk at a time (CHUNK_ELEMS
    cut to 700 elements: several chunks a leaf, a row of 1000 alone), gives
    the parameters and moments of one chunk a leaf bit for bit over three
    steps."""
    from repro_torch.train import optim
    gen = torch.Generator().manual_seed(0)

    def tree():
        return {"a": torch.randn((3, 5, 300), generator=gen).to(dtype),
                "b": torch.randn(7, generator=gen).to(dtype),
                "c": {"d": torch.randn((4, 1000), generator=gen).to(dtype)}}

    params = tree()
    twin = jax.tree.map(torch.clone, params)
    opt = adamw(cosine_schedule(1e-3, warmup=1, total=5),
                quantized=quantized)
    state, twin_state = opt.init(params), opt.init(twin)
    for _ in range(3):
        grads = tree()
        state, metrics = opt.update(grads, state, params)
        with monkeypatch.context() as m:
            m.setattr(optim, "CHUNK_ELEMS", 700)
            twin_state, twin_metrics = opt.update(grads, twin_state, twin)
        assert torch.equal(metrics["grad_norm"], twin_metrics["grad_norm"])
    assert int(state["step"]) == int(twin_state["step"]) == 3
    for a, b in zip(tree_leaves(params), tree_leaves(twin)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves({"m": state["m"], "v": state["v"]}),
                    tree_leaves({"m": twin_state["m"],
                                 "v": twin_state["v"]})):
        assert all(torch.equal(x, y) for x, y in zip(
            *((a, b) if isinstance(a, QTensor) else ((a,), (b,)))))


def test_a_step_frees_its_grads_without_the_cyclic_collector():
    """With the cyclic garbage collector off, nothing of a step's grads
    outlives the optimizer's update: ``tree_unflatten`` holds no reference
    cycle (a nested self-recursive helper kept the grads until a
    collection: on the card a whole grad tree a step, until memory ran
    out)."""
    cfg = configs.get_smoke("llama3.2-1b")
    opt = adamw(cosine_schedule(3e-4, warmup=2, total=10))
    params = init_lm(0, cfg, device=CPU)
    state = opt.init(params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = port_batch(ref_batch(rconfigs.get_smoke("llama3.2-1b"), 0))
    grads = torch.autograd.grad(lm_loss(params, cfg, batch)[0], leaves)
    refs = [weakref.ref(g) for g in grads]
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.no_grad():
            opt.update(tree_unflatten(params, grads), state, params)
        del grads
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_three_free_adamw_steps_match_the_reference():
    """fp32 moments, each package on its own state for three steps."""
    (cfg, rp, ropt, rstep), (pcfg, pp, popt, pstep) = setup("llama3.2-1b",
                                                            False)
    rs, ps = ropt.init(rp), popt.init(pp)
    for i in range(3):
        batch = ref_batch(cfg, i)
        rp, rs, _ = rstep(rp, rs, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        pp, ps, _ = pstep(pp, ps, port_batch(batch))
    params_close(pp, rp, False)
    assert_moments_match(ps["m"], rs["m"])
    assert_moments_match(ps["v"], rs["v"])


def test_train_loss_decreases():
    cfg = configs.get_smoke("llama3.2-1b")
    params = init_lm(0, cfg, device=CPU)
    opt = adamw(1e-3)
    state = opt.init(params)
    step = build_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab, 32, 8, seed=1)
    losses = []
    for i in range(20):
        params, state, m = step(params, state, pipe.batch(i))
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.1, losses[::5]


def test_grad_accum_matches_full_batch():
    cfg = configs.get_smoke("qwen3-0.6b")
    opt = sgd(1e-2)
    batch = TokenPipeline(cfg.vocab, 16, 8, seed=2).batch(0)
    p1 = init_lm(0, cfg, device=CPU)
    p1, _, m1 = build_train_step(cfg, opt)(p1, opt.init(p1), batch)
    p2 = init_lm(0, cfg, device=CPU)
    p2, _, m2 = build_train_step(cfg, opt, microbatches=4)(
        p2, opt.init(p2), batch)
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)
    err = max((a - b).abs().max().item()
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert err < 1e-4, err


def test_grad_accum_matches_the_reference():
    """Four microbatches against the reference's scan (SGD, as the
    reference's own accumulation test: AdamW's first step divides each
    grad by its own magnitude, which turns the last-bit differences of a
    grad near zero into a visible step)."""
    cfg = rconfigs.get_smoke("qwen3-0.6b")
    rp = ref_init(jax.random.PRNGKey(0), cfg)
    pcfg = configs.get_smoke("qwen3-0.6b")
    pp = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
    batch = ref_batch(cfg, 0, batch=8, seq=16)
    ropt, popt = ref_sgd(1e-2), sgd(1e-2)
    rp, _, rm = jax.jit(ref_build_train_step(cfg, ropt, microbatches=4))(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    pp, _, pm = build_train_step(pcfg, popt, microbatches=4)(
        pp, popt.init(pp), port_batch(batch))
    assert abs(pm["loss"].item() - float(rm["loss"])) \
        <= LOSS_RTOL * abs(float(rm["loss"]))
    mine = dict(jax.tree_util.tree_flatten_with_path(pp)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        close(mine[path], want, PARAM_RTOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-medium"])
def test_train_step_raises_for_a_leaf_the_loss_does_not_reach(arch):
    """Only the table under ``"embeds"`` is given zeros: any other leaf
    that has come loose from the loss makes the step raise."""
    cfg = configs.get_smoke(arch)
    params = init_lm(0, cfg, device=CPU)
    params["loose"] = torch.zeros(3)
    batch = port_batch(ref_batch(cfg, 0))
    step = build_train_step(cfg, adamw())
    with pytest.raises(RuntimeError, match="not have been used"):
        step(params, adamw().init(params), batch)


def test_train_step_refuses_a_mesh():
    """A mesh not bound to torch.distributed is refused (the sharded step
    and launcher: ``tests/test_torch_distributed.py``)."""
    cfg = configs.get_smoke("llama3.2-1b")
    with pytest.raises(TypeError, match="make_process_mesh"):
        build_train_step(cfg, adamw(), mesh=object())
    with pytest.raises(TypeError, match="make_process_mesh"):
        train("llama3.2-1b", steps=1, mesh=object(), device="cpu")


# ------------------------------------------------------------------- data --
def test_pipeline_step_addressed_determinism():
    pipe = TokenPipeline(1000, 64, 16, seed=3)
    a = pipe.batch(7)
    b = TokenPipeline(1000, 64, 16, seed=3).batch(7)
    assert torch.equal(a["tokens"], b["tokens"])
    c = pipe.batch(8)
    assert not torch.equal(a["tokens"], c["tokens"])
    # slicing equals slicing the global batch (elastic worker contract)
    sl = pipe.batch(7, batch_slice=slice(4, 8))
    assert torch.equal(sl["tokens"], a["tokens"][4:8])
    assert a["labels"][0, -1] == -1
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert a["tokens"].dtype == torch.int64
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 1000


def test_pipeline_draws_the_reference_distribution():
    """Not the same stream, the same law: the share of tokens that repeat
    their left neighbour + 1, and the share in each octave of token ids,
    within 0.02 of the reference pipeline's over 64 x 256 tokens."""
    vocab = 5000
    ours = TokenPipeline(vocab, 256, 64, seed=0).batch(0)["tokens"].numpy()
    theirs = np.asarray(RefPipeline(vocab, 256, 64, seed=0).batch(0)[
        "tokens"])

    def stats(t):
        bigram = (t[:, 1:] == (t[:, :-1] + 1) % vocab).mean()
        octaves = np.bincount(np.log2(t + 1).astype(int).ravel(),
                              minlength=14)[:14] / t.size
        return bigram, octaves

    (b0, o0), (b1, o1) = stats(ours), stats(theirs)
    assert abs(b0 - b1) < 0.02, (b0, b1)
    assert np.abs(o0 - o1).max() < 0.02, (o0, o1)


def test_synthetic_embeds_repeat_with_their_seed():
    a = synthetic_embeds(3, 2, 8, 16)
    assert a.shape == (2, 8, 16) and a.dtype == torch.float32
    assert torch.equal(a, synthetic_embeds(3, 2, 8, 16))
    assert not torch.equal(a, synthetic_embeds(4, 2, 8, 16))
    assert synthetic_embeds(3, 2, 8, 16, dtype=torch.bfloat16).dtype \
        == torch.bfloat16


# ------------------------------------------------------------- checkpoints --
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    codes, scale = quantize_i8(torch.linspace(-1, 1, 300)[None])
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
                       "c": torch.tensor(7, dtype=torch.int32),
                       "q": QTensor(codes, scale)}}
    for s in (10, 20, 30):
        mgr.save(s, tree, extra={"tag": s})
    assert mgr.all_steps() == [20, 30]      # keep=2 GC'd step 10
    like = {"a": torch.zeros(3, 4), "nested": {
        "b": torch.zeros(5, dtype=torch.bfloat16),
        "c": torch.tensor(0, dtype=torch.int32),
        "q": QTensor(torch.zeros_like(codes), torch.zeros_like(scale))}}
    back = mgr.restore(30, like)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        if isinstance(x, QTensor):
            assert isinstance(y, QTensor)
            assert all(torch.equal(a, b) for a, b in zip(x, y))
        else:
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert mgr.manifest(30)["extra"]["tag"] == 30
    man = mgr.manifest(30)["leaves"]
    assert man["nested\x1eb"] == {"shape": [5], "dtype": "bfloat16"}
    assert man["nested\x1eq\x1e.codes"]["dtype"] == "int8"
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(30, {**like, "extra": torch.zeros(1)})


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros((4,))})
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_uses_the_reference_format(tmp_path):
    """The same tree saved by both packages: the same leaf keys, shapes
    and dtype names in the manifest, the same bytes in each array."""
    (cfg, rp, ropt, _), (pcfg, pp, popt, _) = setup("qwen3-0.6b", True)
    RefCheckpointManager(str(tmp_path / "ref")).save(
        3, {"params": rp, "opt": ropt.init(rp)}, extra={"data_cursor": 3})
    CheckpointManager(str(tmp_path / "port")).save(
        3, {"params": pp, "opt": popt.init(pp)}, extra={"data_cursor": 3})
    mans = [json.loads((tmp_path / d / "step_3" / "manifest.json")
                       .read_text()) for d in ("ref", "port")]
    assert mans[0] == mans[1]
    arrays = [np.load(tmp_path / d / "step_3" / "arrays.npz")
              for d in ("ref", "port")]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    for key in arrays[0].files:
        a, b = arrays[0][key], arrays[1][key]
        assert a.dtype == b.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", ["llama3.2-1b"] + FAMILIES)
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch,
                                                     quantized):
    """The reference trains two steps and saves; the port restores (bit for
    bit) and trains two more, matching the reference's own four steps
    (``params_close``)."""
    (cfg, rp, ropt, rstep), (pcfg, pp, popt, pstep) = setup(arch, quantized)
    batches = [ref_batch(cfg, i) for i in range(4)]
    rs = ropt.init(rp)
    for i in range(2):
        rp, rs, _ = rstep(rp, rs, {k: jnp.asarray(v)
                                   for k, v in batches[i].items()})
    RefCheckpointManager(str(tmp_path)).save(2, {"params": rp, "opt": rs})
    state = CheckpointManager(str(tmp_path)).restore(
        2, {"params": pp, "opt": popt.init(pp)})
    params, opt_state = state["params"], state["opt"]
    saved = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(saved)))
    moments = opt_state_from_reference(pcfg, jax.tree.map(np.asarray, rs),
                                       device=CPU)
    for a, b in zip(tree_leaves(opt_state), tree_leaves(moments)):
        assert all(torch.equal(x, y) for x, y in zip(
            *((a, b) if isinstance(a, QTensor) else ((a,), (b,)))))
    lr_sum = 0.0
    for i in range(2, 4):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v)
                                    for k, v in batches[i].items()})
        params, opt_state, _ = pstep(params, opt_state,
                                     port_batch(batches[i]))
        lr_sum += float(rm["lr"])
    params_close(params, rp, quantized,
                 lr_sum if arch in FAMILIES else None)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b"] + FAMILIES)
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch,
                                                     quantized):
    """The port trains two steps and saves; the reference restores (bit for
    bit) and trains two more, matching the port's own four steps
    (``params_close``)."""
    (cfg, rp, ropt, rstep), (pcfg, pp, popt, pstep) = setup(arch, quantized)
    batches = [ref_batch(cfg, i) for i in range(4)]
    ps = popt.init(pp)
    for i in range(2):
        pp, ps, _ = pstep(pp, ps, port_batch(batches[i]))
    CheckpointManager(str(tmp_path)).save(2, {"params": pp, "opt": ps})
    like = jax.eval_shape(lambda: {"params": rp, "opt": ropt.init(rp)})
    state = RefCheckpointManager(str(tmp_path)).restore(2, like)
    want_p = jax.tree.map(jnp.asarray, to_reference(pp))
    want_s = ref_tree(opt_state_to_reference(ps))
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure({"params": want_p, "opt": want_s})
    for a, b in zip(jax.tree.leaves(state),
                    jax.tree.leaves({"params": want_p, "opt": want_s})):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rp, rs = state["params"], state["opt"]
    lr_sum = 0.0
    for i in range(2, 4):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v)
                                    for k, v in batches[i].items()})
        pp, ps, _ = pstep(pp, ps, port_batch(batches[i]))
        lr_sum += float(rm["lr"])
    params_close(pp, rp, quantized, lr_sum if arch in FAMILIES else None)


def test_weights_and_opt_state_carry_both_ways():
    (cfg, rp, ropt, rstep), (pcfg, pp, popt, pstep) = setup(
        "llama3.2-1b", True)
    back = to_reference(pp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(rp)[0],
                                 jax.tree_util.tree_flatten_with_path(back)
                                 [0]):
        assert np.array_equal(np.asarray(a), b), path
    bf = from_reference(pcfg, back, device=CPU, dtype=torch.bfloat16)
    assert to_reference(bf)["embed"].dtype == np.float32
    state = popt.init(pp)
    again = opt_state_from_reference(pcfg, opt_state_to_reference(state),
                                     device=CPU)
    assert int(again["step"]) == 0
    for a, b in zip(tree_leaves(state), tree_leaves(again)):
        assert all(torch.equal(x, y) for x, y in zip(*(
            (a, b) if isinstance(a, QTensor) else ((a,), (b,)))))
    bad = opt_state_to_reference(state)
    q = bad["m"]["embed"]
    bad["m"]["embed"] = QTensor(q.codes[:, :-256], q.scale)
    with pytest.raises(ValueError, match="embed"):
        opt_state_from_reference(pcfg, bad, device=CPU)
    del bad["v"]["final_norm"]
    bad["m"]["embed"] = q
    with pytest.raises(KeyError, match="final_norm"):
        opt_state_from_reference(pcfg, bad, device=CPU)


# ---------------------------------------------------------------- launcher --
def test_train_resume_bitwise(tmp_path):
    """Crash/resume: 10 steps straight == 5 steps + checkpoint + resume, bit
    for bit (the same ops in the same order from the same restored
    state)."""
    r1 = train("qwen3-0.6b", steps=10, batch=4, seq_len=32, seed=5,
               device="cpu")
    ck = str(tmp_path / "ck")
    train("qwen3-0.6b", steps=5, total_steps=10, batch=4, seq_len=32,
          seed=5, ckpt_dir=ck, ckpt_every=5, device="cpu")
    r2 = train("qwen3-0.6b", steps=10, batch=4, seq_len=32, seed=5,
               ckpt_dir=ck, ckpt_every=100, device="cpu")
    assert r1["history"][5:] == r2["history"]
    assert CheckpointManager(ck).manifest(5)["extra"]["data_cursor"] == 5


def test_preemption_hook_sets_the_flag(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)
    try:
        mgr.install_preemption_hook()
        assert not mgr.preempted
        signal.raise_signal(signal.SIGTERM)
        assert mgr.preempted
    finally:
        signal.signal(signal.SIGTERM, old)


def test_preempted_train_checkpoints_and_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(CheckpointManager, "install_preemption_hook",
                        lambda self: setattr(self, "_preempted", True))
    res = train("llama3.2-1b", steps=10, batch=2, seq_len=16,
                ckpt_dir=str(tmp_path), device="cpu")
    assert res["preempted"] and len(res["history"]) == 1
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [1]
    assert mgr.manifest(1)["extra"]["data_cursor"] == 1


def test_train_main_prints_its_final_loss(tmp_path, capsys):
    out = tmp_path / "res.json"
    main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq-len",
          "16", "--out", str(out)])
    text = capsys.readouterr().out
    assert "step     0 loss" in text
    final = float(text.strip().splitlines()[-1].split("final loss: ")[1])
    res = json.loads(out.read_text())
    assert res["final_loss"] == final and len(res["history"]) == 3


# The recorded points of grok-1's one-card curves with int8 moments on the
# cosine from 3e-4 (10 steps at 1 layer): ``--distributed=w`` (its first
# seven losses and its last) and ``--train-families`` (its first three,
# step 3's, step 7's and its last; it fell 0.28 from first to last).
GROK_SPIKES = {"distributed=w": [12.2871, 11.7306, 12.822, 15.8526, 12.939,
                                 12.3434, 25.0472, 15.6464],
               "train-families": [12.2871, 11.7306, 12.822, 15.7498,
                                  18.2786, 12.0073]}


def _chip_smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("run", sorted(GROK_SPIKES))
def test_loss_bar_fails_the_recorded_grok_curves(run):
    """The card's loss bar holds the whole curve: both grok-1 spikes fail
    it, the second only by its rise (it ends below its start)."""
    cs = _chip_smoke()
    hist = GROK_SPIKES[run]
    line, ok = cs.loss_bar(f"grok-1 {run}", hist)
    assert not ok and line.endswith("FAIL")
    assert max(hist) - hist[0] > cs.TRAIN_RISE
    assert str(hist) in line                 # the whole curve printed


def test_loss_bar_fails_deepseeks_spike():
    """deepseek-v3's 3-layer curve on the cosine from 3e-4 (the card's
    family run before its schedule moved): 16.44 nats up at step 4, 0.68
    down by step 10."""
    cs = _chip_smoke()
    assert not cs.loss_bar("deepseek-v3 3 layers", [
        12.2647, 11.4254, 15.2103, 28.7062, 19.0826, 14.2978, 12.8743,
        12.6097, 12.2834, 11.5865])[1]


def test_loss_bar_keeps_the_drop_and_passes_a_falling_curve():
    """The curves that train on the card hold the bar: zamba2-2.7b's
    (4.67 nats up at step 3, 1.65 down by step 10) and llama3.2-1b's over
    (2, 2) (1.25 up, 2.29 down); a flat or non-finite one fails."""
    cs = _chip_smoke()
    assert cs.loss_bar("zamba2-2.7b", [
        10.8911, 9.9836, 15.5593, 13.2313, 10.9018, 10.4257, 10.094, 9.6453,
        9.352, 9.2398])[1]
    assert cs.loss_bar("llama3.2-1b over (2, 2)", [
        12.2105, 11.7903, 13.4625, 11.8706, 11.7881, 11.0787, 10.6133,
        10.4362, 10.1406, 9.9247])[1]
    assert not cs.loss_bar("flat", [12.0, 11.95, 11.99])[1]
    assert not cs.loss_bar("nan", [12.0, float("nan"), 11.0])[1]
    assert cs.TRAIN_DROP == 0.1
