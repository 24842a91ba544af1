"""The port's mixture-of-experts slice against the JAX package, on the CPU.

``repro_torch.models.moe`` (``_route``, ``top_k``,
``aux_load_balance_loss``, ``moe_dense``, ``moe_apply``) against
``repro.models.moe`` on the same numpy inputs and weights, and the two MoE
archs end to end (``MOE_ARCHS``: deepseek-v3's MLA + sigmoid-routed
experts with a shared expert behind one dense layer, grok-1's GQA +
softmax-routed experts) at their fp32 smoke configs, the reference's
``init_lm`` weights carried across by ``from_reference``.

Tolerances: routing ids exactly equal (ties included: the lower expert
index first, as ``jax.lax.top_k``); weights, outputs, logits, caches and
the load-balancing loss within 1e-5 of max|ref| (the same fp32 math summed
in another order); ``lm_loss`` within 1e-6 relative and each grad leaf
within 1e-4 of its max|ref|; the engine's tokens equal the reference
engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import init_lm as ref_init
from repro.models.transformer import lm_decode_step as ref_decode
from repro.models.transformer import lm_forward as ref_forward
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.models.transformer import lm_prefill as ref_prefill
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.transformer import (init_caches, init_lm,
                                            lm_decode_step, lm_forward,
                                            lm_prefill)
from repro_torch.models.weights import (from_reference, param_dtypes,
                                        param_shapes, to_reference)
from test_torch_lm import (CPU, GRAD_RTOL, LOSS_RTOL, both, close,
                           port_loss_and_grads, run_both, tokens,
                           train_batch)

MOE_ARCHS = ["deepseek-v3-671b", "grok-1-314b"]


def moe_params(arch, layer=0):
    """The first MoE layer's ``moe`` params of the smoke config: the
    reference's (jax) and the port's (torch), the same numbers."""
    cfg, rp, pcfg, pp = both(arch)
    key = [k for k in pp if k.startswith("stage_") and "moe" in pp[k]][0]
    rm = jax.tree.map(lambda a: a[layer], rp[key]["moe"])
    pm = jax.tree.map(lambda a: a[layer], pp[key]["moe"])
    return cfg, rm, pcfg, pm


def hidden(cfg, shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_the_reference(arch):
    """Weights within 1e-5, ids and probs as the reference's; a block of
    zero tokens ties every expert (sigmoid 0.5, softmax 1/E) and must give
    ids 0..k-1, the reference's order."""
    cfg, rm, pcfg, pm = moe_params(arch)
    t = hidden(cfg, (40,), seed=1)
    t[:5] = 0.0
    rw, ri, rprobs = rmoe._route(rm, jnp.asarray(t), cfg.moe)
    w, i, probs = moe._route(pm, torch.from_numpy(t), pcfg.moe)
    assert np.array_equal(i.numpy(), np.asarray(ri))
    close(w, rw)
    close(probs, rprobs)
    assert (i[:5] == torch.arange(cfg.moe.top_k)).all()


def test_top_k_orders_ties_as_lax_top_k():
    """Equal values at and across the top-k boundary, and all equal."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, (64, 16)).astype(np.float32)
    x[0] = 1.0
    for k in (1, 3, 8, 16):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = moe.top_k(torch.from_numpy(x), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi))
        assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_load_balance_loss_matches_the_reference(arch):
    cfg, rm, pcfg, pm = moe_params(arch)
    t = hidden(cfg, (33,), seed=3)
    _, ri, rprobs = rmoe._route(rm, jnp.asarray(t), cfg.moe)
    want = rmoe.aux_load_balance_loss(rprobs, ri, cfg.moe.n_experts)
    _, i, probs = moe._route(pm, torch.from_numpy(t), pcfg.moe)
    got = moe.aux_load_balance_loss(probs, i, pcfg.moe.n_experts)
    close(got, want)
    assert got.item() > 0
    # averaging over mesh axes needs a mesh (tests/test_torch_moe_ep.py)
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.aux_load_balance_loss(probs, i, pcfg.moe.n_experts,
                                  axes=("data",))


@pytest.mark.parametrize("fn", ["moe_dense", "moe_apply"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_the_reference(arch, fn):
    """``moe_dense`` and ``moe_apply(mesh=None)`` (which runs it, as the
    reference does on one device): out and aux."""
    cfg, rm, pcfg, pm = moe_params(arch)
    x = hidden(cfg, (2, 21), seed=4)
    want, waux = getattr(rmoe, fn)(rm, jnp.asarray(x), cfg)
    got, aux = getattr(moe, fn)(pm, torch.from_numpy(x), pcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    close(got, want)
    close(aux, waux)


def test_moe_apply_refuses_a_mesh_and_the_expert_parallel_paths():
    """A mesh not bound to torch.distributed is refused; without a mesh
    the expert-parallel paths fall to the dense realization, as the
    reference's ``moe_apply`` does (the paths over a mesh:
    ``tests/test_torch_moe_ep.py``)."""
    cfg, rm, pcfg, pm = moe_params("grok-1-314b")
    x = torch.from_numpy(hidden(cfg, (1, 4)))
    with pytest.raises(TypeError, match="make_process_mesh"):
        moe.moe_apply(pm, x, pcfg, mesh=object())
    want, waux = rmoe.moe_apply(rm, jnp.asarray(x.numpy()), cfg, path="a2a")
    for path in ("a2a", "gathered"):
        got, aux = moe.moe_apply(pm, x, pcfg, path=path)
        assert torch.equal(got, moe.moe_dense(pm, x, pcfg)[0])
        close(got, want)
        close(aux, waux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_token_blocks_do_not_change_a_token(arch, monkeypatch):
    """Blocks of 3 tokens give the one-block result: each token's
    arithmetic is its own."""
    _, _, pcfg, pm = moe_params(arch)
    x = torch.from_numpy(hidden(pcfg, (2, 11), seed=5))
    whole, aux = moe.moe_dense(pm, x, pcfg)
    mo = pcfg.moe
    monkeypatch.setattr(moe, "BLOCK_ELEMS", 3 * mo.n_experts * mo.d_ff_expert)
    assert moe.token_block(pcfg) == 3
    blocked, aux3 = moe.moe_dense(pm, x, pcfg)
    close(blocked, whole.numpy(), rtol=1e-6)
    assert torch.equal(aux, aux3)


def test_moe_dense_runs_bf16_in_bf16():
    """A bf16 model's MoE returns bf16 and an fp32 aux; within bf16 rounding
    of the fp32 result on the same (bf16-representable) weights."""
    _, _, pcfg, pm = moe_params("deepseek-v3-671b")
    x = torch.from_numpy(hidden(pcfg, (1, 9), seed=6))
    pb = jax.tree.map(lambda t: t.bfloat16(), pm)
    got, aux = moe.moe_dense(pb, x.bfloat16(), pcfg)
    want, _ = moe.moe_dense(jax.tree.map(lambda t: t.float(), pb),
                            x.bfloat16().float(), pcfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    close(got.float(), want.numpy(), rtol=3e-2)


# ---------------------------------------------------------------- archs --
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_and_param_tree_equal_the_reference(arch):
    """Configs, ``params_count``, and the published (bf16) config's tree of
    shapes and dtypes against the reference's ``jax.eval_shape``; the
    smoke ``init_lm`` tree leaf by leaf."""
    for get in ("get", "get_smoke"):
        ours, theirs = getattr(configs, get)(arch), getattr(rconfigs, get)(
            arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.params_count() == theirs.params_count()
    full = jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0),
                                           rconfigs.get(arch)))
    assert jax.tree.map(lambda a: a.shape, full) == \
        param_shapes(configs.get(arch))
    assert jax.tree.map(lambda a: str(a.dtype), full) == jax.tree.map(
        lambda d: str(d).split(".")[-1], param_dtypes(configs.get(arch)))
    cfg, rp, pcfg, _ = both(arch)
    ours = init_lm(0, pcfg, device=CPU)
    assert jax.tree.map(lambda a: a.shape, rp) == jax.tree.map(
        lambda t: tuple(t.shape), ours)
    rc, pc = ref_init_caches(cfg, 2, 16), init_caches(pcfg, 2, 16,
                                                      device=CPU)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), rc) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                     pc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_weights_round_trip_bit_for_bit(arch):
    """``to_reference(from_reference(tree))`` is the tree, bit for bit, in
    fp32 and in bf16 (bf16-representable values)."""
    cfg, rp, pcfg, pp = both(arch)
    tree = jax.tree.map(np.asarray, rp)
    back = to_reference(pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    b16 = dataclasses.replace(pcfg, dtype="bfloat16")
    once = to_reference(from_reference(b16, tree, device=CPU))
    twice = to_reference(from_reference(b16, once, device=CPU))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(once), jax.tree.leaves(twice)))


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_forward_matches_reference(arch, impl):
    """Logits within 1e-5 of max|ref|; aux, the MoE layers' summed
    load-balancing loss, nonzero and within 1e-5."""
    cfg, rp, pcfg, pp = both(arch)
    toks = tokens(cfg.vocab, (2, 24))
    want, waux = ref_forward(rp, cfg, tokens=jnp.asarray(toks), impl=impl)
    got, aux = lm_forward(pp, pcfg, tokens=torch.as_tensor(toks), impl=impl)
    close(got, want)
    assert aux.item() > 0
    close(aux, waux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_prefill_then_decode_matches_reference(arch):
    """A padded prefill (``last_index``), its caches (MLA's ckv and kr,
    GQA's k and v), then three decode steps at per-row lengths from the
    reference's own caches: logits and every cache leaf."""
    cfg, rp, pcfg, pp = both(arch)
    toks = tokens(cfg.vocab, (3, 16), seed=1)
    want, rcache, rlen = ref_prefill(rp, cfg, tokens=jnp.asarray(toks),
                                     max_len=32, impl="chunked",
                                     last_index=jnp.int32(10))
    got, cache, length = lm_prefill(pp, pcfg, torch.as_tensor(toks),
                                    max_len=32, last_index=10)
    close(got, want)
    assert np.asarray(length).reshape(-1).tolist() == \
        np.asarray(rlen).reshape(-1).tolist()
    for key, stage in rcache.items():
        assert set(stage) == set(cache[key])
        for name, arr in stage.items():
            close(cache[key][name], arr)
    cache = {k: {n: torch.from_numpy(np.array(a)) for n, a in s.items()}
             for k, s in rcache.items()}
    lengths = np.array([5, 11, 16], np.int32)
    for step in range(3):
        tok = tokens(cfg.vocab, (3,), seed=2 + step)
        want, rcache = ref_decode(rp, cfg, jnp.asarray(tok), rcache,
                                  jnp.asarray(lengths + step))
        got, cache = lm_decode_step(pp, pcfg, torch.as_tensor(tok), cache,
                                    torch.as_tensor(lengths + step))
        close(got, want)
    for key, stage in rcache.items():
        for name, arr in stage.items():
            close(cache[key][name], arr)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_and_grads_match_the_reference(arch, impl):
    """``loss = ce + aux_weight · aux`` with a nonzero aux; the loss within
    1e-6, every grad leaf (the router's and the experts' included) within
    1e-4 of its max|ref|."""
    cfg, rp, pcfg, pp = both(arch)
    batch = train_batch(cfg.vocab, (2, 32), seed=3)
    (want, parts), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              impl=impl), has_aux=True)(rp)
    loss, ours, got = port_loss_and_grads(pp, pcfg, batch, impl=impl)
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert ours["aux"].item() > 0
    assert abs(ours["aux"].item() - float(parts["aux"])) \
        <= 1e-5 * abs(float(parts["aux"]))
    assert abs(loss.item() - ours["ce"].item() - 1e-2 * ours["aux"].item()) \
        <= 1e-6 * loss.item()
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(got)
    for (path, ref_g), g in zip(flat, got):
        close(g, np.asarray(ref_g), rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_equal_the_reference_engine(arch):
    """5 ragged prompts through 3 slots, 6 new tokens each (padded
    prefills: both archs are attention-only)."""
    rreqs, oreqs = run_both(arch, 3, 64, (5, 9, 12, 7, 11), 6, seed=1)
    assert all(r.done for r in oreqs)
    assert [r.out for r in oreqs] == [r.out for r in rreqs]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_stacks_each_stage_once(arch):
    """``init_lm`` writes each layer into stacked leaves: every stage
    leaf has its layers on axis 0, the draws differ between layers, and a
    one-layer stage is a view of its layer."""
    pcfg = configs.get_smoke(arch)
    params = init_lm(0, pcfg, device=CPU)
    again = init_lm(0, pcfg, device=CPU)
    for key, stage in params.items():
        if not key.startswith("stage_"):
            continue
        for leaf, twin in zip(jax.tree.leaves(stage),
                              jax.tree.leaves(again[key])):
            assert torch.equal(leaf, twin)
            if leaf.shape[0] > 1 and leaf.dim() > 2:
                assert not torch.equal(leaf[0], leaf[1])
