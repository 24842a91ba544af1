"""The port's LM serving slice against the JAX package, on the CPU.

The reference's ``init_lm`` weights are carried across with
``repro_torch.models.weights.from_reference``; tokens are made with numpy.
Logits and caches of ``lm_forward``, ``lm_prefill`` and ``lm_decode_step``
must agree within 1e-5 of max|ref| (fp32 smoke configs: the same
arithmetic, summed in another order), and the port's ``ServeEngine`` must
emit exactly the reference engine's tokens on the request sets of
``tests/test_serve.py`` (a shorter set for the recurrent archs, whose
reference engine compiles a prefill per exact prompt length).  The dense
GQA archs (``ARCHS``: qwen2 and codeqwen with their qkv biases, drawn
non-zero from a seed in both packages, as the reference's ``init_gqa``
draws them as zeros; chameleon with qk-norm and musicgen with sinusoidal
positions and the gelu MLP, both fed token ids here and embeddings in
``tests/test_torch_embeds.py``) and the recurrent family (``REC_ARCHS``:
zamba2's Mamba2 backbone with shared GQA blocks, xLSTM's mLSTM and sLSTM)
go through the same tests wherever a test applies to both (``ALL``).
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch.serve import serve as ref_serve
from repro.models.attention import gqa_decode as ref_gqa_decode
from repro.models.attention import gqa_forward as ref_gqa_forward
from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import init_lm as ref_init
from repro.models.transformer import lm_decode_step as ref_decode
from repro.models.transformer import lm_forward as ref_forward
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.models.transformer import lm_prefill as ref_prefill
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.launch.serve import serve
from repro_torch.models.attention import gqa_decode, gqa_forward
from repro_torch.models.layers import causal_mask, cross_entropy
from repro_torch.models.transformer import (init_caches, init_lm,
                                            lm_decode_step, lm_forward,
                                            lm_loss, lm_prefill)
from repro_torch.models.weights import (from_reference, param_dtypes,
                                        param_shapes)
from repro_torch.serve import ServeEngine

ARCHS = ["qwen3-0.6b", "llama3.2-1b", "qwen2-72b", "codeqwen1.5-7b",
         "chameleon-34b", "musicgen-medium"]
REC_ARCHS = ["zamba2-2.7b", "xlstm-350m"]
ALL = ARCHS + REC_ARCHS
RTOL = 1e-5
CPU = torch.device("cpu")


def close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def with_qkv_biases(cfg, rp, seed=0):
    """The reference's params with every attention stage's ``bq``, ``bk``
    and ``bv`` drawn from a numpy seed (std 0.5), where the config has
    them: its ``init_gqa`` makes them zeros, which would leave the bias
    add untested."""
    if not cfg.qkv_bias:
        return rp
    rng = np.random.default_rng(seed + 100)
    rp = dict(rp)
    for key, stage in rp.items():
        if isinstance(stage, dict) and "attn" in stage \
                and "bq" in stage["attn"]:
            attn = {n: (jnp.asarray((rng.standard_normal(a.shape) * 0.5)
                                    .astype(np.float32)).astype(a.dtype)
                        if n in ("bq", "bk", "bv") else a)
                    for n, a in stage["attn"].items()}
            rp[key] = {**stage, "attn": attn}
    return rp


def both(arch, seed=0):
    """-> (cfg, reference params, port cfg, port params on the CPU); qkv
    biases non-zero (``with_qkv_biases``)."""
    cfg = rconfigs.get_smoke(arch)
    rp = with_qkv_biases(cfg, ref_init(jax.random.PRNGKey(seed), cfg), seed)
    pcfg = configs.get_smoke(arch)
    return cfg, rp, pcfg, from_reference(
        pcfg, jax.tree.map(np.asarray, rp), device=CPU)


def tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ALL)
def test_configs_equal_the_reference(arch):
    for get in ("get", "get_smoke"):
        ours = getattr(configs, get)(arch)
        theirs = getattr(rconfigs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.params_count() == theirs.params_count()


def test_every_reference_arch_is_ported():
    assert configs.PORTED == configs.ARCHS == rconfigs.ARCHS
    for arch in rconfigs.ARCHS:
        assert configs.get(arch).name == rconfigs.get(arch).name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-2")


@pytest.mark.parametrize("arch", ALL)
def test_param_tree_matches_the_reference(arch):
    """Keys, shapes and dtypes of ``init_lm``, and ``param_shapes`` and
    ``param_dtypes`` of the published (bf16) config against the
    reference's (by ``jax.eval_shape``): the recurrent blocks' fp32
    leaves stay fp32."""
    cfg, rp, pcfg, _ = both(arch)
    ours = init_lm(0, pcfg, device=CPU)
    flat_r = jax.tree_util.tree_flatten_with_path(rp)[0]
    flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert sorted(map(str, flat_o)) == sorted(str(p) for p, _ in flat_r)
    for path, leaf in flat_r:
        mine = flat_o[path]
        assert tuple(mine.shape) == leaf.shape, path
        assert str(mine.dtype).split(".")[-1] == str(leaf.dtype), path
    full = jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0),
                                           rconfigs.get(arch)))
    shapes = jax.tree.map(lambda a: a.shape, full)
    assert shapes == param_shapes(configs.get(arch))
    dtypes = jax.tree.map(lambda a: str(a.dtype), full)
    assert dtypes == jax.tree.map(lambda d: str(d).split(".")[-1],
                                  param_dtypes(configs.get(arch)))


@pytest.mark.parametrize("arch", ALL)
def test_bf16_weights_keep_the_reference_dtypes(arch):
    """Under a bf16 model, ``init_lm`` and ``from_reference`` give every
    leaf the reference's dtype: the model dtype, but fp32 for mamba2's
    ``A_log``, ``dt_bias`` and ``D``, mLSTM's ``if_bias`` and sLSTM's
    ``bias``; the caches likewise (fp32 states, bf16 K/V and conv
    tails)."""
    cfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype="bfloat16")
    pcfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    rp = ref_init(jax.random.PRNGKey(0), cfg)
    want = {str(p): str(a.dtype)
            for p, a in jax.tree_util.tree_flatten_with_path(rp)[0]}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    for ours in (init_lm(0, pcfg, device=CPU),
                 from_reference(pcfg, tree, device=CPU)):
        got = {str(p): str(a.dtype).split(".")[-1]
               for p, a in jax.tree_util.tree_flatten_with_path(ours)[0]}
        assert got == want
    fp32 = [p for p, d in want.items() if d == "float32"]
    assert bool(fp32) == (arch in REC_ARCHS), fp32
    rc = ref_init_caches(cfg, 2, 16)
    pc = init_caches(pcfg, 2, 16, device=CPU)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), rc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                     pc)


def test_from_reference_rejects_a_bad_tree():
    cfg, rp, pcfg, _ = both("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, rp)
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        from_reference(pcfg, missing, device=CPU)
    extra = {**tree, "stage_0": {**tree["stage_0"], "bias": np.zeros(3)}}
    with pytest.raises(KeyError, match="bias"):
        from_reference(pcfg, extra, device=CPU)
    wrong = {**tree, "embed": tree["embed"][:, :-1]}
    with pytest.raises(ValueError, match="embed"):
        from_reference(pcfg, wrong, device=CPU)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", ALL)
def test_lm_forward_matches_reference(arch, impl):
    cfg, rp, pcfg, pp = both(arch)
    toks = tokens(cfg.vocab, (2, 24))
    want, _ = ref_forward(rp, cfg, tokens=jnp.asarray(toks), impl=impl)
    got, aux = lm_forward(pp, pcfg, tokens=torch.as_tensor(toks), impl=impl)
    close(got, want)
    assert aux == 0.0


@pytest.mark.parametrize("last_index", [None, 10])
@pytest.mark.parametrize("arch", ALL)
def test_lm_prefill_matches_reference(arch, last_index):
    cfg, rp, pcfg, pp = both(arch)
    toks = tokens(cfg.vocab, (1, 16), seed=1)
    want, rcache, rlen = ref_prefill(
        rp, cfg, tokens=jnp.asarray(toks), max_len=40, impl="chunked",
        last_index=None if last_index is None else jnp.int32(last_index))
    got, cache, length = lm_prefill(pp, pcfg, tokens=torch.as_tensor(toks),
                                    max_len=40, last_index=last_index)
    close(got, want)
    assert np.asarray(length).reshape(-1).tolist() == \
        np.asarray(rlen).reshape(-1).tolist()
    for key, stage in rcache.items():
        for name, arr in stage.items():
            close(cache[key][name], arr)


@pytest.mark.parametrize("arch", ALL)
def test_lm_decode_step_matches_reference(arch):
    """One step with per-row lengths from caches the reference prefilled."""
    cfg, rp, pcfg, pp = both(arch)
    toks = tokens(cfg.vocab, (3, 16), seed=2)
    _, rcache, _ = ref_prefill(rp, cfg, tokens=jnp.asarray(toks),
                               max_len=32, impl="chunked")
    cache = {k: {n: torch.from_numpy(np.array(a)) for n, a in s.items()}
             for k, s in rcache.items()}
    step = tokens(cfg.vocab, (3,), seed=3)
    lengths = np.array([5, 9, 12], np.int32)
    want, rnew = ref_decode(rp, cfg, jnp.asarray(step), rcache,
                            jnp.asarray(lengths))
    got, new = lm_decode_step(pp, pcfg, torch.as_tensor(step), cache,
                              torch.as_tensor(lengths))
    close(got, want)
    for key, stage in rnew.items():
        for name, arr in stage.items():
            close(new[key][name], arr)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward_matches_reference(arch, impl):
    cfg, rp, pcfg, pp = both(arch)
    x = np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20), (2, 20))
    attn_r = jax.tree.map(lambda a: a[1], rp["stage_0"]["attn"])
    want = ref_gqa_forward(attn_r, jnp.asarray(x), jnp.asarray(pos), cfg,
                           impl=impl)
    attn = {k: a[1] for k, a in pp["stage_0"]["attn"].items()}
    got = gqa_forward(attn, torch.from_numpy(x),
                      torch.from_numpy(pos.copy()), pcfg, impl=impl)
    close(got, want)


def test_gqa_decode_drops_a_row_past_the_cache():
    """A length at the cache's end writes nothing, as ``mode="drop"``."""
    cfg, rp, pcfg, pp = both("qwen3-0.6b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 8, cfg.n_kv_heads, 32))
              .astype(np.float32) for _ in range(2))
    lengths = np.array([3, 8], np.int32)
    attn_r = jax.tree.map(lambda a: a[0], rp["stage_0"]["attn"])
    want, wk, wv = ref_gqa_decode(attn_r, jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(lengths), cfg)
    attn = {k: a[0] for k, a in pp["stage_0"]["attn"].items()}
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = gqa_decode(attn, torch.from_numpy(x), tk, tv,
                             torch.as_tensor(lengths), pcfg)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    assert torch.equal(gk[1], torch.from_numpy(ck[1]))      # dropped row


def run_both(arch, slots, max_len, sizes, max_new, seed):
    cfg, rp, pcfg, pp = both(arch)
    rng = np.random.default_rng(seed)
    batch = [rng.integers(0, cfg.vocab, size=n) for n in sizes]
    ref = RefEngine(cfg, rp, slots=slots, max_len=max_len)
    ours = ServeEngine(pcfg, pp, slots=slots, max_len=max_len)
    rreqs = [ref.submit(p, max_new=max_new) for p in batch]
    oreqs = [ours.submit(p, max_new=max_new) for p in batch]
    ref.run()
    ours.run()
    return rreqs, oreqs


@pytest.mark.parametrize("arch", ALL)
def test_engine_tokens_equal_the_reference_engine(arch):
    """``test_serve.py``'s set: 5 ragged prompts through 3 slots; for the
    recurrent archs 3 prompts of 2 lengths through 2 slots (a slot
    recycled), 4 new tokens each."""
    if arch in REC_ARCHS:
        rreqs, oreqs = run_both(arch, 2, 32, (5, 9, 5), 4, seed=1)
    else:
        rreqs, oreqs = run_both(arch, 3, 64, (5, 9, 12, 7, 11), 6, seed=1)
    assert all(r.done for r in oreqs)
    assert [r.out for r in oreqs] == [r.out for r in rreqs]


def test_engine_slot_recycling_equals_the_reference_engine():
    rreqs, oreqs = run_both("qwen3-0.6b", 2, 48, (6,) * 7, 4, seed=2)
    assert all(r.done and len(r.out) == 4 for r in oreqs)
    assert [r.out for r in oreqs] == [r.out for r in rreqs]


def test_engine_eos_equals_the_reference_engine():
    cfg, rp, pcfg, pp = both("llama3.2-1b")
    engines = (RefEngine(cfg, rp, slots=1, max_len=64),
               ServeEngine(pcfg, pp, slots=1, max_len=64))
    outs = []
    for eng in engines:
        rng = np.random.default_rng(3)
        probe = eng.submit(rng.integers(0, cfg.vocab, size=8), max_new=1)
        eng.run()
        req = eng.submit(rng.integers(0, cfg.vocab, size=8), max_new=16,
                         eos_id=probe.out[0])
        eng.run()
        assert req.done and len(req.out) <= 16
        if probe.out[0] in req.out:
            assert req.out[-1] == probe.out[0]
        outs.append((probe.out, req.out))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ALL)
def test_engine_matches_full_forward(arch):
    """The port's continuous batching reproduces the port's own greedy
    full-forward decoding (``tests/test_serve.py``'s check, in the port)."""
    pcfg = configs.get_smoke(arch)
    params = init_lm(0, pcfg, device=CPU)
    eng = ServeEngine(pcfg, params, slots=3, max_len=64)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(0, pcfg.vocab, size=n), max_new=6)
            for n in (5, 9, 12, 7, 11)]
    eng.run()
    assert all(r.done for r in reqs)
    for r in reqs:
        toks = np.concatenate([r.prompt, r.out[:-1]])
        logits, _ = lm_forward(params, pcfg,
                               tokens=torch.as_tensor(toks)[None])
        want = logits[0, len(r.prompt) - 1:].argmax(-1).tolist()
        assert r.out == want, (r.rid, r.out, want)


@pytest.mark.parametrize("arch", ALL)
def test_float64_prefill_then_decode_equals_the_forward(arch):
    """A float64 model runs in float64 throughout (``layers.wide``, the
    recurrences' ``acc``): a chunked prefill of 12 tokens and 17 decode
    steps give one full forward's logits within 1e-12 of max|logits|, and
    every cache leaf is float64."""
    pcfg = configs.get_smoke(arch)
    params = jax.tree.map(lambda t: t.double(), init_lm(0, pcfg, device=CPU))
    toks = torch.as_tensor(tokens(pcfg.vocab, (1, 30), seed=6))
    logits, cache, _ = lm_prefill(params, pcfg, toks[:, :12], max_len=32,
                                  impl="naive")
    got = [logits]
    for t in range(12, 29):
        logits, cache = lm_decode_step(params, pcfg, toks[:, t], cache, t)
        got.append(logits)
    want, _ = lm_forward(params, pcfg, toks[:, :29], impl="naive")
    err = (torch.stack(got, 1) - want[:, 11:]).abs().max()
    assert err <= 1e-12 * want.abs().max(), err
    assert {str(t.dtype) for t in jax.tree.leaves(cache)} == \
        {"torch.float64"}


@pytest.mark.parametrize("arch", ALL)
def test_engine_prefills_recurrent_models_at_their_exact_length(
        arch, monkeypatch):
    """An attention-only model is prefilled at its 16-token bucket with
    ``last_index``; a model with a recurrent block at the exact prompt
    length, without one (its state would absorb the pads)."""
    import repro_torch.serve.engine as engine_mod
    seen = []
    real = engine_mod.lm_prefill

    def spy(params, cfg, tokens, **kw):
        seen.append((tokens.shape[1], kw.get("last_index")))
        return real(params, cfg, tokens, **kw)

    monkeypatch.setattr(engine_mod, "lm_prefill", spy)
    pcfg = configs.get_smoke(arch)
    eng = ServeEngine(pcfg, init_lm(0, pcfg, device=CPU), slots=2,
                      max_len=64)
    reqs = [eng.submit(np.arange(n) % pcfg.vocab, max_new=2) for n in (5, 17)]
    eng.run()
    assert all(r.done for r in reqs)
    assert seen == ([(16, 4), (32, 16)] if arch in ARCHS
                    else [(5, None), (17, None)])


def test_sampled_decoding_repeats_with_its_seed():
    pcfg = configs.get_smoke("qwen3-0.6b")
    params = init_lm(0, pcfg, device=CPU)
    outs = []
    for _ in range(2):
        eng = ServeEngine(pcfg, params, slots=2, max_len=32, greedy=False,
                          seed=5)
        reqs = [eng.submit(np.arange(n), max_new=5) for n in (4, 7, 3)]
        eng.run()
        assert all(r.done and len(r.out) == 5 for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < pcfg.vocab for o in outs[0] for t in o)


def test_serve_launcher_matches_the_reference_launcher():
    """Same prompts, so the same counts; the same result keys."""
    kw = dict(requests=5, max_new=4, slots=2, max_len=64)
    ours = serve("qwen3-0.6b", device="cpu", **kw)
    theirs = ref_serve("qwen3-0.6b", **kw)
    assert ours.keys() == theirs.keys()
    for key in ("requests", "decode_steps", "tokens_generated"):
        assert ours[key] == theirs[key], key


def test_serve_main_prints_its_result(tmp_path):
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "2",
         "--max-new", "3", "--device", "cpu"],
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert '"tokens_generated": 6' in proc.stdout


# ------------------------------------------------------------- training --
# lm_loss and its grads against jax.value_and_grad of the reference's, on
# the fp32 smoke configs: the loss within LOSS_RTOL relative (the same
# fp32 math in another order), each grad leaf within GRAD_RTOL of that
# leaf's max|ref| (the backward sums in other orders again).
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4


def train_batch(vocab, shape, seed=0):
    """Tokens and next-token labels (-1 last), as numpy int32."""
    toks = tokens(vocab, shape, seed).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((shape[0], 1), -1,
                                                  np.int32)], 1)
    return {"tokens": toks, "labels": labels}


def port_loss_and_grads(params, cfg, batch, **kw):
    leaves = [leaf.requires_grad_(True)
              for _, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, parts = lm_loss(params, cfg, tb, **kw)
    return loss, parts, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
@pytest.mark.parametrize("arch", ALL)
def test_lm_loss_and_grads_match_the_reference(arch, impl):
    cfg, rp, pcfg, pp = both(arch)
    batch = train_batch(cfg.vocab, (2, 32), seed=3)
    (want, parts), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              impl=impl), has_aux=True)(rp)
    loss, ours, got = port_loss_and_grads(pp, pcfg, batch, impl=impl)
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert abs(ours["ce"].item() - float(parts["ce"])) \
        <= LOSS_RTOL * abs(float(parts["ce"]))
    assert ours["aux"].item() == float(parts["aux"]) == 0.0
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(got)
    for (path, ref_g), g in zip(flat, got):
        close(g, np.asarray(ref_g), rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ALL)
def test_remat_gives_the_same_loss_and_grads(arch):
    """``remat=True`` recomputes each layer in the backward: the same loss
    and grads, bit for bit on the CPU (the same ops in the same order)."""
    _, _, pcfg, pp = both(arch)
    batch = train_batch(pcfg.vocab, (2, 24), seed=4)
    l0, _, g0 = port_loss_and_grads(pp, pcfg, batch)
    l1, _, g1 = port_loss_and_grads(pp, pcfg, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_cross_entropy_and_causal_mask_match_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 2] = -1
    want = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(got.item() - want) <= 1e-6 * abs(want)
    none = cross_entropy(torch.from_numpy(logits),
                         torch.full((3, 7), -1))
    assert none.item() == 0.0
    from repro.models.layers import causal_mask as ref_causal_mask
    for sq, sk, off in ((5, 5, 0), (3, 8, 5), (6, 4, -2)):
        assert np.array_equal(causal_mask(sq, sk, off).numpy(),
                              np.asarray(ref_causal_mask(sq, sk, off)))


def test_lm_loss_refuses_a_mesh_and_outside_embeddings():
    """A mesh that is not bound to torch.distributed is refused (the
    sharded loss: ``tests/test_torch_distributed.py``).  Embeddings fed
    from outside are taken now (their parity with the reference:
    ``tests/test_torch_embeds.py``): the embedding table's own rows of the
    tokens, fed as ``embeds``, give the tokens' loss bit for bit, and a
    batch with both inputs or neither is refused."""
    _, _, pcfg, pp = both("llama3.2-1b")
    batch = {k: torch.as_tensor(v)
             for k, v in train_batch(pcfg.vocab, (1, 8)).items()}
    with pytest.raises(TypeError, match="make_process_mesh"):
        lm_loss(pp, pcfg, batch, mesh=object())
    rows = pp["embed"][batch["tokens"]]
    want, _ = lm_loss(pp, pcfg, batch)
    got, _ = lm_loss(pp, pcfg, {"embeds": rows, "labels": batch["labels"]})
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not both or neither"):
        lm_loss(pp, pcfg, {**batch, "embeds": rows})
    with pytest.raises(ValueError, match="not both or neither"):
        lm_loss(pp, pcfg, {"labels": batch["labels"]})
