"""Embeddings fed from outside, sinusoidal positions and the ``tri`` and
``chunked_scan`` attention cores of the port, against the JAX package on
the CPU.

chameleon-34b (qk-norm, rope) and musicgen-medium (sinusoidal positions,
the gelu MLP) take precomputed patch / frame embeddings
(``embed_inputs=False``): ``lm_forward``, ``lm_prefill``, ``lm_loss`` with
its grads and decode steps after an embeddings prefill are held to the
reference's on the smoke configs, the weights carried by
``weights.from_reference``, the embeddings standard normal from a numpy
seed.  Tolerances: logits and caches within ``RTOL`` = 1e-5 of max|ref|
(fp32, the same arithmetic summed in another order), the loss within
``LOSS_RTOL`` = 1e-6 relative, grads within ``GRAD_RTOL`` = 1e-4 of each
leaf's max|ref| (``tests/test_torch_lm.py``'s bars).  The position table
is held within 1e-6 absolute at positions 0-2048 at the two widths that
sinusoidal configs use (64 and musicgen's 1536), and the attention cores
within ``RTOL`` of max|ref| at GQA and MLA shapes, with offsets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models.attention import chunked_attention as ref_chunked
from repro.models.attention import gqa_forward as ref_gqa_forward
from repro.models.attention import mla_forward as ref_mla_forward
from repro.models.attention import tri_attention as ref_tri
from repro.models.layers import sinusoidal_pos as ref_sinusoidal
from repro.models.transformer import _embed as ref_embed
from repro.models.transformer import init_lm as ref_init
from repro.models.transformer import lm_decode_step as ref_decode
from repro.models.transformer import lm_forward as ref_forward
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.models.transformer import lm_prefill as ref_prefill
from repro_torch import configs
from repro_torch.models.attention import (chunked_attention, gqa_forward,
                                          mla_forward, tri_attention)
from repro_torch.models.layers import sinusoidal_pos
from repro_torch.models.transformer import (_embed, lm_decode_step,
                                            lm_forward, lm_loss, lm_prefill)
from repro_torch.models.weights import from_reference

EMBED_ARCHS = ["chameleon-34b", "musicgen-medium"]
RTOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
CPU = torch.device("cpu")


def close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), err


def both(arch, seed=0):
    """-> (cfg, reference params, port cfg, port params on the CPU)."""
    cfg = rconfigs.get_smoke(arch)
    rp = ref_init(jax.random.PRNGKey(seed), cfg)
    pcfg = configs.get_smoke(arch)
    return cfg, rp, pcfg, from_reference(
        pcfg, jax.tree.map(np.asarray, rp), device=CPU)


def embeds(d, shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


# ---------------------------------------------------------- positions --
@pytest.mark.parametrize("d_model", [64, 1536])
def test_sinusoidal_pos_matches_the_reference(d_model):
    """Positions 0-2048 as a ``(2, 1025)`` batch: within 1e-6 absolute of
    the reference's fp32 table (the same frequencies bit for bit, sin and
    cos a few fp32 ulps apart); the float64 table within 1e-12 of numpy's
    float64 sinusoid."""
    pos = np.arange(2050).reshape(2, 1025)
    want = np.asarray(ref_sinusoidal(jnp.asarray(pos), d_model))
    got = sinusoidal_pos(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (2, 1025, d_model)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    half = d_model // 2
    ang = pos[..., None] * 1e-4 ** (np.arange(half) / half)
    exact = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    wide = sinusoidal_pos(torch.from_numpy(pos), d_model, torch.float64)
    assert np.abs(wide.numpy() - exact).max() <= 1e-12


def test_bf16_embed_rounds_once_as_the_reference():
    """musicgen's input rows in bf16: fp32 embeddings cast to bf16, the
    table added in fp32 and rounded once, at positions 0-2047.  Equal to
    the reference's ``_embed`` but where the fp32 tables' last-ulp
    differences cross a bf16 rounding boundary: under 1e-4 of the entries,
    each within one bf16 step of the larger plus the tables' own 1e-6
    (which is all of the gap where the sum cancels to near 0)."""
    cfg = rconfigs.get("musicgen-medium")
    pcfg = configs.get("musicgen-medium")
    x = embeds(cfg.d_model, (1, 2048), seed=3)
    pos = np.arange(2048)[None]
    table = {"embed": jnp.zeros((1, cfg.d_model), jnp.bfloat16)}
    want = np.asarray(ref_embed(table, cfg, None, jnp.asarray(x),
                                jnp.asarray(pos)).astype(jnp.float32))
    got = _embed({"embed": torch.zeros((1, cfg.d_model),
                                       dtype=torch.bfloat16)},
                 pcfg, None, torch.from_numpy(x), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    differ = got != want
    assert differ.mean() < 1e-4, differ.mean()
    gap = np.abs(got - want)[differ]
    step = np.maximum(np.abs(got), np.abs(want))[differ] * 2.0 ** -7
    assert (gap <= step + 1e-6).all()


# --------------------------------------------- the model from embeddings --
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_lm_forward_from_embeds_matches_reference(arch, impl):
    cfg, rp, pcfg, pp = both(arch)
    x = embeds(cfg.d_model, (2, 24))
    want, _ = ref_forward(rp, cfg, embeds=jnp.asarray(x), impl=impl)
    got, aux = lm_forward(pp, pcfg, embeds=torch.from_numpy(x), impl=impl)
    close(got, want)
    assert aux == 0.0


@pytest.mark.parametrize("last_index", [None, 10])
@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_lm_prefill_from_embeds_matches_reference(arch, last_index):
    """Logits, length and every cache leaf; ``b, S`` from the embeddings
    (right-padded rows keep their positions)."""
    cfg, rp, pcfg, pp = both(arch)
    x = embeds(cfg.d_model, (1, 16), seed=1)
    want, rcache, rlen = ref_prefill(
        rp, cfg, embeds=jnp.asarray(x), max_len=40, impl="chunked",
        last_index=None if last_index is None else jnp.int32(last_index))
    got, cache, length = lm_prefill(pp, pcfg, embeds=torch.from_numpy(x),
                                    max_len=40, last_index=last_index)
    close(got, want)
    assert np.asarray(length).reshape(-1).tolist() == \
        np.asarray(rlen).reshape(-1).tolist()
    for key, stage in rcache.items():
        for name, arr in stage.items():
            close(cache[key][name], arr)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_decode_after_an_embeds_prefill_matches_reference(arch):
    """Three rows prefilled from embeddings with their own last indices
    (per-row lengths 10, 13, 16), then four greedy-free decode steps on
    fixed tokens at each row's own position (musicgen's table at each
    row's length): logits and caches at every step."""
    cfg, rp, pcfg, pp = both(arch)
    x = embeds(cfg.d_model, (3, 16), seed=2)
    last = np.array([9, 12, 15], np.int32)
    _, rcache, rlen = ref_prefill(rp, cfg, embeds=jnp.asarray(x),
                                  max_len=32, impl="chunked",
                                  last_index=jnp.asarray(last))
    _, cache, length = lm_prefill(pp, pcfg, embeds=torch.from_numpy(x),
                                  max_len=32, last_index=torch.from_numpy(
                                      last))
    assert length.tolist() == np.asarray(rlen).tolist() == [10, 13, 16]
    rng = np.random.default_rng(4)
    for t in range(4):
        step = rng.integers(0, cfg.vocab, 3)
        want, rcache = ref_decode(rp, cfg, jnp.asarray(step), rcache,
                                  rlen + t)
        got, cache = lm_decode_step(pp, pcfg, torch.as_tensor(step), cache,
                                    length + t)
        close(got, want)
        for key, stage in rcache.items():
            for name, arr in stage.items():
                close(cache[key][name], arr)


@pytest.mark.parametrize("impl", ["chunked", "naive", "chunked_scan"])
@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_lm_loss_and_grads_from_embeds_match_the_reference(arch, impl):
    """``lm_loss`` of ``{"embeds", "labels"}`` and its grads over every
    parameter leaf, against ``jax.value_and_grad`` of the reference's."""
    cfg, rp, pcfg, pp = both(arch)
    x = embeds(cfg.d_model, (2, 32), seed=5)
    labels = np.random.default_rng(6).integers(0, cfg.vocab, (2, 32))
    labels[:, -1] = -1
    batch = {"embeds": x, "labels": labels.astype(np.int32)}
    (want, parts), grads = jax.value_and_grad(
        lambda p: ref_lm_loss(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              impl=impl), has_aux=True)(rp)
    leaves = [leaf.requires_grad_(True)
              for _, leaf in jax.tree_util.tree_flatten_with_path(pp)[0]]
    loss, ours = lm_loss(pp, pcfg, {k: torch.as_tensor(v)
                                    for k, v in batch.items()}, impl=impl)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(loss.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert abs(ours["ce"].item() - float(parts["ce"])) \
        <= LOSS_RTOL * abs(float(parts["ce"]))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(flat) == len(got)
    for (path, ref_g), g in zip(flat, got):
        if jax.tree_util.keystr(path) == "['embed']":
            # no row of the table is read from embeddings (the untied head
            # is its own leaf): no grad, the reference's zeros
            assert g is None and not np.asarray(ref_g).any()
            continue
        close(g, np.asarray(ref_g), rtol=GRAD_RTOL)


# ------------------------------------------------------ attention cores --
# (B, Sq, Sk, H, Hkv, hd, dv, offset, chunk): GQA at one and several
# chunks, a continuation (offset = Sk - Sq > 0), MHA, and MLA's q·k head
# dim apart from v's
CORES = {
    "gqa": (2, 64, 64, 4, 2, 16, 16, 0, 16),
    "gqa-one-chunk": (1, 24, 24, 8, 2, 16, 16, 0, 512),
    "continuation": (2, 32, 96, 4, 1, 16, 16, 64, 16),
    "mha": (1, 48, 48, 4, 4, 32, 32, 0, 16),
    "mla": (2, 32, 32, 4, 4, 24, 16, 0, 8),
}


def core_inputs(case, seed=7):
    B, Sq, Sk, H, Hkv, hd, dv, offset, chunk = CORES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, dv))]


@pytest.mark.parametrize("case", list(CORES))
def test_tri_attention_matches_the_reference(case):
    *_, hd, _, offset, chunk = CORES[case]
    q, k, v = core_inputs(case)
    scale = 1.0 / np.sqrt(hd + 3) if case == "mla" else None
    want = ref_tri(*map(jnp.asarray, (q, k, v)), offset=offset, scale=scale,
                   chunk=chunk)
    got = tri_attention(*map(torch.from_numpy, (q, k, v)), offset=offset,
                        scale=scale, chunk=chunk)
    close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(CORES))
def test_chunked_attention_matches_the_reference(case, causal):
    *_, hd, _, offset, chunk = CORES[case]
    q, k, v = core_inputs(case, seed=8)
    scale = 1.0 / np.sqrt(hd + 3) if case == "mla" else None
    want = ref_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                       offset=offset, scale=scale, chunk=chunk)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, offset=offset, scale=scale,
                            chunk=chunk)
    close(got, want)


def test_tri_raises_under_grad_and_chunked_scan_differentiates():
    """``tri`` is an inference path: it raises where autograd would need
    it, runs under ``no_grad``; ``chunked_scan``'s grads equal the naive
    core's within RTOL."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in core_inputs("gqa"))
    with pytest.raises(RuntimeError, match="inference path"):
        tri_attention(q, k, v, chunk=16)
    with torch.no_grad():
        assert tri_attention(q, k, v, chunk=16).shape == q.shape
    from repro_torch.models.attention import naive_attention
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    grads = [torch.autograd.grad((fn(q, k, v, causal=True) * g).sum(),
                                 (q, k, v))
             for fn in (chunked_attention, naive_attention)]
    for a, b in zip(*grads):
        close(a, b.numpy())


@pytest.mark.parametrize("impl", ["tri", "chunked_scan"])
@pytest.mark.parametrize("arch", ["qwen2-72b", "deepseek-v3-671b"])
def test_attention_forward_routes_the_cores_as_the_reference(arch, impl):
    """``gqa_forward`` / ``mla_forward`` with ``impl`` against the
    reference's on one layer's weights (qwen2's qkv biases non-zero; MLA's
    scale ``1/sqrt(nope + rope)`` carried into ``tri``)."""
    from test_torch_lm import with_qkv_biases
    cfg = rconfigs.get_smoke(arch)
    rp = with_qkv_biases(cfg, ref_init(jax.random.PRNGKey(0), cfg))
    pcfg = configs.get_smoke(arch)
    pp = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
    x = embeds(cfg.d_model, (2, 32), seed=9)
    pos = np.broadcast_to(np.arange(32), (2, 32)).copy()
    mla = cfg.attn_type == "mla"
    attn_r = jax.tree.map(lambda a: a[0], rp["stage_0"]["attn"])
    attn = {k: a[0] for k, a in pp["stage_0"]["attn"].items()}
    want = (ref_mla_forward if mla else ref_gqa_forward)(
        attn_r, jnp.asarray(x), jnp.asarray(pos), cfg, impl=impl)
    with torch.no_grad():
        got = (mla_forward if mla else gqa_forward)(
            attn, torch.from_numpy(x), torch.from_numpy(pos), pcfg,
            impl=impl)
    close(got, want)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "chameleon-34b"])
def test_tri_prefill_matches_the_reference_default(arch):
    """``lm_prefill(impl="tri")`` against the reference's prefill at its
    default (``tri``), from tokens (codeqwen, qkv biases non-zero) or
    embeddings (chameleon)."""
    from test_torch_lm import with_qkv_biases
    cfg = rconfigs.get_smoke(arch)
    rp = with_qkv_biases(cfg, ref_init(jax.random.PRNGKey(0), cfg))
    pcfg = configs.get_smoke(arch)
    pp = from_reference(pcfg, jax.tree.map(np.asarray, rp), device=CPU)
    if cfg.embed_inputs:
        inp = np.random.default_rng(10).integers(0, cfg.vocab, (2, 16))
        key = "tokens"
    else:
        inp, key = embeds(cfg.d_model, (2, 16), seed=10), "embeds"
    want, rcache, _ = ref_prefill(rp, cfg, max_len=24,
                                  **{key: jnp.asarray(inp)})
    got, cache, _ = lm_prefill(pp, pcfg, max_len=24, impl="tri",
                               **{key: torch.as_tensor(inp)})
    close(got, want)
    for name, arr in rcache["stage_0"].items():
        close(cache["stage_0"][name], arr)
