"""The port's LM over a device mesh (``launch.mesh.make_process_mesh``,
``distributed.sharding.shardings`` / ``device_put``, the sharded
``build_train_step``, ``lm_loss`` and ``lm_decode_step``) on 4 gloo ranks
of this CPU, against the JAX package.

The reference's own multi-device tests (``tests/test_distributed.py``)
force host devices in a subprocess; the port's counterpart is a process
group: one spawn (``tools/ranks.run_ranks``) runs every case of this file
(``torch_mesh_ranks.distributed_all``) and the tests read its results.
Weights are the reference's ``init_lm`` carried across as numpy
(``models/weights.py``).  Bars, fp32 smoke configs:
  * a sharded step against the reference's one-device ``build_train_step``
    (and against the port's own one-process step): loss within 1e-4
    relative, every parameter within 1e-3 (the reference's own bar,
    ``tests/test_distributed.py``), the grad norm within 1e-5 relative;
  * ``lm_loss(mesh=)`` with labels ignored unevenly over the dp shards:
    the global mean over the labels ``!= -1``, within 1e-6 relative of the
    one-device loss (a mean of per-shard means is visibly off here);
  * a sharded decode step's logits within 1e-5 of max|one-device|;
  * the sequence-sharded decode caches (``cache_specs``' layout): llama
    (GQA), deepseek-v3 (MLA and experts) and zamba2 (shared blocks) over
    (2, 2) and (1, 4), a batch that divides over dp, B = 1 (the sequence
    over all four ranks) and a ``max_len`` that does not divide (the
    sequence whole), from per-row lengths in every block and one past
    the end: logits within 1e-5 of max|reference| (the JAX package's
    decode), each rank's cache block within 1e-5 of the reference leaf's
    max, and one step's collective bytes per kind the same at two
    ``max_len``s;
  * placements: each rank's block has the shape the spec cuts and the
    bytes ``explain()`` states.
"""
from __future__ import annotations

import functools
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import TokenPipeline as RefPipeline
from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import init_lm as ref_init
from repro.models.transformer import lm_decode_step as ref_decode
from repro.train import adamw as ref_adamw
from repro.train import build_train_step as ref_build_train_step
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.launch.train import train
from repro_torch.models.transformer import (build_stages, check_mesh,
                                            init_caches, init_lm,
                                            lm_decode_step, lm_loss)
from repro_torch.models.weights import from_reference, param_shapes
from repro_torch.train import adamw, build_train_step

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from torch_mesh_ranks import (cache_part, case_cfg,  # noqa: E402
                              distributed_all)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-3
GNORM_RTOL = 1e-5
UNEVEN_RTOL = 1e-6
DECODE_RTOL = 1e-5

SHAPES = ((2, 2), (1, 4))
STEP_CASES = [("llama3.2-1b", (2, 2), 1, False),
              ("llama3.2-1b", (4, 1), 1, False),
              ("llama3.2-1b", (1, 4), 1, False),
              ("deepseek-v3-671b", (2, 2), 1, False),
              ("deepseek-v3-671b", (1, 4), 1, False),
              ("grok-1-314b", (2, 2), 1, False),
              ("qwen2-72b", (2, 2), 1, False),
              ("qwen3-0.6b", (1, 4), 1, False),
              ("heads10", (1, 4), 1, False),
              ("llama3.2-1b", (2, 2), 2, False),
              ("llama3.2-1b", (2, 2), 1, True)]
STEP_ARCHS = sorted({c[0] for c in STEP_CASES})
DECODE_CASES = [("llama3.2-1b", (2, 2), False),
                ("deepseek-v3-671b", (2, 2), False),
                ("deepseek-v3-671b", (1, 4), False),
                ("deepseek-v3-671b", (2, 2), True),
                ("heads10", (1, 4), False)]
# (arch, shape, moe_1d, per-row start lengths, max_len, a second max_len
# for the collective bytes): each row's positions in their own block, the
# last row at max_len by the third step (dropped), B = 1 over all four
# ranks, and 31 positions, which divide over no axis
SEQ_DECODE_CASES = [c for a in ("llama3.2-1b", "deepseek-v3-671b",
                                "zamba2-2.7b") for c in (
    (a, (2, 2), False, (0, 9, 17, 30), 32, 64),
    (a, (1, 4), False, (0, 9, 17, 30), 32, 64),
    (a, (2, 2), False, (14,), 32, 64),
    (a, (1, 4), False, (14,), 32, 64),
    (a, (1, 4), False, (5, 6, 7, 29), 31, 63))]
LOSS_SHAPES = ((2, 2), (4, 1), (1, 4))
TRAIN_STEPS = 3


def ref_params(name):
    """The reference's smoke weights of a case as numpy (qkv biases drawn
    non-zero where the config has them)."""
    from test_torch_lm import with_qkv_biases
    cfg = case_cfg(name, rconfigs.get_smoke)
    rp = with_qkv_biases(cfg, ref_init(jax.random.PRNGKey(0), cfg))
    return cfg, jax.tree.map(np.asarray, rp)


def the_batch(vocab=256):
    b = RefPipeline(vocab, 32, 8, seed=1).batch(0)
    return {k: np.array(v) for k, v in b.items()}


def uneven_batch():
    """Labels ignored on 113 of the first four rows' 128 positions and 8
    of the last four rows': a mean of two dp shards' means would weigh
    the first shard's 15 labels as the second's 120."""
    b = the_batch()
    labels = b["labels"]
    labels[:4, :28] = -1
    labels[4:, 30:] = -1
    labels[0, 31] = -1
    return b


TOKENS = np.array([[3, 5, 7, 11], [13, 2, 250, 9], [0, 1, 2, 3]])


@pytest.fixture(scope="module")
def all_ranks():
    trees = {name: ref_params(name)[1] for name in
             STEP_ARCHS + ["zamba2-2.7b"]}
    cases = {"placements": (list(configs.ARCHS), SHAPES),
             "steps": STEP_CASES, "losses": LOSS_SHAPES,
             "decodes": DECODE_CASES + SEQ_DECODE_CASES}
    return run_ranks(distributed_all, 4, trees, the_batch(),
                     uneven_batch(), TOKENS, cases, threads=1,
                     timeout_s=600)


@pytest.fixture(scope="module")
def ranks(all_ranks):
    return all_ranks[0]


@functools.lru_cache(maxsize=None)
def ref_step(name):
    """The reference's one-device step on the batch: (metrics, params)."""
    cfg, rp = ref_params(name)
    opt = ref_adamw(1e-3)
    step = jax.jit(ref_build_train_step(cfg, opt))
    params, _, m = step(rp, opt.init(rp), the_batch())
    return ({k: float(v) for k, v in m.items()},
            {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(params)})


def port_step(name, micro=1, remat=False):
    """The port's one-process step from the same weights."""
    cfg = case_cfg(name)
    params = from_reference(cfg, ref_params(name)[1], device=CPU)
    opt = adamw(1e-3)
    state = opt.init(params)
    params, state, m = build_train_step(cfg, opt, microbatches=micro,
                                        remat=remat)(
        params, state, {k: torch.as_tensor(v)
                        for k, v in the_batch().items()})
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            flat[path] = t.detach().numpy()

    walk(params, "")
    return {k: float(v) for k, v in m.items()}, flat


def assert_step_close(got, want):
    gm, gp, _ = got
    wm, wp = want
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_RTOL * abs(wm["loss"])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) \
        <= GNORM_RTOL * abs(wm["grad_norm"])
    assert set(gp) == set(wp)
    err = max(float(np.abs(gp[k] - wp[k]).max()) for k in wp)
    assert err < PARAM_ATOL, err


class _Shape:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


# -------------------------------------------------------------- placement --
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_placements_are_the_rule_table_s(ranks, arch, shape):
    """Every leaf's local block: the spec of the rule table, its shape the
    full shape cut by each sharded dim's axes, its bytes explain()'s."""
    rows = ranks["placements"][(arch, shape)]
    cfg = configs.get_smoke(arch)
    mesh = _Shape(shape)
    shapes = param_shapes(cfg)
    specs = shd.param_specs(shapes, mesh)
    explained = {path: nbytes for path, _, _, nbytes in
                 shd.explain(init_lm(0, cfg, device=CPU), specs, mesh)}
    assert set(rows) == set(explained)
    for path, (local, nbytes, spec) in rows.items():
        node_s, node_p = specs, shapes
        for k in path.split("/"):
            node_s, node_p = node_s[k], node_p[k]
        assert spec == node_s
        want = []
        for dim, entry in zip(node_p, spec + (None,) * len(node_p)):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            want.append(dim // int(np.prod([mesh.shape[a] for a in axes])))
        assert local == tuple(want), path
        assert nbytes == explained[path], path


def test_int8_moments_on_a_mesh_wait_for_item_6c(ranks):
    """int8 moments on placed parameters (the first arch's smoke weights):
    the codes take their parameter's placements, each rank's codes the
    width of its block (padded to a block where the last dim is whole);
    the scales the same placements, but replicated over the axes that
    cut the last dim where they cut blocks (``train/optim.py``)."""
    rows = [row for shape in SHAPES
            for row in ranks["placements"][("int8", shape)]]
    assert any(straddles for *_, straddles, _, _ in rows)
    for param, codes, scale, straddles, c_loc, p_loc in rows:
        assert codes == param
        assert c_loc[:-1] == p_loc[:-1]
        cut = "Shard(dim=%d)" % (len(p_loc) - 1)
        if cut in param:
            assert c_loc[-1] == p_loc[-1]
        else:
            assert c_loc[-1] == -(-p_loc[-1] // 256) * 256
        assert straddles == (cut in param and p_loc[-1] % 256 != 0)
        if straddles:
            assert cut not in scale
            assert scale == param.replace(cut, "Replicate()")
        else:
            assert scale == param


# ------------------------------------------------------------------ steps --
@pytest.mark.parametrize("case", [c for c in STEP_CASES if c[2:] == (1,
                                                                     False)],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_sharded_step_matches_the_reference(ranks, case):
    assert_step_close(ranks["steps"][case], ref_step(case[0]))


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-"
                                       f"micro{c[2]}-remat{int(c[3])}")
def test_sharded_step_matches_the_one_process_step(ranks, case):
    """The same step in one process (microbatches and remat alike)."""
    name, _, micro, remat = case
    assert_step_close(ranks["steps"][case], port_step(name, micro, remat))


def test_sharded_moments_are_the_one_process_moments(ranks):
    """AdamW's first moments take their parameter's placements and hold
    the one-process step's values (1e-4 of max|m|: the grads' sums)."""
    cfg = case_cfg("llama3.2-1b")
    params = from_reference(cfg, ref_params("llama3.2-1b")[1], device=CPU)
    opt = adamw(1e-3)
    state = opt.init(params)
    build_train_step(cfg, opt)(params, state, {
        k: torch.as_tensor(v) for k, v in the_batch().items()})
    _, _, moments = ranks["steps"][("llama3.2-1b", (2, 2), 1, False)]
    for path, got in moments.items():
        node = state["m"]
        for k in path.split("/"):
            node = node[k]
        want = node.numpy()
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path


# ------------------------------------------------------------------- loss --
@pytest.mark.parametrize("shape", LOSS_SHAPES, ids=str)
def test_global_loss_with_uneven_ignored_labels(ranks, shape):
    cfg = configs.get_smoke("llama3.2-1b")
    params = from_reference(cfg, ref_params("llama3.2-1b")[1], device=CPU)
    batch = {k: torch.as_tensor(v) for k, v in uneven_batch().items()}
    want, _ = lm_loss(params, cfg, batch)
    got, ce = ranks["losses"][shape]
    assert abs(got - want.item()) <= UNEVEN_RTOL * abs(want.item())
    assert ce == got
    # what a mean of the dp shards' own means would have given
    if shape[0] > 1:
        halves = [lm_loss(params, cfg, {k: v[i * 4:(i + 1) * 4]
                                        for k, v in batch.items()})[0]
                  for i in range(2)]
        assert abs(float(sum(halves)) / 2 - want.item()) > 1e-3


# ----------------------------------------------------------------- decode --
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}"
                                       f"{'-1d' if c[2] else ''}")
def test_sharded_decode_matches_one_device(ranks, case):
    """Decode steps over the mesh (deepseek-v3's MoE through the gathered
    paths: ``gathered2d``, or ``gathered`` under ``REPRO_MOE_1D``) give
    the one-device logits."""
    name = case[0]
    cfg = case_cfg(name)
    params = from_reference(cfg, ref_params(name)[1], device=CPU)
    caches = init_caches(cfg, TOKENS.shape[1], TOKENS.shape[0] + 1,
                         device=CPU)
    got = ranks["decodes"][case]
    with torch.no_grad():
        for i, toks in enumerate(torch.as_tensor(TOKENS)):
            want, caches = lm_decode_step(params, cfg, toks, caches, i)
            want = want.numpy()
            assert np.abs(got[i] - want).max() \
                <= DECODE_RTOL * np.abs(want).max(), i


@pytest.mark.parametrize("case", SEQ_DECODE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-"
                                       f"b{len(c[3])}-len{c[4]}")
def test_sequence_sharded_decode_matches_the_reference(all_ranks, case):
    """Decode steps over caches in ``cache_specs``' layout give the JAX
    package's logits on every rank, each rank holds the reference's
    cache leaves' block (its rows, its positions, every kv head), and a
    step's collective bytes do not grow with ``max_len``."""
    name, _, _, start, max_len, _ = case
    cfg, rp = ref_params(name)
    params = jax.tree.map(jnp.asarray, rp)
    b = len(start)
    caches = ref_init_caches(cfg, b, max_len)
    steps = []
    for i, toks in enumerate(TOKENS[:, :b]):
        want, caches = ref_decode(params, cfg, jnp.asarray(toks), caches,
                                  jnp.asarray(start) + i)
        steps.append(np.asarray(want))
    want = np.stack(steps)
    kinds = {f"stage_{i}": kind
             for i, (kind, _, _) in enumerate(build_stages(case_cfg(name)))}
    kinds["shared"] = "attn"
    for r in all_ranks:
        got, local, index, tallies = r["decodes"][case]
        assert np.abs(got - want).max() <= DECODE_RTOL * np.abs(want).max()
        assert set(local) == set(caches)
        for key, stage in caches.items():
            for leaf_name, leaf in stage.items():
                leaf = np.asarray(leaf)
                part = cache_part(leaf, index["rows"], index.get(
                    kinds[key], {}).get(leaf_name))
                assert local[key][leaf_name].shape == part.shape, \
                    (key, leaf_name)
                assert np.abs(local[key][leaf_name] - part).max() \
                    <= DECODE_RTOL * max(np.abs(leaf).max(), 1e-30), \
                    (key, leaf_name)
        assert tallies[0] == tallies[1]


# --------------------------------------------------------------- launcher --
def test_train_launcher_on_a_mesh(ranks):
    """``launch.train.train(mesh=)`` on (2, 2) follows the one-process
    run's losses."""
    want = train("llama3.2-1b", steps=TRAIN_STEPS, batch=4, seq_len=16,
                 log_every=1000, device="cpu")["history"]
    got = ranks["train"]
    assert len(got) == TRAIN_STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


# ---------------------------------------------------------------- refusals --
def test_a_mesh_must_be_bound_and_blocks_attention():
    """A mesh that is not bound to torch.distributed is refused; every
    arch's blocks take a bound one (the recurrent and shared blocks
    too)."""
    cfg = configs.get_smoke("llama3.2-1b")
    with pytest.raises(TypeError, match="make_process_mesh"):
        check_mesh(cfg, _Shape((2, 2)))
    bound = types.SimpleNamespace(device_mesh=object())
    for arch in configs.ARCHS:
        check_mesh(configs.get_smoke(arch), bound)
        check_mesh(configs.get(arch), bound)
    with pytest.raises(ValueError, match="bound"):
        shd.shardings(shd.param_specs(param_shapes(cfg), _Shape((2, 2))),
                      _Shape((2, 2)))
