"""LM serving over a device mesh: the port's ``ServeEngine(mesh=)`` and
``lm_prefill(mesh=)`` on 4 gloo ranks of this CPU, against the JAX
package's ``ServeEngine`` and ``lm_prefill`` on one device.

One spawn (``tools/ranks.run_ranks``) runs every case of this file
(``torch_mesh_ranks.mesh_serve_all``); weights are the reference's
``init_lm`` carried across as numpy (``models/weights.from_reference``),
fp32 smoke configs.  Bars:
  * the engine's greedy tokens equal the reference engine's for every
    request, on every rank: the dense GQA model, zamba2 (Mamba2 and its
    shared blocks), xLSTM and deepseek-v3 (MLA and its experts) over (2, 2)
    (one-row prefills held whole on both dp ranks, the slots split 2 a dp
    rank) and (1, 4), and a slot count that does not divide over the dp
    axes (the pool whole on every dp rank);
    and, for llama and deepseek-v3, one slot (the sequence over all four
    ranks) and 31 positions (which divide over no axis: the sequence
    whole);
  * ``lm_prefill(mesh=)``'s last logits within 1e-5 of max|ref| and each
    rank's caches (its rows, its block of the sequence of every kv head
    or of MLA's latent, its recurrent heads and conv channels) within
    1e-5 of the reference's cache leaf's max.
"""
from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.transformer import lm_prefill as ref_prefill
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.models.transformer import build_stages

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from test_torch_distributed import ref_params  # noqa: E402
from torch_mesh_ranks import (cache_part, case_cfg,  # noqa: E402
                              mesh_serve_all)

PREFILL_RTOL = 1e-5
ARCHS = ["llama3.2-1b", "zamba2-2.7b", "xlstm-350m", "deepseek-v3-671b"]
SHAPES = ((2, 2), (1, 4))
# (arch, shape, slots[, max_len]): the pool's sequence over model (32
# positions), the slots whole on both dp ranks (3), the sequence over all
# four ranks (one slot), the sequence whole (31 positions divide over no
# axis)
SERVE_CASES = [(a, s, 4) for a in ARCHS for s in SHAPES] \
    + [("llama3.2-1b", (2, 2), 3), ("zamba2-2.7b", (2, 2), 3),
       ("llama3.2-1b", (2, 2), 1, 32), ("deepseek-v3-671b", (2, 2), 1, 32),
       ("llama3.2-1b", (1, 4), 4, 31), ("deepseek-v3-671b", (1, 4), 4, 31)]
# heads10: llama's with 10 heads over 2 kv heads, which (1, 4) splits 3,
# 3, 2, 2 (each rank's kv heads repeated per q head)
PREFILL_CASES = [(a, s) for a in ARCHS for s in SHAPES] + [
    ("heads10", (1, 4))]
PROMPT_LENS = (5, 9, 3, 12, 7, 4)
MAX_LEN, MAX_NEW = 32, 5


def prompts(vocab=256):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


PREFILL_TOKENS = np.random.default_rng(1).integers(0, 256, (2, 12))


@pytest.fixture(scope="module")
def ranks():
    trees = {a: ref_params(a)[1] for a in ARCHS + ["heads10"]}
    return run_ranks(mesh_serve_all, 4, trees, prompts(), SERVE_CASES,
                     PREFILL_TOKENS, PREFILL_CASES, threads=1,
                     timeout_s=600)


def ref_tokens(arch, slots, max_len=MAX_LEN):
    cfg, rp = ref_params(arch)
    eng = RefEngine(cfg, jax.tree.map(jnp.asarray, rp), slots=slots,
                    max_len=max_len)
    reqs = [eng.submit(p, max_new=MAX_NEW) for p in prompts()]
    eng.run()
    return [r.out for r in reqs]


@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-"
                                       f"slots{c[2]}"
                                       + (f"-len{c[3]}" if c[3:] else ""))
def test_mesh_engine_serves_the_reference_tokens(ranks, case):
    want = ref_tokens(*case[:1], *case[2:])
    for r in ranks:
        assert r["serve"][case] == want


@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_mesh_prefill_matches_the_reference(ranks, case):
    arch = case[0]
    cfg, rp = ref_params(arch)
    logits, caches, _ = ref_prefill(jax.tree.map(jnp.asarray, rp), cfg,
                                    jnp.asarray(PREFILL_TOKENS), max_len=16,
                                    impl="chunked")
    want = np.asarray(logits)
    got = ranks[0]["prefill"][case][0]
    assert np.abs(got - want).max() <= PREFILL_RTOL * np.abs(want).max()
    kinds = {f"stage_{i}": kind
             for i, (kind, _, _) in enumerate(build_stages(case_cfg(arch)))}
    kinds["shared"] = "attn"
    for r in ranks:
        _, local, index = r["prefill"][case]
        assert set(local) == set(caches)
        for key, stage in caches.items():
            for name, leaf in stage.items():
                leaf = np.asarray(leaf)
                where = index.get(kinds[key], {}).get(name)
                want_leaf = cache_part(leaf, index["rows"], where)
                got_leaf = local[key][name]
                assert got_leaf.shape == want_leaf.shape, (key, name)
                top = max(np.abs(leaf).max(), 1e-30)
                assert np.abs(got_leaf - want_leaf).max() \
                    <= PREFILL_RTOL * top, (key, name)
