"""Checkpoints of the port's sharded training (``train/checkpoint.py`` on
a mesh of 4 gloo ranks), in the format the port shares with the
reference.

llama3.2-1b's smoke weights (the reference's ``init_lm``) take one AdamW
step on a (2, 2) mesh and are saved from it (every rank gathers, rank 0
writes).  The checkpoint restores bit for bit onto (4, 1) and (1, 4)
meshes (``restore(shardings=)``, each leaf placed by the rule table on
the new mesh), onto one process, and into the reference's own
``CheckpointManager``.  A checkpoint the reference wrote restores onto
(2, 2) and (1, 4) meshes with every leaf the reference's array bit for
bit.
"""
from __future__ import annotations

import pathlib
import sys

import jax
import numpy as np
import pytest

from repro import configs as rconfigs
from repro.data import TokenPipeline as RefPipeline
from repro.models.transformer import init_lm as ref_init
from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import adamw as ref_adamw
from repro.train import build_train_step as ref_build_train_step
from repro_torch import configs
from repro_torch.models.transformer import init_lm
from repro_torch.train import CheckpointManager, adamw

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from torch_mesh_ranks import checkpoints, whole  # noqa: E402

ARCH = "llama3.2-1b"
REF_STEP = 7


def batch():
    b = RefPipeline(256, 32, 8, seed=1).batch(0)
    return {k: np.array(v) for k, v in b.items()}


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_mesh")
    cfg = rconfigs.get_smoke(ARCH)
    rp = ref_init(jax.random.PRNGKey(0), cfg)
    opt = ref_adamw(1e-3)
    rp2, rs2, _ = jax.jit(ref_build_train_step(cfg, opt))(
        rp, opt.init(rp), batch())
    ref_state = {"params": rp2, "opt": rs2}
    RefCheckpointManager(str(tmp / "ref")).save(REF_STEP, ref_state)
    out = run_ranks(checkpoints, 4, jax.tree.map(np.asarray, rp), batch(),
                    str(tmp / "port"), str(tmp / "ref"), REF_STEP,
                    threads=1, timeout_s=300)[0]
    return tmp, out, flat(ref_state)


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)], ids=str)
def test_a_mesh_checkpoint_restores_onto_another_mesh(run, shape):
    _, out, _ = run
    assert_same(out[("port", shape)], out["saved"])
    # placed by the new mesh's rule table: wq (d, H·hd) over data, model
    wq = out[("placements", shape)]["stage_0/attn/wq"]
    assert wq == (2, 64 // shape[0], 64 // shape[1])


def test_a_mesh_checkpoint_restores_onto_one_process(run):
    tmp, out, _ = run
    cfg = configs.get_smoke(ARCH)
    params = init_lm(1, cfg, device="cpu")
    like = {"params": params, "opt": adamw(1e-3).init(params)}
    got = CheckpointManager(str(tmp / "port")).restore(1, like)
    assert_same(whole(got), out["saved"])


def test_the_reference_restores_a_mesh_checkpoint(run):
    tmp, out, _ = run
    mgr = RefCheckpointManager(str(tmp / "port"))
    cfg = rconfigs.get_smoke(ARCH)
    p_like = jax.eval_shape(lambda k: ref_init(k, cfg),
                            jax.random.PRNGKey(0))
    like = {"params": p_like,
            "opt": jax.eval_shape(ref_adamw(1e-3).init, p_like)}
    got = flat(mgr.restore(1, like))
    assert_same(got, out["saved"])
    assert mgr.manifest(1)["extra"] == {"data_cursor": 1}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_a_reference_checkpoint_restores_onto_a_mesh(run, shape):
    _, out, ref = run
    got = out[("reference", shape)]
    assert set(got) == set(ref)
    for k, want in ref.items():
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_only_rank_zero_writes(run):
    """One checkpoint directory, no temporary left behind."""
    tmp, _, _ = run
    names = sorted(p.name for p in (tmp / "port").iterdir())
    assert names == ["step_1"]
