"""The recurrent blocks, zamba2's shared blocks, a batch that does not
divide over the dp axes and a model axis wider than the head count, over
a device mesh: ``lm_loss``, the train step and ``lm_decode_step`` with
``mesh=`` on 4 gloo ranks of this CPU, against the JAX package on one
device.

One spawn (``tools/ranks.run_ranks``) runs every case of this file
(``torch_mesh_ranks.recurrent_mesh_all``); weights are the reference's
``init_lm`` carried across (``models/weights.from_reference``), fp32 smoke
configs.  Bars (item 6b's, ``test_torch_distributed.py``):
  * a sharded step against the reference's one-device
    ``build_train_step``: loss within 1e-4 relative, grad norm within 1e-5
    relative (xLSTM's within its grads' accuracy, 1e-3:
    ``test_torch_train.GRAD_ACCURACY``), parameters in AdamW's unit as
    ``test_torch_train.params_close`` holds zamba2's and xLSTM's, the
    dense models' within 1e-3; each leaf's first moment (0.1 of its
    clipped grad, which AdamW's first step does not show in the
    parameters: its update is lr·g/|g|) within the grad norm's bar of
    the leaf's max|ref|;
  * the same step with float64 parameters against the port's one-process
    float64 step: grad norm and each leaf's first moment within 1e-6 (a
    leaf's grad summed over the wrong ranks is off by a whole factor; the
    fp32 steps' distance is rounding that xLSTM's backward amplifies, 0
    apart in float64 but for the moments' fp32 storage);
    with remat, the same against the port's one-process step;
  * ``lm_loss(mesh=)`` within 1e-5 relative of the reference's;
  * decode steps' logits within 1e-5 of max|ref|.
Cases: zamba2 (its Mamba2 heads split over the model axis, shared GQA
blocks) and xLSTM (mLSTM heads split, sLSTM whole) over (2, 2) and (1, 4);
llama3.2-1b's smoke weights on a batch of 3 rows over (2, 2) (held whole
on both dp ranks, counted once in the loss); ``"heads2"``, 2 heads over a
4-way model axis (run whole on every model rank, every kv head in each
rank's cache).
"""
from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import lm_decode_step as ref_decode
from repro.models.transformer import lm_loss as ref_loss
from repro.train import adamw as ref_adamw
from repro.train import build_train_step as ref_build_train_step

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from test_torch_distributed import (LOSS_RTOL, PARAM_ATOL,  # noqa: E402
                                    port_step, ref_params, the_batch)
from test_torch_train import GRAD_ACCURACY, params_close  # noqa: E402
from repro_torch.models.weights import from_reference  # noqa: E402
from repro_torch.train import adamw, build_train_step  # noqa: E402
from torch_mesh_ranks import recurrent_mesh_all  # noqa: E402

GNORM_RTOL = 1e-5
LOSS_REF_RTOL = 1e-5
DECODE_RTOL = 1e-5
SHAPES = ((2, 2), (1, 4))
REC = ["zamba2-2.7b", "xlstm-350m"]
STEP_CASES = [(a, s, 8, False) for a in REC for s in SHAPES] + [
    ("zamba2-2.7b", (2, 2), 8, True), ("xlstm-350m", (1, 4), 8, True),
    ("llama3.2-1b", (2, 2), 3, False), ("heads2", (1, 4), 8, False)]
LOSS_CASES = [(a, s, 8) for a in REC for s in SHAPES] + [
    ("llama3.2-1b", (2, 2), 3), ("heads2", (1, 4), 8), ("heads2", (2, 2), 3)]
DECODE_CASES = [(a, s) for a in REC for s in SHAPES] + [("heads2", (1, 4))]
FP64_CASES = [(a, s) for a in REC for s in SHAPES]
FP64_RTOL = 1e-6
TOKENS = np.array([[3, 5, 7, 11], [13, 2, 250, 9], [0, 1, 2, 3]])


@pytest.fixture(scope="module")
def ranks():
    archs = sorted({c[0] for c in STEP_CASES + LOSS_CASES})
    trees = {a: ref_params(a)[1] for a in archs}
    return run_ranks(recurrent_mesh_all, 4, trees, the_batch(), TOKENS,
                     {"steps": STEP_CASES, "losses": LOSS_CASES,
                      "decodes": DECODE_CASES, "fp64": FP64_CASES},
                     threads=1,
                     timeout_s=600)[0]


def nested(flat):
    """A "/"-joined path dict as the nested dict of tensors of a
    parameter tree."""
    out = {}
    for path, v in flat.items():
        node = out
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(v)
    return out


def ref_step(name, rows):
    cfg, rp = ref_params(name)
    opt = ref_adamw(1e-3)
    batch = {k: v[:rows] for k, v in the_batch().items()}
    params, state, m = jax.jit(ref_build_train_step(cfg, opt))(
        jax.tree.map(jnp.asarray, rp), opt.init(rp), batch)
    return {k: float(v) for k, v in m.items()}, params, flat(state["m"])


def flat(tree):
    """A JAX tree as numpy keyed by "/"-joined path."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def leaves_close(got, want, rtol):
    """Every leaf of ``got`` within ``rtol`` of its leaf's max|want|."""
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= rtol * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("case", [c for c in STEP_CASES if not c[3]],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-"
                                       f"rows{c[2]}")
def test_sharded_step_matches_the_reference(ranks, case):
    name, _, rows, _ = case
    gm, gp, gmom = ranks["steps"][case]
    wm, wp, wmom = ref_step(name, rows)
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_RTOL * abs(wm["loss"])
    tol = max(GNORM_RTOL, GRAD_ACCURACY.get(name, 0.0))
    assert abs(gm["grad_norm"] - wm["grad_norm"]) \
        <= tol * abs(wm["grad_norm"])
    leaves_close(gmom, wmom, tol)
    if name in REC:
        params_close(nested(gp), wp, False, wm["lr"])
        return
    want = flat(wp)
    assert set(gp) == set(want)
    err = max(float(np.abs(gp[k] - want[k]).max()) for k in want)
    assert err < PARAM_ATOL, err


def port_step64(name):
    """The port's one-process step from the reference's weights in
    float64: (metrics, first moments)."""
    from torch_mesh_ranks import cast, case_cfg, whole
    cfg = case_cfg(name)
    params = cast(from_reference(cfg, ref_params(name)[1], device="cpu"),
                  torch.float64)
    opt = adamw(1e-3)
    _, state, m = build_train_step(cfg, opt)(
        params, opt.init(params),
        {k: torch.as_tensor(v) for k, v in the_batch().items()})
    return {k: float(v) for k, v in m.items()}, whole(state["m"])


@pytest.mark.parametrize("case", FP64_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_sharded_fp64_step_equals_the_one_process_step(ranks, case):
    gm, gmom = ranks["fp64"][case]
    wm, wmom = port_step64(case[0])
    for k in ("loss", "grad_norm"):
        assert abs(gm[k] - wm[k]) <= FP64_RTOL * abs(wm[k]), k
    leaves_close(gmom, wmom, FP64_RTOL)


@pytest.mark.parametrize("case", [c for c in STEP_CASES if c[3]],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-remat")
def test_sharded_remat_step_matches_the_one_process_step(ranks, case):
    name = case[0]
    gm, gp, _ = ranks["steps"][case]
    wm, wp = port_step(name, 1, True)
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_RTOL * abs(wm["loss"])
    tol = max(GNORM_RTOL, GRAD_ACCURACY.get(name, 0.0))
    assert abs(gm["grad_norm"] - wm["grad_norm"]) \
        <= tol * abs(wm["grad_norm"])
    assert set(gp) == set(wp)
    lr_sum = wm["lr"]
    for k, want in wp.items():
        err = np.abs(gp[k] - want)
        assert err.max() <= 1e-5 * np.abs(want).max() + 2 * lr_sum, k


@pytest.mark.parametrize("case", LOSS_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-"
                                       f"rows{c[2]}")
def test_sharded_loss_matches_the_reference(ranks, case):
    name, _, rows = case
    cfg, rp = ref_params(name)
    batch = {k: jnp.asarray(v[:rows]) for k, v in the_batch().items()}
    want, _ = ref_loss(jax.tree.map(jnp.asarray, rp), cfg, batch)
    got = ranks["losses"][case]
    assert abs(got - float(want)) <= LOSS_REF_RTOL * abs(float(want))


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_sharded_decode_matches_the_reference(ranks, case):
    name = case[0]
    cfg, rp = ref_params(name)
    params = jax.tree.map(jnp.asarray, rp)
    caches = ref_init_caches(cfg, TOKENS.shape[1], TOKENS.shape[0] + 1)
    got, shapes = ranks["decodes"][case]
    for i, toks in enumerate(TOKENS):
        want, caches = ref_decode(params, cfg, jnp.asarray(toks), caches, i)
        want = np.asarray(want)
        assert np.abs(got[i] - want).max() \
            <= DECODE_RTOL * np.abs(want).max(), i
    if name == "heads2":               # every kv head in each rank's cache
        assert shapes["stage_0"]["k"][3] == cfg.n_kv_heads
