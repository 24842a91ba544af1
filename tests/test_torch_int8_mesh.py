"""AdamW's int8 moments on placed parameters (``train/optim.py``) on 4 gloo
ranks of this CPU, against the port's one-process int8 update and the JAX
package's one-device int8 step.

One spawn (``tools/ranks.run_ranks``) runs every case of this file
(``torch_mesh_ranks.int8_mesh_all``).  Bars:
  * a tree of leaves whose last dim is whole (300), cut at multiples of
    256 (1024 over 4 and 2), and cut at other widths (1000 over 4 and 2,
    64 over 4 and 2, a 1-D 12 over 4 and 2), three updates over (2, 2) and
    (1, 4) from the same global grads: the parameters, and the codes and
    scales gathered whole (codes padded to the reference's layout), equal
    the one-process update's bit for bit;
  * that state saved from the mesh, restored onto the transposed mesh
    (``optim.moment_shardings``), equal bit for bit, and one more update
    from there equal to the one-process run's fourth bit for bit;
  * llama3.2-1b's smoke weights, three int8 steps over (2, 2) against the
    reference's one-device int8 steps (free runs): loss within 1e-4
    relative at each step, parameters at the reference's int8 bar
    (``test_torch_train.params_close``: 99% of entries within 1e-5 of
    max|ref|, all within 1e-3), and that state restored by the reference's
    ``CheckpointManager`` with the codes and scales the mesh held, bit for
    bit.
"""
from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import CheckpointManager as RefCheckpointManager
from repro.train import adamw as ref_adamw
from repro.train import build_train_step as ref_build_train_step
from repro.train.optim import cosine_schedule as ref_cosine
from repro_torch.train import adamw

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from test_torch_distributed import LOSS_RTOL, ref_params  # noqa: E402
from test_torch_recurrent_mesh import nested  # noqa: E402
from test_torch_train import params_close, ref_batch  # noqa: E402
from torch_mesh_ranks import int8_mesh_all  # noqa: E402

SHAPES = {"whole": (3, 300), "aligned": (4, 1024), "cut": (6, 1000),
          "narrow": (8, 64), "flat": (12,)}
SPECS = {"whole": ("data", None), "aligned": (None, "model"),
         "cut": ("data", "model"), "narrow": (None, "model"),
         "flat": ("model",)}
N_UPDATES = 4
LM_STEPS = 3


def tree():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def grads():
    rng = np.random.default_rng(1)
    return [{k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
             for k, s in SHAPES.items()} for i in range(N_UPDATES)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("int8")
    ref_dir = str(base / "ref")
    batches = [ref_batch(ref_params("llama3.2-1b")[0], i)
               for i in range(LM_STEPS)]
    res = run_ranks(int8_mesh_all, 4, tree(), SPECS, grads(),
                    ref_params("llama3.2-1b")[1], batches, str(base),
                    ref_dir, threads=1, timeout_s=600)[0]
    return res, ref_dir


def one_process(n):
    """The port's int8 update of the whole tree in one process, ``n``
    times: (params, state)."""
    params = {k: torch.from_numpy(v) for k, v in tree().items()}
    opt = adamw(1e-2, quantized=True, grad_clip=0.0)
    state = opt.init(params)
    for g in grads()[:n]:
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state,
                   params)
    return params, state


def assert_state_equal(got, params, state):
    for k, p in params.items():
        assert np.array_equal(got["params"][k], p.numpy()), k
        for mom in ("m", "v"):
            q, want = got[mom][k], state[mom][k]
            assert np.array_equal(q.codes, want.codes.numpy()), (mom, k)
            assert np.array_equal(q.scale, want.scale.numpy()), (mom, k)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_int8_update_on_a_mesh_is_the_one_process_update(ranks, shape):
    got = ranks[0]["tree"][shape]
    assert_state_equal(got, *one_process(N_UPDATES - 1))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_int8_checkpoint_moves_across_meshes_and_resumes(ranks, shape):
    got = ranks[0]["tree"][shape]
    assert_state_equal(got["restored"], *one_process(N_UPDATES - 1))
    params, _ = one_process(N_UPDATES)
    for k, p in params.items():
        assert np.array_equal(got["resumed"][k], p.numpy()), k


def ref_run():
    cfg, rp = ref_params("llama3.2-1b")
    opt = ref_adamw(ref_cosine(3e-4, warmup=2, total=10), quantized=True)
    step = jax.jit(ref_build_train_step(cfg, opt))
    params, state = jax.tree.map(jnp.asarray, rp), opt.init(rp)
    out = []
    for i in range(LM_STEPS):
        params, state, m = step(params, state, {
            k: jnp.asarray(v) for k, v in ref_batch(cfg, i).items()})
        out.append((float(m["loss"]), params))
    return out, opt, params, state


def test_int8_steps_on_a_mesh_meet_the_reference_bar(ranks):
    got = ranks[0]["lm"]
    want, *_ = ref_run()
    for (gl, gp), (wl, wp) in zip(got, want):
        assert abs(gl - wl) <= LOSS_RTOL * abs(wl)
        params_close(nested(gp), wp, True)


def test_int8_checkpoint_from_a_mesh_restores_in_the_reference(ranks):
    res, ref_dir = ranks
    _, opt, params, state = ref_run()
    got = RefCheckpointManager(ref_dir).restore(
        LM_STEPS, {"params": params, "opt": state})
    assert int(got["opt"]["step"]) == res["lm_state"]["step"] == LM_STEPS
    held = res["lm_state"]["m"]
    leaves = jax.tree_util.tree_leaves_with_path(
        got["opt"]["m"], is_leaf=lambda x: hasattr(x, "codes"))
    assert len(leaves) == sum(1 for _ in _walk(held))
    for path, q in leaves:
        node = held
        for k in path:
            node = node[k.key]
        assert np.array_equal(np.asarray(q.codes), node.codes), path
        assert np.array_equal(np.asarray(q.scale), node.scale), path
    last = res["lm"][-1][1]
    for path, leaf in jax.tree_util.tree_leaves_with_path(got["params"]):
        key = "/".join(k.key for k in path)
        assert np.array_equal(np.asarray(leaf), last[key]), key


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree
