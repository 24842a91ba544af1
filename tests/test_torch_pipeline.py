"""The port's ``distributed/pipeline.py`` (``pipeline_apply``, the GPipe
schedule over a 4-stage mesh axis of 4 gloo ranks) against the
reference's ``pipeline_apply`` on a forced 4-device host mesh (a
subprocess, as ``tests/test_distributed.py`` runs it): ys within 1e-5 and
the grads of ``ys.sum()`` within 1e-4, at the reference test's shapes and
two more (more stages than microbatches; one microbatch).  The stage
weights are placed over the stage axis, or passed whole to every rank
(``plain``), whose summed grads are the same.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from ranks import run_ranks  # noqa: E402
from torch_mesh_ranks import pipelines  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
S = 4
# (n_micro, mb, d): the reference test's, fewer microbatches than stages,
# and one
SHAPES = ((6, 2, 16), (3, 4, 32), (1, 2, 8))

REF_CODE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_host_mesh

mesh = make_host_mesh((4,), ("stage",))
f = lambda w, x: jnp.tanh(x @ w)
out = {}
with np.load(sys.argv[1]) as z:
    cases = [(z[f"W{i}"], z[f"xs{i}"]) for i in range(int(sys.argv[3]))]
for i, (W, xs) in enumerate(cases):
    W, xs = jnp.asarray(W), jnp.asarray(xs)
    out[f"ys{i}"] = np.asarray(pipeline_apply(f, W, xs, mesh=mesh,
                                              axis="stage"))
    out[f"g{i}"] = np.asarray(jax.grad(lambda W: pipeline_apply(
        f, W, xs, mesh=mesh, axis="stage").sum())(W))
np.savez(sys.argv[2], **out)
"""


def cases():
    rng = np.random.default_rng(0)
    out = []
    for n_micro, mb, d in SHAPES:
        W = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
        xs = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
        out.append((W, xs))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cs = cases()
    np.savez(tmp / "in.npz", **{f"W{i}": W for i, (W, _) in enumerate(cs)},
             **{f"xs{i}": xs for i, (_, xs) in enumerate(cs)})
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_CODE),
         str(tmp / "in.npz"), str(tmp / "ref.npz"), json.dumps(len(cs))],
        capture_output=True, text=True, env=env, timeout=560)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp / "ref.npz") as z:
        ref = dict(z)
    port = run_ranks(pipelines, 4, cs, threads=1, timeout_s=300)[0]
    return ref, port


@pytest.mark.parametrize("layout", ["placed", "plain"])
@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=[f"micro{n}-mb{m}-d{d}" for n, m, d in SHAPES])
def test_pipeline_forward_matches_the_reference(both, i, layout):
    ref, port = both
    ys, _ = port[layout][i]
    assert float(np.abs(ys - ref[f"ys{i}"]).max()) < FWD_ATOL


@pytest.mark.parametrize("layout", ["placed", "plain"])
@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=[f"micro{n}-mb{m}-d{d}" for n, m, d in SHAPES])
def test_pipeline_grads_match_the_reference(both, i, layout):
    ref, port = both
    _, g = port[layout][i]
    assert float(np.abs(g - ref[f"g{i}"]).max()) < GRAD_ATOL
