"""The port's expert-parallel MoE paths (``moe_a2a``, ``moe_gathered``,
``moe_gathered2d``) and ``moe_apply``'s dispatch over a (2, 2) mesh of 4
gloo ranks, against the reference's same paths on the same mesh shape of
4 forced host devices (a subprocess, as ``tests/test_distributed.py``
runs them).

deepseek-v3's smoke config with 8 experts, top-2 (the reference test's),
x ``(2, 64, d)``, at two capacity factors: 4.0, which drops nothing (the
reference test's setting), and 0.5, where every path drops.  Outputs
within 2e-4 (rtol and atol), aux within 1e-4 relative.  The dropped
``(token, k)`` entries each path reports must be the ones the reference's
rule drops on the reference's routing (``expected_drops``: the Switch
position, capacities rounded up to 8, the receiving side's second
capacity).
"""
from __future__ import annotations

import json
import math
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
from torch_mesh_ranks import moe_paths  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 2e-4
AUX_RTOL = 1e-4
SHAPE = (2, 64)
FACTORS = (4.0, 0.5)
PATHS = ("a2a", "gathered", "gathered2d")
# moe_apply: S divisible by the model axis (a2a), not (gathered2d), and
# not under REPRO_MOE_1D (gathered)
DISPATCH = ((64, False), (3, False), (3, True))


REF_CODE = """
import dataclasses, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.models import moe
from repro.launch.mesh import make_host_mesh

out = {}
x_full = np.load(sys.argv[1])["x"]
mesh = make_host_mesh((2, 2), ("data", "model"))
for cf in json.loads(sys.argv[3]):
    cfg = configs.get_smoke("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=cf))
    params = moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    if cf == 4.0:
        for k, v in jax.tree_util.tree_leaves_with_path(params):
            out["param/" + "/".join(str(p.key) for p in k)] = np.asarray(v)
    x = jnp.asarray(x_full)
    _, topi, _ = moe._route(params, x.reshape(-1, cfg.d_model), cfg.moe)
    out[f"topi/{cf}"] = np.asarray(topi)
    with mesh:
        for name in ("a2a", "gathered", "gathered2d"):
            fn = getattr(moe, "moe_" + name)
            y, aux = jax.jit(lambda p, x: fn(p, x, cfg, mesh=mesh))(params, x)
            out[f"{name}/{cf}/y"] = np.asarray(y)
            out[f"{name}/{cf}/aux"] = np.asarray(aux)
        for S, one_d in json.loads(sys.argv[4]):
            if one_d:
                os.environ["REPRO_MOE_1D"] = "1"
            y, aux = jax.jit(lambda p, x: moe.moe_apply(
                p, x, cfg, mesh=mesh))(params, x[:, :S])
            os.environ.pop("REPRO_MOE_1D", None)
            out[f"apply{S}{int(one_d)}/{cf}/y"] = np.asarray(y)
            out[f"apply{S}{int(one_d)}/{cf}/aux"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
"""


def run_reference(tmp, x):
    """The reference's paths on a (2, 2) host mesh of 4 forced devices."""
    np.savez(tmp / "x.npz", x=x)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REF_CODE), str(tmp / "x.npz"),
         str(tmp / "ref.npz"), json.dumps(FACTORS),
         json.dumps([list(c) for c in DISPATCH])],
        capture_output=True, text=True, env=env, timeout=560)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    x = np.random.default_rng(1).standard_normal(
        (*SHAPE, 64)).astype(np.float32)
    ref = run_reference(tmp, x)
    params = {}
    for key, v in ref.items():
        if key.startswith("param/"):
            node = params
            parts = key.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    cases = [(p, cf, False) for p in PATHS for cf in FACTORS]
    cases += [(f"apply{S}", cf, one_d) for S, one_d in DISPATCH
              for cf in FACTORS]
    port = run_ranks(moe_paths, 4, params, x, cases, threads=1,
                     timeout_s=300)[0]
    return ref, port


def _ceil8(n):
    return -(-n // 8) * 8


def _positions(dest, valid, n):
    """The Switch position of each entry among the valid ones with its
    destination, in order."""
    pos = np.zeros(len(dest), int)
    seen = np.zeros(n, int)
    for i, (d, ok) in enumerate(zip(dest, valid)):
        if ok:
            pos[i] = seen[d]
            seen[d] += 1
    return pos


def expected_drops(path, topi, cf, B, S, M=2, D=2, E=8, k=2):
    """The reference's rule on its routing: which ``(token, k)`` entries
    (flattened over the global batch) a capacity drops."""
    e_loc = E // M
    eid = topi.reshape(B, S, k)
    dropped = np.zeros((B, S, k), bool)
    if path == "a2a":
        Bl, Sl = B // D, S // M
        for d in range(D):
            sends = []
            for m in range(M):
                e = eid[d * Bl:(d + 1) * Bl, m * Sl:(m + 1) * Sl].reshape(-1)
                T = len(e) // k
                dest = e // e_loc
                pos = _positions(dest, np.ones(len(e), bool), M)
                cap = _ceil8(math.ceil(T * k / M * cf))
                sends.append((e, dest, pos, cap))
            kept = {}
            for m in range(M):            # receiver m: sources in order
                slots = []
                for s, (e, dest, pos, cap) in enumerate(sends):
                    buf = [(-1, None)] * cap
                    for i in range(len(e)):
                        if dest[i] == m and pos[i] < cap:
                            buf[pos[i]] = (e[i] % e_loc, (s, i))
                    slots += buf
                re = np.array([r for r, _ in slots])
                cap2 = _ceil8(math.ceil(len(slots) / e_loc * cf))
                pos2 = _positions(np.maximum(re, 0), re >= 0, e_loc)
                for (r, who), p2 in zip(slots, pos2):
                    if r >= 0:
                        kept[who] = p2 < cap2
            for s, (e, _, _, _) in enumerate(sends):
                flags = np.array([not kept.get((s, i), False)
                                  for i in range(len(e))])
                dropped[d * Bl:(d + 1) * Bl, s * Sl:(s + 1) * Sl] = \
                    flags.reshape(Bl, Sl, k)
        return dropped
    rows = [slice(0, B)] if path == "gathered2d" else \
        [slice(d * B // D, (d + 1) * B // D) for d in range(D)]
    for r in rows:
        e = eid[r].reshape(-1)
        T = len(e) // k
        cap = max(_ceil8(math.ceil(T * k / M * cf)), 8)
        flags = np.zeros(len(e), bool)
        for m in range(M):
            local = e // e_loc == m
            pos = np.cumsum(local) - 1
            flags |= local & (pos >= cap)
        dropped[r] = flags.reshape(-1, S, k)
    return dropped


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("path", PATHS)
def test_moe_path_matches_the_reference(both, path, cf):
    ref, port = both
    y, aux, _ = port[(path, cf, False)]
    np.testing.assert_allclose(y, ref[f"{path}/{cf}/y"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(aux, float(ref[f"{path}/{cf}/aux"]),
                               rtol=AUX_RTOL)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("path", PATHS)
def test_dropped_entries_are_the_reference_s(both, path, cf):
    ref, port = both
    _, _, dropped = port[(path, cf, False)]
    want = expected_drops(path, ref[f"topi/{cf}"], cf, *SHAPE)
    np.testing.assert_array_equal(dropped.reshape(want.shape), want)
    assert want.any() == (cf < 1.0)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("S,one_d", DISPATCH,
                         ids=["a2a", "gathered2d", "gathered-1d"])
def test_moe_apply_dispatch_matches_the_reference(both, S, one_d, cf):
    """``moe_apply(mesh=)`` picks the reference's path: at capacity 0.5
    each path drops other entries, so only the same path gives the same
    output."""
    ref, port = both
    y, aux, _ = port[(f"apply{S}", cf, one_d)]
    key = f"apply{S}{int(one_d)}/{cf}"
    np.testing.assert_allclose(y, ref[f"{key}/y"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, float(ref[f"{key}/aux"]),
                               rtol=AUX_RTOL)
