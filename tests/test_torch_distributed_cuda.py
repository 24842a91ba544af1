"""The LM over a device mesh on the card: ranks of an NCCL group, one a
card, spawned by ``tools/ranks.py``, run ``chip_smoke.dist_rank_smoke``:
the sharded train step of llama3.2-1b and of deepseek-v3 (its MoE through
``moe_a2a``) held to the one-card step with the flash forward and
backward launched, a deepseek-v3 decode step over the mesh and its MoE's
gathered paths, a checkpoint saved from the mesh and restored onto it,
and the rest (``chip_smoke.dist_rest_smoke``): ``ServeEngine(mesh=)``'s
tokens against the engine without a mesh with flash launched in its
prefills, zamba2's step and decode against no mesh, and an int8 step on
placed parameters bit for bit.  One rank on a one-card host (a (1, 1) mesh: NCCL takes one rank a
card); four ranks over a (2, 2) mesh where four cards are visible.  Run
with ``python -m pytest -m cuda tests/test_torch_distributed_cuda.py`` on
the card; they skip without one.  Imports no JAX.
"""
from __future__ import annotations

import pathlib
import sys

import pytest
import torch

from test_torch_cuda import cuda  # noqa: F401  (the card fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402
from ranks import run_ranks  # noqa: E402


def run_smoke(world, tmp_path):
    from repro_torch.kernels import _build
    _build.build()                  # once, here, before the ranks load it
    res = run_ranks(chip_smoke.dist_rank_smoke, world, str(tmp_path),
                    device_type="cuda", timeout_s=600)
    for r in res:
        assert all(all(c.values()) for c in r["launches"].values())
    return res[0]["lines"]


@pytest.mark.cuda
def test_one_rank_nccl_group_runs_the_sharded_step(cuda, tmp_path):
    lines = run_smoke(1, tmp_path)
    assert "mesh (1, 1)" in lines[0]


@pytest.mark.cuda
def test_four_rank_nccl_group_runs_the_sharded_step(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards (NCCL takes one rank a card)")
    lines = run_smoke(4, tmp_path)
    assert "mesh (2, 2)" in lines[0]


@pytest.mark.cuda
def test_one_rank_nccl_group_serves_and_trains_the_rest(cuda):
    from repro_torch.kernels import _build
    _build.build()
    lines = run_ranks(chip_smoke.dist_rank_rest, 1, device_type="cuda",
                      timeout_s=600)[0]
    assert "equal to the engine without a mesh: True" in lines[0]
    assert lines[-1].endswith("bit for bit: True")
