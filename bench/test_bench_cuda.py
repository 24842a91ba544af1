"""The cells on the card, briefly: each single-card cell runs a short
window at its full size and comes out correct.  Marked ``cuda``: they
skip without a card (decided inside the test), and run on the card with

    python3 -m pytest -q -m cuda bench/test_bench_cuda.py
"""
from __future__ import annotations

import time

import pytest
import torch

from gcvbench import harness, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["b2-open", "b2-closed"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run_cell(spec.load_cell(cell), 2**31 + 99, 2.0, False,
                           t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
