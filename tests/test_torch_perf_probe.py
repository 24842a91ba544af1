"""``launch/perf_probe.py``: one dry-run cell's byte contributors.

On a small cell (a smoke config over a (2, 4) fake mesh, ``dims=``): the
rows ``StepCounter`` keeps per ``(op name, operand shapes)`` sum to the
cell's ``bytes_per_device`` exactly, come most bytes first, and the
printout carries the reference's totals line; the entry point runs as a
module.  No JAX: the probe is the port's own.
"""
from __future__ import annotations

import pytest

from repro_torch import configs
from repro_torch.launch import perf_probe

MESH = ((2, 4), ("data", "model"))
CELLS = [("llama3.2-1b", "decode_32k", {"seq_len": 64, "global_batch": 8}),
         ("deepseek-v3-671b", "decode_32k", {"seq_len": 64,
                                             "global_batch": 1}),
         ("llama3.2-1b", "prefill_32k", {"seq_len": 32, "global_batch": 2})]


@pytest.mark.parametrize("arch,shape,dims", CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_rows_sum_to_the_cells_bytes_and_are_sorted(arch, shape, dims):
    res, rows = perf_probe.probe(arch, shape, top=None,
                                 cfg=configs.get_smoke(arch),
                                 mesh_shape=MESH, dims=dims)
    assert res["status"] == "ok"
    assert sum(r[0] for r in rows) == res["bytes_per_device"] > 0
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert all(calls >= 1 and isinstance(op, str) and
               all(isinstance(s, tuple) for s in shapes)
               for _, calls, op, shapes in rows)
    text = perf_probe.report(res, rows[:5])
    assert text.splitlines()[0].startswith("flops/dev ")
    assert "coll/dev" in text.splitlines()[0]
    assert len(text.split("\n    ")) == 6


def test_top_keeps_the_largest_rows():
    kw = dict(cfg=configs.get_smoke("llama3.2-1b"), mesh_shape=MESH,
              dims={"seq_len": 64, "global_batch": 8})
    _, every = perf_probe.probe("llama3.2-1b", "decode_32k", top=None, **kw)
    _, top = perf_probe.probe("llama3.2-1b", "decode_32k", top=3, **kw)
    assert top == every[:3]
