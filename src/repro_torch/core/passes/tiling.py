"""Step 3 — data tiling & task partitioning (paper §V-B).

Port of ``src/repro/core/passes/tiling.py``
(numpy/stdlib only; imports rewritten).

Chooses per-MatOp block sizes so the working set (one X block + one Y block +
one accumulator block) fits the target's fast memory:
  FPGA: p_ca-multiple tiles bounded by the per-PE buffer share (paper: 45 MB
        across 8 PEs → ~5.6 MB of SB/VB/WB/RB per PE).
  H100: multiples of the tensor-core tile the port's kernels use (16),
        bounded by one block's shared memory (227 KiB) at fp32.
The reference's TPU branch (VMEM budget, 128-multiples) has no target in
the port.  Tiles are annotations: no runtime path reads ``op.tiles``.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.core.perf_model import check_target
from repro_torch.core.plan import ExecutionPlan


def _fit_tiles(s1: int, s2: int, s3: int, *, quantum: int, budget_elems: int,
               start: int) -> tuple[int, int, int]:
    bm = bk = bn = start

    def clamp(b, s):
        return max(quantum, min(b, -(-s // quantum) * quantum))

    bm, bk, bn = clamp(bm, s1), clamp(bk, s2), clamp(bn, s3)
    # shrink the largest edge until x-block + y-block + acc fits
    while bm * bk + bk * bn + bm * bn > budget_elems:
        if bm >= max(bk, bn) and bm > quantum:
            bm //= 2
        elif bk >= bn and bk > quantum:
            bk //= 2
        elif bn > quantum:
            bn //= 2
        else:
            break
    return bm, bk, bn


# target -> (tile quantum, starting edge, budget in elements)
TILE_TARGETS = {
    "fpga": (16, 256, (45 * 2**20 // 8) // 2),   # per-PE fp16 buffer share
    "h100": (16, 256, 232448 // 4),              # a block's shared memory
}


def assign_tiles(plan: ExecutionPlan, *, target: str = "fpga"
                 ) -> ExecutionPlan:
    with obs.span("pass.tiling", cat="compile", plan=plan.name,
                  ops=len(plan.ops), target=target):
        return _assign_tiles(plan, target=target)


def _assign_tiles(plan: ExecutionPlan, *, target: str) -> ExecutionPlan:
    check_target(target)
    quantum, start, budget = TILE_TARGETS[target]
    for op in plan.ops:
        if op.kind in {"mm", "sddmm", "knn_graph"}:
            op.tiles = _fit_tiles(op.attrs["s1"], op.attrs["s2"],
                                  op.attrs["s3"], quantum=quantum,
                                  budget_elems=budget, start=start)
        elif op.kind == "conv":
            cout, ho, wo = op.out_shape[-3:]
            k1, k2 = op.attrs["k"]
            cin = op.weights["w"].shape[2]
            # shift-conv grid: (c_out/bm, c_in/bk); plane stays resident
            plane = ho * wo
            bm, bk, _ = _fit_tiles(cout, cin, plane, quantum=quantum,
                                   budget_elems=max(budget - plane, quantum
                                                    * quantum),
                                   start=start)
            op.tiles = (bm, bk, plane)
    plan.meta["tiling_target"] = target
    return plan
