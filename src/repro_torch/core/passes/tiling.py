"""Step 3 — data tiling & task partitioning (paper §V-B).

Port of ``src/repro/core/passes/tiling.py``
(numpy/stdlib only; imports rewritten).

Chooses per-MatOp block sizes so the working set (one X block + one Y block +
one accumulator block) fits the target's fast memory:
  TPU:  VMEM budget (default 8 MiB of the ~16 MiB, fp32 accumulation) with
        MXU-aligned (multiples-of-128) edges — these become the BlockSpec
        parameters of the Pallas kernels.
  FPGA: p_ca-multiple tiles bounded by the per-PE buffer share (paper: 45 MB
        across 8 PEs → ~5.6 MB of SB/VB/WB/RB per PE).
"""
from __future__ import annotations

from repro_torch import obs
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


def assign_tiles(plan: ExecutionPlan, *, target: str = "tpu",
                 vmem_budget_bytes: int = 8 * 2**20) -> ExecutionPlan:
    with obs.span("pass.tiling", cat="compile", plan=plan.name,
                  ops=len(plan.ops), target=target):
        return _assign_tiles(plan, target=target,
                             vmem_budget_bytes=vmem_budget_bytes)


def _assign_tiles(plan: ExecutionPlan, *, target: str,
                  vmem_budget_bytes: int) -> ExecutionPlan:
    quantum = 128 if target == "tpu" else 16
    start = 512 if target == "tpu" else 256
    budget = vmem_budget_bytes // 4          # fp32 accumulation elements
    if target == "fpga":
        budget = (45 * 2**20 // 8) // 2      # per-PE fp16 buffer share
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
