"""Step 5 — task scheduling + cost/buffer planning (paper §V-B).

Port of ``src/repro/core/passes/schedule.py``
(numpy/stdlib only; imports rewritten).

The accelerator processes the model layer-by-layer; within a layer the APU
load-balances row-blocks over the 8 PEs (centralized scheme [43]). This pass
(1) fixes the op order (topological — already SSA order),
(2) computes per-op FPGA cycle counts from the Step-4 primitive bindings,
(3) computes per-op FLOPs / memory traffic,
(4) runs buffer liveness to find the peak on-chip working set and decides
    whether weights are DRAM-resident (> 45 MB) or loaded once (the paper's
    Table VI distinction that explains b1/b4-b6's larger speedups).
Aggregates land in ``plan.meta`` for the benchmark suite.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.perf_model import FPGA
from repro_torch.core.plan import ExecutionPlan, MatOp


def _op_cost(op: MatOp) -> tuple[float, float, float]:
    """-> (fpga_cycles_one_pe, flops, bytes_moved)."""
    bpe = FPGA.bytes_per_elem
    out_elems = float(np.prod(op.out_shape)) if op.out_shape else 0.0
    if op.kind == "conv":
        k1, k2 = op.attrs["k"]
        cin = op.weights["w"].shape[2]
        batch = op.attrs.get("batch", 1)
        cout, ho, wo = op.out_shape[-3:]
        macs = batch * k1 * k2 * cin * cout * ho * wo
        cycles = batch * k1 * k2 * (FPGA.ddmm_cycles(cout, cin, ho * wo)
                                    + FPGA.pvva_cycles(cout * ho * wo))
        flops = 2.0 * macs
        bts = bpe * (batch * (cin + cout) * ho * wo
                     + op.weights["w"].size)
        return cycles, flops, bts
    if op.kind == "mm":
        s1, s2, s3 = op.attrs["s1"], op.attrs["s2"], op.attrs["s3"]
        if op.primitive == "SpDMM":
            nnz_pad = op.ell[0].size if op.ell is not None \
                else op.attrs["nnz"]
            cycles = FPGA.spdmm_cycles(op.attrs["nnz"], s3)
            flops = 2.0 * nnz_pad * s3
            bts = bpe * (nnz_pad * 2 + s2 * s3 + s1 * s3)
        else:
            cycles = FPGA.ddmm_cycles(s1, s2, s3)
            flops = 2.0 * s1 * s2 * s3
            bts = bpe * (s1 * s2 + s2 * s3 + s1 * s3)
        return cycles, flops, bts
    if op.kind == "knn_graph":
        # distance DDMM off the computation array + k selection sweeps on
        # the vector units; only points in and int32 indices out move.
        s1, s2, s3 = op.attrs["s1"], op.attrs["s2"], op.attrs["s3"]
        cycles = (FPGA.ddmm_cycles(s1, s2, s3)
                  + FPGA.psvm_cycles(op.attrs["k"] * s1 * s3))
        return cycles, 2.0 * s1 * s2 * s3, bpe * s1 * s2 + 4.0 * out_elems
    if op.kind == "sddmm":
        s1, s2, s3 = op.attrs["s1"], op.attrs["s2"], op.attrs["s3"]
        nnz = op.attrs["nnz"]
        cycles = FPGA.sddmm_cycles(nnz, s2)
        return cycles, 2.0 * nnz * s2, bpe * (s1 * s2 + s2 * s3 + nnz)
    if op.kind == "maxagg":
        cycles = FPGA.spdmm_cycles(op.attrs["nnz"], op.attrs["s3"])
        flops = 1.0 * op.attrs["nnz"] * op.attrs["s3"]
        return cycles, flops, bpe * (out_elems * 2)
    if op.kind == "ew":
        cycles = (FPGA.pvva_cycles(out_elems)
                  if op.attrs["fn"] == "add" else
                  FPGA.psvm_cycles(out_elems))
        return cycles, out_elems, bpe * out_elems * 2
    if op.kind in {"pool2d", "globalpool"}:
        return FPGA.pvva_cycles(out_elems), out_elems, bpe * out_elems * 2
    if op.kind == "transpose":           # unfused DM layer: memory-bound
        bts = float(op.attrs.get("bytes", out_elems * bpe)) * 2
        cycles = bts / (FPGA.p_ca * FPGA.bytes_per_elem * FPGA.n_pe)
        return cycles, 0.0, bts
    return 0.0, 0.0, 0.0                 # identity / reshape / concat


def schedule_plan(plan: ExecutionPlan) -> ExecutionPlan:
    with obs.span("pass.schedule", cat="compile", plan=plan.name,
                  ops=len(plan.ops)):
        return _schedule_plan(plan)


def _schedule_plan(plan: ExecutionPlan) -> ExecutionPlan:
    total_cycles = total_flops = total_bytes = 0.0
    weight_bytes = 0
    for op in plan.ops:
        op.cycles, op.flops, op.bytes_moved = _op_cost(op)
        total_cycles += op.cycles
        total_flops += op.flops
        total_bytes += op.bytes_moved
        weight_bytes += sum(w.size * FPGA.bytes_per_elem
                            for w in op.weights.values())
        if op.ell is not None:
            weight_bytes += op.ell[0].size * 6   # idx int32 + val fp16

    # buffer liveness -> peak working set (tensor freed after last use)
    last_use: dict[str, int] = {}
    for i, op in enumerate(plan.ops):
        for inp in op.inputs:
            last_use[inp] = i
    for o in plan.outputs:
        last_use[o] = len(plan.ops)
    live: dict[str, float] = {}
    peak = 0.0
    for i, op in enumerate(plan.ops):
        live[op.name] = float(np.prod(op.out_shape)) * FPGA.bytes_per_elem \
            if op.out_shape else 0.0
        peak = max(peak, sum(live.values()))
        for t in [t for t, last in last_use.items() if last == i]:
            live.pop(t, None)

    onchip = weight_bytes + peak <= FPGA.onchip_bytes
    # latency: per-op max(compute, memory) with weights DRAM-streamed
    # when the model does not fit on-chip (paper §VII-B1 discussion)
    latency = 0.0
    for op in plan.ops:
        bytes_eff = op.bytes_moved if not onchip else (
            op.bytes_moved - sum(w.size * FPGA.bytes_per_elem
                                 for w in op.weights.values()))
        latency += FPGA.op_seconds(op.cycles, max(bytes_eff, 0.0))
    if not onchip:
        latency += weight_bytes / FPGA.dram_bw * 0.0  # already per-op

    plan.meta.update({
        "total_cycles_one_pe": total_cycles,
        "total_flops": total_flops,
        "total_bytes": total_bytes,
        "weight_bytes": weight_bytes,
        "peak_buffer_bytes": peak,
        "weights_fit_onchip": bool(onchip),
        "fpga_latency_s": latency,
        "portion_cycles": plan.portion_cycles(),
    })
    return plan
