"""Analytic performance model — port of ``src/repro/core/perf_model.py``.

**FPGA cycle model** — GCV-Turbo's own primitive latency formulas (paper
§IV-A), parameterized by the paper's implementation constants (p_ca = 16,
8 PEs, f_cu = 600 MHz, f_buffer = 300 MHz, 77 GB/s DDR, 45 MB on-chip).
Drives (a) the Step-4 sparsity-aware primitive selection when targeting the
paper's accelerator, and (b) the Step-5 cycle annotations on every op.

The reference's TPU roofline (``TPUModel``, ``predict_kernel_seconds``) is
not carried over: the port's Step 4b needs an H100 model instead (ROADMAP
queue 1 item 3), so only ``target="fpga"`` is supported here.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FPGAModel:
    """Alveo U250 GCV-Turbo instance (paper §VI)."""
    p_ca: int = 16           # computation-array dimension per PE
    n_pe: int = 8            # PEs (4 SLRs x 2, minus shell share)
    f_cu: float = 600e6      # computation-unit clock
    f_buf: float = 300e6     # buffer clock
    dram_bw: float = 77e9    # B/s
    onchip_bytes: int = 45 * 2**20
    bytes_per_elem: int = 2  # fp16

    # -- primitive latencies, in compute cycles on ONE PE (paper formulas) --
    def ddmm_cycles(self, s1: int, s2: int, s3: int) -> float:
        """2-D systolic: a (p,p) output tile per s2 cycles."""
        p = self.p_ca
        return math.ceil(s1 / p) * math.ceil(s3 / p) * max(s2, p)

    def spdmm_cycles(self, nnz: int, s3: int) -> float:
        """l = ceil(nnz / (p/2)) * ceil(s3 / p)   (paper §IV-A)."""
        p = self.p_ca
        return math.ceil(nnz / (p / 2)) * math.ceil(s3 / p)

    def sddmm_cycles(self, nnz_a: int, s2: int) -> float:
        """l = ceil(nnz(A) / (p/2)) * ceil(s2 / p) (paper §IV-A)."""
        p = self.p_ca
        return math.ceil(nnz_a / (p / 2)) * math.ceil(s2 / p)

    def psvm_cycles(self, n_ops: int) -> float:
        return n_ops / (self.p_ca ** 2 / 2)

    def pvva_cycles(self, n_ops: int) -> float:
        return n_ops / (self.p_ca ** 2 / 2)

    # -- plan-level latency --------------------------------------------------
    def op_seconds(self, cycles_one_pe: float, bytes_moved: float,
                   balance: float = 1.0) -> float:
        """Latency of one scheduled op: compute distributed over PEs by the
        centralized load-balancer (Step 5), overlapped with memory traffic
        (the paper pipelines loads behind compute), so latency = max(terms).
        ``balance`` >= 1 models imperfect PE balance."""
        compute = cycles_one_pe * balance / self.n_pe / self.f_cu
        memory = bytes_moved / self.dram_bw
        return max(compute, memory)


FPGA = FPGAModel()


def select_primitive(s1: int, s2: int, s3: int, nnz: int, *,
                     target: str = "fpga") -> str:
    """Step-4 decision for X(s1,s2) @ Y(s2,s3), nnz(X) given.

    Returns 'SpDMM' when the sparse realization is predicted faster on the
    target, else 'DDMM'. Compile-time only — latency stays deterministic.
    """
    if target != "fpga":
        raise NotImplementedError(
            f"target={target!r}: the port costs only the paper's FPGA; a "
            f"GPU cost model is ROADMAP queue 1 item 3")
    return ("SpDMM" if FPGA.spdmm_cycles(nnz, s3)
            < FPGA.ddmm_cycles(s1, s2, s3) else "DDMM")
