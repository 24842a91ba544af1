"""Analytic performance models — port of ``src/repro/core/perf_model.py``.

Two models, used at different layers of the compiler:

1. **FPGA cycle model** — GCV-Turbo's own primitive latency formulas (paper
   §IV-A), parameterized by the paper's implementation constants (p_ca =
   16, 8 PEs, f_cu = 600 MHz, f_buffer = 300 MHz, 77 GB/s DDR, 45 MB
   on-chip).  Drives (a) the Step-4 sparsity-aware primitive selection
   under ``target="fpga"`` (``select_primitive``) and (b) the Step-5 cycle
   annotations on every op.

2. **H100 model** — the Step-4b cost of each concrete realization of an
   op on one NVIDIA H100 SXM (``predict_kernel_seconds``): the plain-torch
   twin or the hand-written CUDA kernel.  The reference keeps a TPU
   roofline here; none of its constants is carried over.  A call costs the
   larger of its host floor (Python, the wrapper's checks and its launches:
   a fixed cost per realization, since launches queue ahead of the device)
   and its device time (the roofline of the call's bytes and operations
   over an efficiency factor per realization).  The card's rates are
   NVIDIA's data-sheet peaks; the floors and efficiencies are fitted to
   this card's measurements (PERF.md §5-§6).  Under ``target="h100"`` it
   also prices Step 4's sparse-vs-dense decision, by device time alone.
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

# The Step-4 cost targets: the paper's FPGA (the default) and one H100.
TARGETS = ("fpga", "h100")


def check_target(target: str) -> None:
    if target not in TARGETS:
        raise ValueError(f"target={target!r}: Step 4 prices the targets "
                         f"{TARGETS}")


def select_primitive(s1: int, s2: int, s3: int, nnz: int, *,
                     target: str = "fpga", columns: bool = False) -> str:
    """Step-4 decision for X(s1,s2) @ Y(s2,s3), nnz(X) given.

    Returns 'SpDMM' when the sparse realization is predicted faster on the
    target, else 'DDMM'. Compile-time only — latency stays deterministic.

    ``"fpga"``: the paper's cycle formulas, nnz the nonzeros of X.
    ``"h100"``: the ELL SpDMM kernel against the DDMM kernel by the H100
    model's device time (roofline over efficiency, no host floor: a
    request is a CUDA-graph replay, whose cost is its device time), nnz the
    ELL's stored slots; ``columns`` when X is the op's left operand (the
    ELL columns kernel, one dependent load a slot).
    """
    check_target(target)
    if target == "fpga":
        return ("SpDMM" if FPGA.spdmm_cycles(nnz, s3)
                < FPGA.ddmm_cycles(s1, s2, s3) else "DDMM")
    dims = dict(s1=s1, s2=s2, s3=s3, nnz=nnz, device_only=True)
    sparse = predict_kernel_seconds("cuda_ell_spdmm", columns=columns, **dims)
    dense = predict_kernel_seconds("cuda_ddmm", **dims)
    return "SpDMM" if sparse < dense else "DDMM"


# ---------------------------------------------------------------------------
# Step-4b kernel-realization costs on the H100.  ``select_primitive`` above
# makes the paper's *structural* sparse-vs-dense decision; these predict the
# runtime cost of each concrete software realization of the chosen
# primitive (plain torch vs hand-written CUDA), so the compiler can bind
# ``op.kernel`` per op.


@dataclasses.dataclass(frozen=True)
class H100Model:
    """NVIDIA H100 SXM (data sheet, dense rates, 700 W)."""
    hbm_bw: float = 3.35e12          # B/s
    fp32_flops: float = 67e12        # fp32 outside the tensor cores
    # fp32-accurate products as three TF32 tensor-core products each
    # (shift-conv, DDMM's tensor-core route, SDDMM)
    tf32x3_flops: float = 495e12 / 3

    def seconds(self, realization: "Realization", nbytes: float,
                flops: float, rate: float, device_only: bool = False
                ) -> float:
        """The call's device time (its roofline over the realization's
        efficiency) or, unless ``device_only``, the host floor where that
        is larger."""
        roofline = max(nbytes / self.hbm_bw, flops / rate)
        device = roofline / realization.efficiency
        return device if device_only else max(realization.host_s, device)


@dataclasses.dataclass(frozen=True)
class Realization:
    """One realization's fitted constants: ``host_s``, the host's fixed
    cost of one call (the floor of a launch-bound call's time), and
    ``efficiency``, the share of the roofline's rate its device work
    reaches."""
    host_s: float
    efficiency: float


H100 = H100Model()

# Fitted on the card (PERF.md §5, "Step 4b" table): each realization's
# host floor and efficiency.  The plain twins launch several PyTorch
# kernels each (a conv's pad, tap stack and GEMM; the gather SpDMM's index,
# mask, multiply and sum; KNN's per-feature distance passes and sort).
H100_REALIZATIONS = {
    "torch_dense": Realization(15e-6, 0.47),       # cuBLAS SGEMM
    # a VIP without a mask: cuBLAS's x @ xᵀ (b3's spatial Gram, 196 x 512,
    # takes 15-24 us there against DDMM's 13-16)
    "torch_gram": Realization(18e-6, 0.47),
    "cuda_ddmm": Realization(17e-6, 0.10),         # csrc/ddmm.cu
    "torch_conv": Realization(45e-6, 0.40),        # conv2d_ref
    "cuda_conv": Realization(16e-6, 0.12),         # csrc/shift_conv.cu
    "torch_ell_spdmm": Realization(120e-6, 0.30),  # spdmm_rows_ref
    "cuda_ell_spdmm": Realization(22e-6, 0.20),    # csrc/spdmm.cu
    "torch_sddmm": Realization(30e-6, 0.40),       # sddmm_ref
    "cuda_sddmm": Realization(24e-6, 0.05),        # csrc/sddmm.cu
    "torch_knn": Realization(60e-6, 0.15),         # knn_ref
    "cuda_knn": Realization(20e-6, 0.01),          # csrc/knn.cu
    "coo_scatter": Realization(20e-6, 0.30),
    "torch_ew": Realization(8e-6, 0.50),
}
# Host time of each tap a plain conv slices out (conv2d_ref's Python loop).
TORCH_CONV_TAP_S = 4e-6
# The ELL columns kernel (an ELL matrix on the left of its product) gives
# each output column one thread, which walks every stored slot in turn:
# its device time is the slots times one dependent load each, whatever
# the roofline says (csrc/spdmm.cu; fitted on its times in PERF.md §5).
ELL_COLUMN_SLOT_S = 1e-7
# Off the card the wrappers run their plain versions, so a ``cuda_*``
# candidate is never faster there.  The factor only needs to make every
# one of them lose (the reference's interpret-mode penalty).
OFF_CARD_PENALTY = 100.0


def predict_kernel_seconds(kernel: str, *, s1: int = 1, s2: int = 1,
                           s3: int = 1, nnz: int | None = None,
                           out_elems: int | None = None,
                           backend: str = "cuda", taps: int = 1,
                           conv: bool = False, masked: bool = False,
                           columns: bool = False,
                           device_only: bool = False) -> float:
    """Predicted seconds for one op realized by ``kernel`` (H100 model).

    ``s1/s2/s3`` are the dims of the op's product ``(s1, s2) @ (s2, s3)``
    (a conv: its im2col GEMM over every image, ``taps`` = k1·k2; an ELL
    product in the orientation ``A (s1, s2) @ Y (s2, s3)`` with ``nnz``
    stored slots, ``columns`` when the ELL matrix is the op's left operand;
    KNN: ``s1`` points of ``s2`` features, ``nnz = s1·k``); ``out_elems``
    the output size of a non-matrix op; ``masked`` a VIP with a
    compile-time mask (the SDDMM kernel; without one both members run a
    dense ``x @ xᵀ``).  ``backend`` is where the plan runs: ``"cuda"``, or
    ``"cpu"``, where every ``cuda_*`` candidate pays ``OFF_CARD_PENALTY``.
    ``device_only``: the device time alone, without the host floors.
    """
    m = H100

    def cost(real, nbytes, flops, rate):
        return m.seconds(real, nbytes, flops, rate, device_only)

    bpe = 4                                       # runtime arrays are fp32
    gemm_bytes = bpe * (s1 * s2 + s2 * s3 + s1 * s3)
    gemm_flops = 2.0 * s1 * s2 * s3
    if kernel in ("torch_dense", "cuda_ddmm") and conv:
        real = H100_REALIZATIONS["cuda_conv" if kernel == "cuda_ddmm"
                                 else "torch_conv"]
        if kernel == "cuda_ddmm":
            # the shift-conv reads each input pixel, not its taps
            nbytes = bpe * (s1 * s2 / taps + s2 * s3 + s1 * s3)
            base = cost(real, nbytes, gemm_flops, m.tf32x3_flops)
        else:
            # pad, stack the taps (written, then read by the GEMM)
            nbytes = gemm_bytes + 2.0 * bpe * s1 * s2
            base = cost(real, nbytes, gemm_flops, m.fp32_flops)
            if not device_only:
                base = max(base, real.host_s + TORCH_CONV_TAP_S * taps)
    elif kernel == "torch_dense" or (kernel == "torch_sddmm"
                                     and not masked):
        real = H100_REALIZATIONS["torch_dense" if kernel == "torch_dense"
                                 else "torch_gram"]
        base = cost(real, gemm_bytes, gemm_flops, m.fp32_flops)
    elif kernel == "cuda_ddmm" or (kernel == "cuda_sddmm" and not masked):
        base = cost(H100_REALIZATIONS["cuda_ddmm"], gemm_bytes,
                    gemm_flops, m.tf32x3_flops)
    elif kernel in ("torch_ell_spdmm", "cuda_ell_spdmm"):
        n = nnz if nnz is not None else s1 * s2
        nbytes = 8.0 * n + bpe * (s2 * s3 + s1 * s3)
        if kernel == "torch_ell_spdmm":
            # the gather materializes the (s1, L, s3) block: written, then
            # masked, multiplied and summed
            nbytes += 4.0 * bpe * n * s3
        base = cost(H100_REALIZATIONS[kernel], nbytes, 2.0 * n * s3,
                    m.fp32_flops)
        if kernel == "cuda_ell_spdmm" and columns:
            base = max(base, n * ELL_COLUMN_SLOT_S)
    elif kernel == "torch_sddmm":
        # the dense product, then the mask multiplied in another pass
        base = cost(H100_REALIZATIONS[kernel],
                    gemm_bytes + 3.0 * bpe * s1 * s3, gemm_flops,
                    m.fp32_flops)
    elif kernel == "cuda_sddmm":
        base = cost(H100_REALIZATIONS[kernel],
                    gemm_bytes + bpe * s1 * s3, gemm_flops,
                    m.tf32x3_flops)
    elif kernel in ("torch_knn", "cuda_knn"):
        kk = max(1, math.ceil((nnz if nnz else s1) / max(s1, 1)))
        io = bpe * (s1 * s2 + s1 + s1 * kk)
        flops = 3.0 * s1 * s3 * s2
        if kernel == "torch_knn":
            # per-feature (N, N) passes, the distances, the mask and a
            # stable sort of every row's (key, index) pairs
            io += bpe * s1 * s3 * (3.0 * s2 + 8.0) + 64.0 * s1 * s3
        base = cost(H100_REALIZATIONS[kernel], io, flops, m.fp32_flops)
    elif kernel == "coo_scatter":
        n = nnz if nnz is not None else s1 * s2
        nbytes = 12.0 * n + 2.0 * bpe * (n * s3 + (s1 + s2) * s3)
        base = cost(H100_REALIZATIONS[kernel], nbytes, 2.0 * n * s3,
                    m.fp32_flops)
    else:                                         # torch_ew and friends
        elems = out_elems if out_elems is not None else s1 * s3
        base = cost(H100_REALIZATIONS["torch_ew"], 2.0 * bpe * elems,
                    0.0, m.fp32_flops)
    if kernel.startswith("cuda_") and backend != "cuda":
        base *= OFF_CARD_PENALTY
    return base
