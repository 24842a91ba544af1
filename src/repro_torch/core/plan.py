"""Matrix-operation IR + ExecutionPlan (the compiler's output artifact).

Port of ``src/repro/core/plan.py``; only the kernel lattice differs.

After Step 2 every layer is a list of ``MatOp``s — matrix multiplications,
sampled products, elementwise vector ops and the residual data-manipulation
ops that could not be fused. Steps 3-5 annotate tiling, primitive choice and
schedule/cost onto the same structure. The final ``ExecutionPlan`` is the
analogue of the paper's instruction-sequence binary: a flat, ordered program
the executor (or the APU, on the FPGA) runs layer by layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

MATOP_KINDS = frozenset({
    "mm",          # dense/sparse matmul (primitive chosen in Step 4)
    "conv",        # Fig. 7 shift-add conv (k1k2 DDMMs + PVVA merge)
    "sddmm",       # sampled dense-dense
    "ew",          # elementwise (PSVM/PVVA family: act, scale, add, softmax)
    "pool2d", "globalpool", "maxagg",
    "knn_graph",   # dynamic graph construction: points -> neighbor indices
    "transpose", "reshape", "concat", "identity",
})

# The kernel lattice: every concrete realization a MatOp can dispatch to at
# runtime.  ``op.primitive`` stays the paper's *hardware primitive* (DDMM /
# SpDMM / SDDMM / PSVM / PVVA — the Step-4 structural decision and the
# Step-5 costing vocabulary); ``op.kernel`` is the *software realization*
# of that primitive Step 4 additionally binds (plain torch vs hand-written
# CUDA, gather vs scatter).  Two names per primitive family where both
# realizations exist; each ``torch_*`` name is the plain-PyTorch twin of the
# ``cuda_*`` kernel beside it (the reference's ``xla_*``/``pallas_*`` pairs).
KERNELS = frozenset({
    "torch_dense",      # dense matmul / conv in plain torch
    "cuda_ddmm",        # CUDA DDMM kernel (conv: the shift-conv kernel)
    "torch_ell_spdmm",  # ELL gather+FMA in plain torch (spdmm twin)
    "cuda_ell_spdmm",   # CUDA ELL SpDMM kernel
    "coo_scatter",      # COO segment scatter/gather (only realization)
    "torch_sddmm",      # masked dense product in plain torch
    "cuda_sddmm",       # CUDA blockwise sampled-dense-dense kernel
    "torch_knn",        # materialized (N,N) distances + top-k
    "cuda_knn",         # fused tiled distance + online top-k kernel
    "torch_ew",         # everything non-matrix (ew/pool/layout)
})

# Realization families (used by runtime dispatch and residency planning).
DENSE_KERNELS = frozenset({"torch_dense", "cuda_ddmm"})
ELL_KERNELS = frozenset({"torch_ell_spdmm", "cuda_ell_spdmm"})
SDDMM_KERNELS = frozenset({"torch_sddmm", "cuda_sddmm"})
KNN_KERNELS = frozenset({"torch_knn", "cuda_knn"})


@dataclasses.dataclass
class MatOp:
    name: str
    kind: str
    inputs: tuple[str, ...]
    weights: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    out_shape: tuple[int, ...] = ()
    portion: str = "other"           # 'cnn' | 'gnn' | 'dm' | 'other'
    # ---- Step 3: tiling ----
    tiles: tuple[int, int, int] | None = None
    # ---- Step 4: primitive mapping ----
    primitive: str | None = None     # DDMM/SpDMM/SDDMM/PSVM/PVVA/none
    ell: tuple[np.ndarray, np.ndarray] | None = None
    # ---- Step 4b: kernel selection (one of KERNELS) ----
    kernel: str | None = None
    # ---- Step 5: cost/schedule ----
    cycles: float = 0.0              # FPGA cycles (one PE, pre-balancing)
    bytes_moved: float = 0.0
    flops: float = 0.0
    # ---- Step 6: liveness ----
    frees: tuple[str, ...] = ()      # env entries dead after this op runs

    def __post_init__(self):
        assert self.kind in MATOP_KINDS, self.kind


@dataclasses.dataclass
class ExecutionPlan:
    name: str
    input_names: list[str]
    ops: list[MatOp]
    outputs: list[str]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def primitive_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for op in self.ops:
            key = op.primitive or op.kind
            counts[key] = counts.get(key, 0) + 1
        return counts

    def kernel_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for op in self.ops:
            key = op.kernel or "unselected"
            counts[key] = counts.get(key, 0) + 1
        return counts

    def portion_cycles(self) -> dict[str, float]:
        agg: dict[str, float] = {}
        for op in self.ops:
            agg[op.portion] = agg.get(op.portion, 0.0) + op.cycles
        return agg

    def peak_live_bytes(self, *, free_dead: bool = True,
                        itemsize: int = 4) -> int:
        """Peak environment working set (bytes) of one plan execution.

        ``free_dead=True`` honours the Step-6 liveness annotations (the
        runtime's behaviour); ``free_dead=False`` models the keep-everything
        executor for comparison.  Per-sample; batched execution scales the
        activations linearly."""
        live: dict[str, int] = {}
        for name, shape in self.meta.get("input_shapes", {}).items():
            live[name] = int(np.prod(shape)) * itemsize
        peak = sum(live.values())
        for op in self.ops:
            live[op.name] = int(np.prod(op.out_shape)) * itemsize \
                if op.out_shape else itemsize
            peak = max(peak, sum(live.values()))
            if free_dead:
                for name in op.frees:
                    live.pop(name, None)
        return peak
