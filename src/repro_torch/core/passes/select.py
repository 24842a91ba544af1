"""Step 4 — sparsity-aware primitive mapping (paper §V-C5) + Step 4b,
per-op kernel selection.  Port of ``src/repro/core/passes/select.py``.

Every matrix operation is bound to one of the five hardware primitives.
For matmuls with a compile-time-known operand (layer weights, graph
adjacency) the pass inspects the operand's nnz and picks DDMM vs SpDMM from
the FPGA latency model (``core/perf_model.select_primitive``). Chosen SpDMM
operands are converted to ELL (idx, val) *at compile time* — the paper's
offline three-tuple preparation — so execution latency stays deterministic.

Runtime-valued matmuls (b1's learned affinity) always map to DDMM: their
sparsity is unknown at compile time, and the paper explicitly rejects
on-the-fly sparsity profiling (FlowGNN discussion, §VII-D2).

``enable=False`` maps *everything* dense — the §VII-C sparsity ablation.

Step 4b (``select_kernels``) then binds each op's *software realization*
(``op.kernel``, from ``plan.KERNELS``) of the primitive just chosen:

  * ``kernels="torch"`` — the plain-torch member of every family (the
    reference's ``"xla"``);
  * ``kernels="cuda"``  — the hand-written CUDA member wherever the family
    has one, falling back with a recorded reason where none does (the
    reference's ``"pallas"``);
  * ``"auto"`` and ``"measured"`` need a GPU cost model and raise until it
    exists (ROADMAP queue 1 item 3).

Decisions — kernel, candidate set, decision source, fallback reason — land
in ``plan.meta["kernel_choices"]`` keyed by op name.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.perf_model import select_primitive
from repro_torch.core.plan import ExecutionPlan, MatOp

KERNEL_MODES = ("torch", "cuda")


def dense_to_ell(x: np.ndarray,
                 max_nnz: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Convert a dense sparse-valued matrix to ELL ``(idx, val)`` arrays.

    Offline (compile-time) conversion — mirrors the paper's compiler preparing
    the three-tuple representation of the adjacency/weight matrix.  Padding
    slots hold ``idx == 0`` and ``val == 0``.
    """
    x = np.asarray(x)
    S1, _ = x.shape
    nnz_per_row = (x != 0).sum(axis=1)
    L = int(max_nnz if max_nnz is not None else max(1, nnz_per_row.max()))
    idx = np.zeros((S1, L), np.int32)
    val = np.zeros((S1, L), x.dtype)
    for i in range(S1):
        cols = np.nonzero(x[i])[0][:L]
        idx[i, : len(cols)] = cols
        val[i, : len(cols)] = x[i, cols]
    return idx, val


def select_primitives(plan: ExecutionPlan, *, target: str = "fpga",
                      enable: bool = True) -> ExecutionPlan:
    with obs.span("pass.select", cat="compile", plan=plan.name,
                  ops=len(plan.ops), target=target, enable=enable) as sp:
        plan = _select_primitives(plan, target=target, enable=enable)
        sp.set(sparse_ops=plan.meta["sparse_ops"])
        return plan


def _select_primitives(plan: ExecutionPlan, *, target: str,
                       enable: bool) -> ExecutionPlan:
    n_sparse = 0
    for op in plan.ops:
        if op.kind == "conv":
            op.primitive = "DDMM"        # k1k2 DDMMs + PVVA shift-add merge
        elif op.kind == "mm":
            side = op.attrs["weight_side"]
            s1, s2, s3 = op.attrs["s1"], op.attrs["s2"], op.attrs["s3"]
            if side == "left_coo":
                if op.attrs.get("reduce") == "max":
                    # max-reduce is inherently scatter-gather (no dense-MM
                    # realization) — not a Step-4 choice. Matches the paper's
                    # 0% sparsity gain on b6.
                    op.primitive = "SpDMM"
                    continue
                # COO execution is fixed by data availability (densifying a
                # dataset-scale adjacency is infeasible); the Step-4 decision
                # here only sets the *costing* primitive, so the §VII-C
                # ablation charges the DDMM price when disabled.
                op.primitive = "SpDMM" if enable else "DDMM"
                if enable:
                    n_sparse += 1
                continue
            if side == "left_knn":
                # gather over runtime neighbor indices — execution is fixed
                # by data availability (connectivity is a runtime value);
                # Step 4 only sets the costing primitive for the ablation.
                op.primitive = "SpDMM" if enable else "DDMM"
                if enable:
                    n_sparse += 1
                continue
            static = op.weights.get("adj", op.weights.get("w"))
            op.primitive = "DDMM"
            # Only operands with real sparsity are candidates (the paper
            # exploits *data sparsity*; ELL of a ~dense matrix has L = s2
            # and the "win" the tiny-matrix cycle formula suggests is a
            # discretization artifact).
            if (enable and static is not None and side != "left_runtime"
                    and op.attrs.get("density", 1.0) < 0.9):
                nnz = int((static != 0).sum())
                # the matmul's sparse operand is the static one
                choice = select_primitive(s1, s2, s3, nnz, target=target)
                if choice == "SpDMM":
                    # ELL must hold the matrix that ends up on the LEFT of
                    # the executed product: A for 'left' (A@X), A for
                    # 'right_t' ((A@X2ᵀ)ᵀ), wᵀ for 'right' ((wᵀ@Xᵀ)ᵀ).
                    mat = np.asarray(static).T if side == "right" else static
                    op.ell = dense_to_ell(np.asarray(mat))
                    op.primitive = "SpDMM"
                    op.attrs["nnz"] = nnz
                    n_sparse += 1
        elif op.kind == "knn_graph":
            # the (N, N) distance scores are a dense product — a DDMM for
            # costing purposes; the top-k selection is vector work either way
            op.primitive = "DDMM"
        elif op.kind == "sddmm":
            op.primitive = "SDDMM"
        elif op.kind == "maxagg":
            # scatter-gather pipeline with max-reduce GAU (paper §IV-A rho)
            op.primitive = "SpDMM"
            op.ell = dense_to_ell(np.asarray(op.weights["adj"]))
        elif op.kind == "ew":
            fn = op.attrs["fn"]
            op.primitive = "PVVA" if fn == "add" else "PSVM"
        elif op.kind in {"pool2d", "globalpool"}:
            op.primitive = "PVVA"
        else:
            op.primitive = None          # pure layout ops
    plan.meta["sparse_ops"] = n_sparse
    plan.meta["sparsity_aware"] = enable
    plan.meta["select_target"] = target
    return plan


# ------------------------------------------------------- Step 4b: kernels --
def _candidates(op: MatOp) -> tuple[list[str], str | None]:
    """The realization family of one op (plain-torch member first), plus
    the reason when the family is a singleton."""
    if op.kind == "conv":
        # grouped/dilated convs included: the shift-conv kernel takes the
        # group count and dilation directly
        return ["torch_dense", "cuda_ddmm"], None
    if op.kind == "mm":
        side = op.attrs["weight_side"]
        if side == "left_coo":
            return ["coo_scatter"], ("COO scatter is the only realization "
                                     "(dataset-scale adjacency is never "
                                     "densified)")
        if side == "left_knn":
            return ["coo_scatter"], ("runtime-KNN aggregation is inherently "
                                     "gather (connectivity is a runtime "
                                     "value)")
        if op.ell is not None and op.primitive == "SpDMM":
            return ["torch_ell_spdmm", "cuda_ell_spdmm"], None
        return ["torch_dense", "cuda_ddmm"], None
    if op.kind == "sddmm":
        if op.attrs.get("exec") == "coo":
            return ["coo_scatter"], ("per-edge COO inner products have no "
                                     "dense-sampled realization")
        return ["torch_sddmm", "cuda_sddmm"], None
    if op.kind == "maxagg":
        return ["torch_ell_spdmm"], ("max-reduce aggregation is inherently "
                                     "gather (no dense or CUDA path)")
    if op.kind == "knn_graph":
        return ["torch_knn", "cuda_knn"], None
    return ["torch_ew"], "elementwise/layout op — single torch realization"


def select_kernels(plan: ExecutionPlan, *,
                   kernels: str = "cuda") -> ExecutionPlan:
    """Bind ``op.kernel`` for every MatOp and record the decisions.

    Idempotent and re-runnable: calling again with a different mode
    rebinds in place.
    """
    if kernels in ("auto", "measured"):
        raise NotImplementedError(
            f"kernels={kernels!r} needs a GPU cost model "
            f"(ROADMAP queue 1 item 3); use 'torch' or 'cuda'")
    if kernels not in KERNEL_MODES:
        raise ValueError(
            f"kernels must be one of {KERNEL_MODES}, got {kernels!r}")
    with obs.span("pass.select_kernels", cat="compile", plan=plan.name,
                  ops=len(plan.ops), mode=kernels):
        return _select_kernels(plan, kernels=kernels)


def _select_kernels(plan: ExecutionPlan, *, kernels: str) -> ExecutionPlan:
    choices: dict[str, dict] = {}
    for op in plan.ops:
        cands, note = _candidates(op)
        reason = note
        if len(cands) == 1:
            kern, source = cands[0], "only"
        elif kernels == "torch":
            kern, source = cands[0], "forced"
        else:
            kern, source = cands[1], "forced"
        op.kernel = kern
        # no predicted seconds until the GPU cost model exists
        choices[op.name] = {"kernel": kern, "kind": op.kind,
                            "primitive": op.primitive, "candidates": cands,
                            "source": source, "reason": reason}
    plan.meta["kernel_choices"] = choices
    plan.meta["kernel_counts"] = plan.kernel_counts()
    plan.meta["kernels_mode"] = kernels
    return plan
