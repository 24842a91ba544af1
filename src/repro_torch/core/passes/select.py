"""Step 4 — sparsity-aware primitive mapping (paper §V-C5) + Step 4b,
per-op kernel selection.  Port of ``src/repro/core/passes/select.py``.

Every matrix operation is bound to one of the five hardware primitives.
For matmuls with a compile-time-known operand (layer weights, graph
adjacency) the pass inspects the operand's nnz and picks DDMM vs SpDMM from
the FPGA latency model (``core/perf_model.select_primitive``). Chosen SpDMM
operands are converted to ELL (idx, val) *at compile time* — the paper's
offline three-tuple preparation — so execution latency stays deterministic.
``target="h100"`` prices the same decision by the H100 model's device time
(the ELL SpDMM kernel against the DDMM kernel, the ELL matrix on the left
of the executed product, its stored slots as nnz); the default stays the
paper's ``"fpga"``.

Runtime-valued matmuls (b1's learned affinity) always map to DDMM: their
sparsity is unknown at compile time, and the paper explicitly rejects
on-the-fly sparsity profiling (FlowGNN discussion, §VII-D2).

``enable=False`` maps *everything* dense — the §VII-C sparsity ablation.

Step 4b (``select_kernels``) then binds each op's *software realization*
(``op.kernel``, from ``plan.KERNELS``) of the primitive just chosen:

  * ``kernels="auto"``     — pick per candidate family by the H100 model's
    ``predict_kernel_seconds`` at the op's shapes/nnz: the hand-written
    CUDA kernel where it beats its plain twin on the card, the twin where
    it does not (cuBLAS on large dense products); off the card every
    ``cuda_*`` candidate pays the off-card penalty, so ``auto`` binds
    exactly what ``torch`` binds there;
  * ``kernels="torch"``    — the plain-torch member of every family (the
    reference's ``"xla"``);
  * ``kernels="cuda"``     — the hand-written CUDA member wherever the
    family has one, falling back with a recorded reason where none does
    (the reference's ``"pallas"``);
  * ``kernels="measured"`` — time the candidates through the on-disk
    ``core.autotune`` cache and bind the measured winner (the one mode
    allowed to cross primitive families: an ELL op with a live dense
    operand also races the dense kernels).  Off the card the ``cuda_*``
    candidates cannot run, so they are not measured and the twin is bound
    with the reason recorded.

``backend`` is where the plan runs: ``"cuda"`` or ``"cpu"`` (the resolved
device's type; ``None`` reads ``torch.cuda.is_available()``, the
counterpart of the reference's ``jax.default_backend()``).

Decisions — kernel, candidate set, predicted (and measured) seconds of
every candidate, decision source, fallback reason — land in
``plan.meta["kernel_choices"]`` keyed by op name; ``kernel_report``
renders them.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.core.perf_model import (predict_kernel_seconds,
                                         select_primitive)
from repro_torch.core.plan import ELL_KERNELS, ExecutionPlan, MatOp

KERNEL_MODES = ("auto", "torch", "cuda", "measured")


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
                # ELL must hold the matrix that ends up on the LEFT of
                # the executed product: A for 'left' (A@X), A for
                # 'right_t' ((A@X2ᵀ)ᵀ), wᵀ for 'right' ((wᵀ@Xᵀ)ᵀ).
                mat = np.asarray(static).T if side == "right" else static
                # the matmul's sparse operand is the static one
                choice = _choose(mat, side, s1, s2, s3, nnz, target)
                if choice == "SpDMM":
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


def _choose(mat, side: str, s1: int, s2: int, s3: int, nnz: int,
            target: str) -> str:
    """Step 4 for one static operand ``mat`` (as the ELL would hold it).
    The FPGA formula takes the op's dims and nonzeros, as the reference
    does; the H100 the executed product, ELL on the left (``right`` and
    ``right_t`` run ``(A @ x2ᵀ)ᵀ``), and the ELL's stored slots."""
    if target != "h100":
        return select_primitive(s1, s2, s3, nnz, target=target)
    mat = np.asarray(mat)
    slots = mat.shape[0] * max(1, int((mat != 0).sum(1).max()))
    if side in ("right", "right_t"):
        s1, s3 = s3, s1
    return select_primitive(s1, s2, s3, slots, target=target,
                            columns=side == "left")


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


def _op_dims(op: MatOp, kernel: str) -> dict:
    """Product dims + nnz of ``op`` under ``kernel`` for
    ``predict_kernel_seconds`` (its docstring gives the orientation)."""
    a = op.attrs
    out_elems = int(np.prod(op.out_shape)) if op.out_shape else 1
    if op.kind == "conv":
        k1, k2, cin, cout = op.weights["w"].shape
        spatial = int(np.prod(op.out_shape[:-3] + op.out_shape[-2:]))
        return {"s1": spatial, "s2": k1 * k2 * cin, "s3": cout,
                "out_elems": out_elems, "taps": k1 * k2, "conv": True}
    if op.kind == "maxagg":
        n = op.out_shape[0] if op.out_shape else 1
        return {"s1": n, "s2": n, "s3": a.get("s3", 1), "nnz": a.get("nnz")}
    dims = {"s1": a.get("s1", 1), "s2": a.get("s2", 1),
            "s3": a.get("s3", 1), "nnz": a.get("nnz"),
            "out_elems": out_elems}
    if kernel in ELL_KERNELS and op.ell is not None:
        # the ELL matrix on the left, its stored slots as nnz; the right
        # sides run (A @ x2ᵀ)ᵀ in the rows layout
        dims["nnz"] = int(op.ell[0].size)
        if a.get("weight_side") in ("right", "right_t"):
            dims["s1"], dims["s3"] = dims["s3"], dims["s1"]
        else:
            dims["columns"] = True
    if op.kind == "sddmm":
        dims["masked"] = "mask" in op.weights
    return dims


def default_backend() -> str:
    """Where a plan runs when no device is named: ``"cuda"`` on a machine
    with a card, else ``"cpu"``."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def select_kernels(plan: ExecutionPlan, *, kernels: str = "cuda",
                   autotune_cache=None,
                   backend: str | None = None) -> ExecutionPlan:
    """Bind ``op.kernel`` for every MatOp and record the decisions.

    Idempotent and re-runnable: calling again with a different mode or
    backend rebinds in place (``gcv.compile(plan, kernels=...)`` uses
    that to re-target an existing plan).
    """
    if kernels not in KERNEL_MODES:
        raise ValueError(
            f"kernels must be one of {KERNEL_MODES}, got {kernels!r}")
    if backend is None:
        backend = default_backend()
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', got "
                         f"{backend!r}")
    with obs.span("pass.select_kernels", cat="compile", plan=plan.name,
                  ops=len(plan.ops), mode=kernels):
        return _select_kernels(plan, kernels=kernels,
                               autotune_cache=autotune_cache,
                               backend=backend)


def _select_kernels(plan: ExecutionPlan, *, kernels: str,
                    autotune_cache, backend: str) -> ExecutionPlan:
    cache = None
    if kernels == "measured":
        from repro_torch.core.autotune import AutotuneCache, measure_op
        cache = autotune_cache if isinstance(autotune_cache, AutotuneCache) \
            else AutotuneCache(autotune_cache)
    choices: dict[str, dict] = {}
    for op in plan.ops:
        cands, note = _candidates(op)
        if (kernels == "measured" and op.kind == "mm"
                and cands[0] in ELL_KERNELS
                and op.weights.get("adj", op.weights.get("w")) is not None):
            # measured mode may cross the primitive family: the dense
            # operand the ELL superseded is still on the op, so the dense
            # kernels are real (float-tolerance, not bit-identical) rivals
            cands = cands + ["torch_dense", "cuda_ddmm"]
        predicted = {k: predict_kernel_seconds(k, backend=backend,
                                               **_op_dims(op, k))
                     for k in cands}
        measured = None
        source, reason = "predicted", note
        if len(cands) == 1:
            kern, source = cands[0], "only"
        elif kernels == "torch":
            kern, source = cands[0], "forced"
        elif kernels == "cuda":
            kern, source = cands[1], "forced"
        elif kernels == "measured":
            measured = measure_op(op, cands, cache, backend=backend)
            if measured:
                kern, source = min(measured, key=measured.get), "measured"
            else:
                kern = min(predicted, key=predicted.get)
            skipped = [k for k in cands if k not in (measured or {})]
            if skipped:
                reason = (f"{', '.join(skipped)} not measured: the CUDA "
                          f"kernels run only on the card (backend "
                          f"{backend!r})")
        else:                                   # auto
            kern = min(predicted, key=predicted.get)
        op.kernel = kern
        choices[op.name] = {
            "kernel": kern, "kind": op.kind,
            "primitive": op.primitive, "candidates": cands,
            "source": source,
            "predicted_s": {k: float(v) for k, v in predicted.items()},
            "measured_s": ({k: float(v) for k, v in measured.items()}
                           if measured else None),
            "reason": reason,
        }
    if cache is not None:
        cache.save()
        plan.meta["autotune"] = {
            "cache": str(cache.path),
            "measured_signatures": cache.measured_now,
            "cache_hits": cache.hits,
        }
    else:
        plan.meta.pop("autotune", None)
    plan.meta["kernel_choices"] = choices
    plan.meta["kernel_counts"] = plan.kernel_counts()
    plan.meta["kernels_mode"] = kernels
    plan.meta["kernels_backend"] = backend
    return plan


def kernel_report(plan: ExecutionPlan) -> str:
    """Human-readable view of ``plan.meta["kernel_choices"]`` — one line
    per op: chosen kernel, decision source, predicted/measured cost."""
    choices = plan.meta.get("kernel_choices")
    if not choices:
        return (f"plan {plan.name!r}: no kernel choices recorded "
                f"(compiled before kernel selection?)")
    lines = [f"kernel choices for {plan.name!r} "
             f"(mode={plan.meta.get('kernels_mode')}, "
             f"backend={plan.meta.get('kernels_backend')}):"]
    for name, c in choices.items():
        cost = (c["measured_s"] or c["predicted_s"]).get(c["kernel"])
        unit = "measured" if c["measured_s"] else "predicted"
        line = (f"  {name:<28} {c['kernel']:<18} [{c['source']}] "
                f"{unit} {cost * 1e6:8.2f} us")
        if c["source"] in ("fallback", "only", "measured") and c["reason"]:
            line += f"  ({c['reason']})"
        lines.append(line)
    counts = plan.meta.get("kernel_counts", {})
    lines.append("  totals: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)
