"""Matmul-family handlers: dense/sparse ``mm`` and sampled ``sddmm``.

Port of ``src/repro/core/runtime/matmul.py``.  ``mm`` sub-dispatches on
``weight_side`` — where the compile-time operand sits (right weight, left
adjacency, runtime adjacency, COO scatter, KNN gather, runtime x runtime,
and ST-GCN's (C,T,V) x Aᵀ) — and then on the op's Step-4b kernel:
ELL-family kernels run the SpDMM kernel or its plain twin, dense-family
kernels the DDMM kernel or a plain matmul, and the gather sides
(``left_coo``, ``left_knn``, bound to ``coo_scatter``) run torch indexing
and segment reductions.  ``sddmm`` (the VIP) runs per-edge COO scores in
plain torch, a masked product through the SDDMM kernel or its plain twin,
and an unmasked ``x @ xᵀ`` through the DDMM kernel (``xᵀ`` as a view) or a
plain matmul, as the reference runs it.

The DDMM kernel takes over an op's epilogue where its fused result is the
bits ``apply_epilogue`` gives: bias, relu (or none) and a residual added
after the activation, on a 1-D or 2-D output.  Every other epilogue runs in
``apply_epilogue`` after the product.  The ELL right sides (``right``,
``right_t``) run the product in their own ``(rows, S2)`` layout
(``spdmm_rows``): no transposing copy in or out.

Batched, the ``right`` and ``right_t`` sides on the kernels take the whole
batch (``_takes_batch``): they read a sample's axes from the end, stack the
samples along M and run one launch of the DDMM or SpDMM kernel.  DDMM's
launch plan reads K and N only and SpDMM's rows are independent, so each
sample comes out as its per-sample product gives it.  Every other side —
and every plain version, whose library may pick another algorithm at
another M — loops per sample: ``left`` (the samples would stack along N),
``left_runtime`` and ``both_runtime`` (an operand per sample), the
gathers, and ``sddmm`` (the VIP's ``x @ xᵀ`` has N = M).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.plan import ELL_KERNELS, MatOp
from repro_torch.core.runtime.context import batch_ndim
from repro_torch.core.runtime.elementwise import (apply_epilogue,
                                                  segment_max, segment_sum)
from repro_torch.core.runtime.registry import (op_kernel, register_batched,
                                               register_op)
from repro_torch.core.runtime.residency import (ell_pair, opt_weight,
                                                row_order, weight)
from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm, y_layout
from repro_torch.kernels.sddmm import sddmm
from repro_torch.kernels.spdmm import spdmm, spdmm_rows


def kernel_epilogue(op: MatOp, env, params, m: int, n: int, shape):
    """The op's epilogue as DDMM kernel arguments (bias, act, residual), or
    None where the kernel's result would not be ``apply_epilogue``'s bits:
    an activation other than relu, an activation after the residual, or a
    sample output of 3 or more dims (where the bias is per channel).
    ``shape`` is the ``(m, n)`` product's output, batch axes included."""
    act = op.attrs.get("fused_act")
    if act not in (None, "relu") or len(shape) - batch_ndim() >= 3 or (
            act and op.attrs.get("act_pos") == "post_res"):
        return None
    bias = opt_weight(op, "b", params)
    if bias is not None and tuple(bias.shape) != (n,):
        return None
    residual = None
    if op.attrs.get("fused_residual"):
        residual = env[op.attrs["fused_residual"]]
        if tuple(residual.shape) != tuple(shape):
            return None
        residual = residual.reshape(m, n).contiguous()
    return dict(bias=bias, act=act, residual=residual)


def _dense(op: MatOp, env, params, kern: str, x2, y2, shape=None):
    """``x2 @ y2`` through the chosen realization, reshaped to ``shape``
    (default: as it comes; a last axis of -1 takes what is left), with the
    op's epilogue: in the DDMM kernel where it can take it, else in
    ``apply_epilogue``."""
    m, n = x2.shape[0], y2.shape[1]
    shape = tuple(shape) if shape else (m, n)
    if shape[-1] == -1:
        shape = (*shape[:-1], m * n // math.prod(shape[:-1]))
    if kern != "cuda_ddmm":
        return apply_epilogue((x2 @ y2).reshape(shape), op, env, params)
    x2 = x2.contiguous()
    if y_layout(y2) is None:
        y2 = y2.contiguous()
    epi = kernel_epilogue(op, env, params, m, n, shape)
    if epi is not None:
        return ddmm(x2, y2, **epi).reshape(shape)
    return apply_epilogue(ddmm(x2, y2).reshape(shape), op, env, params)


def _sparse(kern: str, idx, val, y):
    """One ELL product ``(S1, L) @ (S2, N)`` through the chosen
    realization."""
    if kern == "cuda_ell_spdmm":
        return spdmm(idx, val, y.contiguous())
    return ref.spdmm_ref(idx, val, y)


def _sparse_rows(kern: str, idx, val, x2):
    """The same product in the rows layout: ``x2 (R, S2)`` -> ``(R, S1)``,
    ``out[r, i] = Σ_l val[i, l] · x2[r, idx[i, l]]``."""
    if kern == "cuda_ell_spdmm":
        return spdmm_rows(idx, val, x2.contiguous())
    return ref.spdmm_rows_ref(idx, val, x2)


def _coo_aggregate(op: MatOp, env, x, params):
    """COO scatter message passing: rho({e_uv * h_u}) over static edges.
    A sum forms its messages in the row order, for ``segment_sum``."""
    cols = weight(op, "coo_cols", params).long()
    vals = (env[op.inputs[1]] if op.attrs.get("runtime_edge")
            else weight(op, "coo_vals", params))
    n = op.attrs["n"]
    if op.attrs.get("reduce", "sum") == "max":
        agg = segment_max(vals[:, None] * x[cols],
                          weight(op, "coo_rows", params), n)
        # Empty neighborhoods (segment_max's -inf identity) keep the node's
        # own feature; NaN messages propagate.
        return torch.where(torch.isneginf(agg), x, agg)
    perm, lengths = row_order(op, "coo_rows", n, params)
    return segment_sum(vals[perm][:, None] * x[cols[perm]], lengths)


def _takes_batch(op: MatOp, env) -> bool:
    """Whether ``run_mm`` runs a batch in one launch (module docstring)."""
    return (op_kernel(op) in ("cuda_ddmm", "cuda_ell_spdmm")
            and op.attrs["weight_side"] in ("right", "right_t"))


@register_batched("mm", when=_takes_batch)
@register_op("mm")
def run_mm(op: MatOp, env, params=None):
    kern = op_kernel(op)
    side = op.attrs["weight_side"]
    x = env[op.inputs[0]]
    if side == "right":
        x2 = x.reshape(-1, x.shape[-1])
        shape = (*x.shape[:batch_ndim()], *(op.out_shape or (-1,)))
        if kern not in ELL_KERNELS:
            return _dense(op, env, params, kern, x2,
                          weight(op, "w", params), shape)
        # w sparse: x @ w = (wᵀ @ x2ᵀ)ᵀ ; ELL stores wᵀ already
        idx, val = ell_pair(op, params)
        out = _sparse_rows(kern, idx, val, x2).reshape(shape)
    elif side == "left":
        if kern not in ELL_KERNELS:
            return _dense(op, env, params, kern, weight(op, "adj", params), x)
        idx, val = ell_pair(op, params)
        out = _sparse(kern, idx, val, x)
    elif side == "left_coo":
        out = _coo_aggregate(op, env, x, params)
    elif side == "left_knn":
        # runtime (N, k) neighbor indices from a knn_graph op: unweighted
        # gather + reduce over each row's k neighbors
        msg = x[env[op.inputs[1]].long()]                # (N, k, F)
        red = op.attrs.get("reduce", "sum")
        if red == "max":
            out = msg.amax(1)
        elif red == "mean":
            out = msg.mean(1)
        else:
            out = msg.sum(1)
    elif side == "left_runtime":               # runtime (N, N) adjacency
        return _dense(op, env, params, kern, env[op.inputs[1]], x)
    elif side == "both_runtime":
        y = env[op.inputs[1]]
        return _dense(op, env, params, kern, x.reshape(-1, x.shape[-1]),
                      y.reshape(y.shape[0], -1), op.out_shape)
    elif side == "right_t":                    # (..., C, T, V) x Aᵀ
        x2 = x.reshape(-1, x.shape[-1])
        if kern not in ELL_KERNELS:
            return _dense(op, env, params, kern, x2,
                          weight(op, "adj", params).T, x.shape)
        idx, val = ell_pair(op, params)        # the ELL holds A itself
        out = _sparse_rows(kern, idx, val, x2).reshape(x.shape)
    else:
        raise ValueError(side)
    return apply_epilogue(out, op, env, params)


@register_op("sddmm")
def run_sddmm(op: MatOp, env, params=None):
    kern = op_kernel(op)
    x = env[op.inputs[0]]
    if kern == "coo_scatter":                  # per-edge inner products
        rows = weight(op, "coo_rows", params).long()
        cols = weight(op, "coo_cols", params).long()
        return (x[rows] * x[cols]).sum(-1)
    if "mask" in op.weights:
        mask = weight(op, "mask", params).float()
        if kern == "cuda_sddmm":
            x = x.contiguous()
            return sddmm(x, x.T, mask.contiguous())
        return ref.sddmm_ref(x, x.T, mask)
    if kern == "cuda_sddmm":                   # the reference's DDMM path
        x = x.contiguous()
        return ddmm(x, x.T)
    return x @ x.T
