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
and an unmasked ``x @ xᵀ`` through the DDMM kernel or a plain matmul, as
the reference runs it.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import ELL_KERNELS, MatOp
from repro_torch.core.runtime.elementwise import (apply_epilogue,
                                                  segment_max, segment_sum)
from repro_torch.core.runtime.registry import op_kernel, register_op
from repro_torch.core.runtime.residency import ell_pair, weight
from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.sddmm import sddmm
from repro_torch.kernels.spdmm import spdmm


def _dense(kern: str, x2, y2):
    """One dense product through the chosen realization."""
    if kern == "cuda_ddmm":
        return ddmm(x2.contiguous(), y2.contiguous())
    return x2 @ y2


def _sparse(kern: str, idx, val, y):
    """One ELL product through the chosen realization."""
    if kern == "cuda_ell_spdmm":
        return spdmm(idx, val, y.contiguous())
    return ref.spdmm_ref(idx, val, y)


def _coo_aggregate(op: MatOp, env, x, params):
    """COO scatter message passing: rho({e_uv * h_u}) over static edges."""
    rows = weight(op, "coo_rows", params)
    cols = weight(op, "coo_cols", params).long()
    vals = (env[op.inputs[1]] if op.attrs.get("runtime_edge")
            else weight(op, "coo_vals", params))
    n = op.attrs["n"]
    msg = vals[:, None] * x[cols]
    if op.attrs.get("reduce", "sum") == "max":
        agg = segment_max(msg, rows, n)
        # Empty neighborhoods (segment_max's -inf identity) keep the node's
        # own feature; NaN messages propagate.
        return torch.where(torch.isneginf(agg), x, agg)
    return segment_sum(msg, rows, n)


@register_op("mm")
def run_mm(op: MatOp, env, params=None):
    kern = op_kernel(op)
    side = op.attrs["weight_side"]
    x = env[op.inputs[0]]
    if side == "right":
        x2 = x.reshape(-1, x.shape[-1])
        if kern in ELL_KERNELS:
            # w sparse: x @ w = (wᵀ @ x2ᵀ)ᵀ ; ELL stores wᵀ already
            idx, val = ell_pair(op, params)
            out = _sparse(kern, idx, val, x2.T).T
        else:
            out = _dense(kern, x2, weight(op, "w", params))
        out = out.reshape(op.out_shape if op.out_shape else (-1,))
    elif side == "left":
        if kern in ELL_KERNELS:
            idx, val = ell_pair(op, params)
            out = _sparse(kern, idx, val, x)
        else:
            out = _dense(kern, weight(op, "adj", params), x)
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
        out = _dense(kern, env[op.inputs[1]], x)
    elif side == "both_runtime":
        y = env[op.inputs[1]]
        y2 = y.reshape(y.shape[0], -1)
        x2 = x.reshape(-1, x.shape[-1])
        out = _dense(kern, x2, y2).reshape(op.out_shape)
    elif side == "right_t":                    # (C,T,V) x Aᵀ
        c, t, v = x.shape
        x2 = x.reshape(c * t, v)
        if kern in ELL_KERNELS:                # the ELL holds A itself
            idx, val = ell_pair(op, params)
            out = _sparse(kern, idx, val, x2.T).T
        else:
            out = _dense(kern, x2, weight(op, "adj", params).T)
        out = out.reshape(c, t, v)
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
        return ddmm(x.contiguous(), x.T.contiguous())
    return x @ x.T
