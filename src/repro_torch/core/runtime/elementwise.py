"""Elementwise handlers (the PSVM/PVVA family) + the shared fused epilogue.

Port of ``src/repro/core/runtime/elementwise.py``.  Covers activations,
residual add, broadcast mul, dense/masked/segment softmax and the two norm
flavours.  ``apply_epilogue`` is the one place bias + fused activation +
fused residual semantics live; the matmul and conv handlers call it so the
fusion pass's annotations mean the same thing for every producing op.

These ops have one torch realization (``torch_ew``); the handler never
branches on a kernel.  ``segment_sum`` / ``segment_max`` are the
counterparts of ``jax.ops.segment_*`` that the COO handlers share: the sum
is ``index_add_``, which runs with atomics on the card, so its order of
addition changes from run to run there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.runtime.registry import register_op
from repro_torch.core.runtime.residency import opt_weight, weight

# Default leaky_relu slope, used when a layer carries no explicit ``alpha``
# attr (the declarative builder's historical behaviour).
LEAKY_SLOPE = 0.2

# jax.nn.gelu defaults to the tanh approximation; the port keeps it.
ACTIVATIONS = {"relu": torch.relu,
               "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "silu": F.silu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
               "leaky_relu": lambda x: F.leaky_relu(x, LEAKY_SLOPE)}


def apply_act(fn: str, x, alpha=None):
    """One activation, honouring a per-layer leaky slope when present."""
    if fn == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE if alpha is None else alpha)
    return ACTIVATIONS[fn](x)


def apply_epilogue(out, op, env, params=None):
    """Fused bias / activation / residual tail shared by mm + conv, in the
    reference's order: bias -> act (unless ``post_res``) -> +residual ->
    act (if ``post_res``)."""
    b = opt_weight(op, "b", params)
    if b is not None:
        if out.ndim >= 3:                      # conv OFM (..., C, H, W)
            out = out + b[:, None, None]
        else:
            out = out + b
    act = op.attrs.get("fused_act")
    alpha = op.attrs.get("fused_act_alpha")
    post = op.attrs.get("act_pos") == "post_res"
    if act and not post:
        out = apply_act(act, out, alpha)
    res = op.attrs.get("fused_residual")
    if res:
        out = out + env[res]
    if act and post:
        out = apply_act(act, out, alpha)
    return out


def segment_sum(x, seg, n: int):
    """``out[s] = Σ x[e]`` over the ``e`` with ``seg[e] == s``; 0 if none."""
    return x.new_zeros((n, *x.shape[1:])).index_add_(0, seg.long(), x)


def segment_max(x, seg, n: int):
    """``out[s] = max x[e]`` over the ``e`` with ``seg[e] == s``; -inf if
    none.  NaN propagates, as in ``jax.ops.segment_max``."""
    idx = seg.long().reshape(-1, *(1,) * (x.ndim - 1)).expand_as(x)
    return x.new_full((n, *x.shape[1:]), float("-inf")).scatter_reduce_(
        0, idx, x, "amax", include_self=True)


@register_op("ew")
def run_ew(op, env, params=None):
    fn = op.attrs["fn"]
    x = env[op.inputs[0]]
    if fn == "add":
        return x + env[op.inputs[1]]
    if fn == "mul" and len(op.inputs) == 2:
        return x * env[op.inputs[1]]
    if fn == "softmax":
        axis = op.attrs.get("axis", -1)
        if op.attrs.get("masked"):
            mask = weight(op, "mask", params) != 0
            out = torch.softmax(torch.where(mask, x, float("-inf")), axis)
            return torch.where(mask, out, 0.0)
        return torch.softmax(x, axis)
    if fn == "segment_softmax":
        seg = weight(op, "segments", params).long()
        n = op.attrs["num_segments"]
        e = torch.exp(x - segment_max(x, seg, n)[seg])
        s = segment_sum(e, seg, n)[seg]
        return e / torch.where(s == 0, 1.0, s)
    if fn == "norm_batch":
        eps = op.attrs.get("eps", 1e-5)
        shape = (-1, 1, 1) if x.ndim == 3 else (1, -1)

        def bc(k, d):
            v = opt_weight(op, k, params)
            return v.reshape(shape) if v is not None else d

        mean, var = bc("mean", 0.0), bc("var", 1.0)
        scale, bias = bc("scale", 1.0), bc("bias", 0.0)
        inv = torch.rsqrt(torch.as_tensor(var + eps, dtype=x.dtype,
                                          device=x.device))
        return (x - mean) * scale * inv + bias
    if fn == "norm_layer":
        eps = op.attrs.get("eps", 1e-5)
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, correction=0)
        out = (x - mu) * torch.rsqrt(var + eps)
        scale = opt_weight(op, "scale", params)
        if scale is not None:
            out = out * scale
        bias = opt_weight(op, "bias", params)
        if bias is not None:
            out = out + bias
        return out
    return apply_act(fn, x, op.attrs.get("alpha"))
