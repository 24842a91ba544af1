"""Layout handlers: DM transposes, identity (fused DM), reshape, concat.

Port of ``src/repro/core/runtime/shape.py``.  DM layers that survived
fusion lower to ``transpose``/``identity`` ops whose only job is the
paper's layout shuffles between the CNN (C, H, W) and GNN (N, F) worlds;
``reshape``/``concat`` are the residual "Other Layers".  Pure layout
movement has one torch realization (``torch_ew``); the handlers never
branch on a kernel.  A transpose returns a view: the consumer's kernel
wrapper makes it contiguous where it needs to.  Each reads a sample's axes
from the end and so moves a whole batch at once: moving data computes
nothing, and each sample's slice of the result has the per-sample result's
strides.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.context import batch_ndim
from repro_torch.core.runtime.registry import register_batched, register_op


@register_batched("transpose", "identity")
@register_op("transpose", "identity")
def run_dm(op: MatOp, env, params=None):
    x = env[op.inputs[0]]
    mode = op.attrs["mode"]
    if mode == "channel_to_node":             # (..., C, H, W) -> (..., C, HW)
        return x.flatten(-2)
    if mode == "patch_to_node":               # (..., C, H, W) -> (..., HW, C)
        return x.flatten(-2).transpose(-1, -2)
    if mode == "node_to_channel":             # (..., N, F) -> (..., F, h, w)
        return x.transpose(-1, -2).reshape(*x.shape[:-2], *op.out_shape)
    raise ValueError(mode)


@register_batched("reshape")
@register_op("reshape")
def run_reshape(op: MatOp, env, params=None):
    x = env[op.inputs[0]]
    return x.reshape(*x.shape[:batch_ndim()], *op.attrs["shape"])


@register_batched("concat")
@register_op("concat")
def run_concat(op: MatOp, env, params=None):
    axis = op.attrs["axis"]
    return torch.cat([env[i] for i in op.inputs],
                     dim=axis if axis < 0 else axis + batch_ndim())
