"""Layout handlers: DM transposes, identity (fused DM), reshape, concat.

Port of ``src/repro/core/runtime/shape.py``.  DM layers that survived
fusion lower to ``transpose``/``identity`` ops whose only job is the
paper's layout shuffles between the CNN (C, H, W) and GNN (N, F) worlds;
``reshape``/``concat`` are the residual "Other Layers".  Pure layout
movement has one torch realization (``torch_ew``); the handlers never
branch on a kernel.  A transpose returns a view: the consumer's kernel
wrapper makes it contiguous where it needs to.
"""
from __future__ import annotations

import torch

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.registry import register_op


@register_op("transpose", "identity")
def run_dm(op: MatOp, env, params=None):
    x = env[op.inputs[0]]
    mode = op.attrs["mode"]
    if mode == "channel_to_node":
        return x.reshape(x.shape[0], -1)
    if mode == "patch_to_node":
        return x.reshape(x.shape[0], -1).T
    if mode == "node_to_channel":
        f, h, w = op.out_shape
        return x.T.reshape(f, h, w)
    raise ValueError(mode)


@register_op("reshape")
def run_reshape(op: MatOp, env, params=None):
    return env[op.inputs[0]].reshape(op.attrs["shape"])


@register_op("concat")
def run_concat(op: MatOp, env, params=None):
    return torch.cat([env[i] for i in op.inputs], dim=op.attrs["axis"])
