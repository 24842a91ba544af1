"""GPipe-style pipeline parallelism over one mesh axis.

Port of ``src/repro/distributed/pipeline.py``.  Layers are partitioned
into S stages over a mesh axis, one rank a stage; microbatches stream
through with the classic ``(n_micro + S - 1)``-tick schedule.  The only
inter-stage communication is a point-to-point shift of one microbatch's
activations per tick (``collectives.ppermute``: one batched isend/irecv
pair, whose backward sends the cotangent the other way), so the backward
streams in reverse under autograd, as the reference's does under
``jax.grad``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as col


def pipeline_apply(stage_fn, stage_params, xs, *, mesh, axis: str = "stage"):
    """Run ``stage_fn(params_i, x) -> x`` for stages i = 0..S-1 over
    microbatches ``xs`` ``(n_micro, mb, ...)`` (the same on every rank).

    ``stage_params``: a tree (nested dicts) whose leaves have a leading
    stage dim S: ``DTensor``s sharded over ``axis`` on it
    (``distributed.sharding.device_put`` with ``P(axis)``), each rank's
    block being its stage's, or plain tensors holding every stage, of
    which each rank reads its own row (that row alone gets a grad).
    Returns ys ``(n_micro, mb, ...)``, the last stage's outputs, the same
    on every rank; each rank's cotangent of it is taken once (every rank
    computing the same loss of ys gets the reference's grads).

    Every rank runs every tick, as the reference's ``fori_loop`` does:
    stage 0 feeds microbatch t (zeros past the last), the others what the
    stage before sent, and a stage's output at tick t is its slot ``t -
    (S - 1)``; the sum over the axis of the slots masked to the last
    stage's then gives every rank the last stage's ys.
    """
    S = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    n_micro = xs.shape[0]
    p = _stage(stage_params, mesh, axis, idx)
    first = torch.tensor(idx == 0, device=xs.device)
    recv = torch.zeros_like(xs[0])
    slots = []
    for t in range(n_micro + S - 1):
        x_in = xs[t] if t < n_micro else torch.zeros_like(xs[0])
        # selects, not branches: every rank's graph holds every shift, so
        # every rank runs every shift's backward, in the same order
        x = torch.where(first, x_in, recv)
        y = stage_fn(p, x)
        if t >= S - 1:
            slots.append(y)
        recv = col.ppermute(y, mesh, axis)
    mask = float(idx == S - 1)
    return col.replicated_sum(torch.stack(slots) * mask, mesh, axis)


def _stage(tree, mesh, axis, idx):
    """This rank's stage of the stacked parameters."""
    if isinstance(tree, dict):
        return {k: _stage(v, mesh, axis, idx) for k, v in tree.items()}
    if col.is_dtensor(tree):
        if col.spec_of(tree, mesh)[0] != axis:
            raise ValueError(f"stage parameters must be sharded over "
                             f"{axis!r} on their leading dim")
        return col.local(tree)[0]
    return tree[idx]
