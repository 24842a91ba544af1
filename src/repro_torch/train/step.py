"""Train step builder: loss + grad + optimizer, with optional gradient
accumulation over microbatches and per-layer rematerialization.

Port of ``src/repro/train/step.py``.  ``lax.scan`` over the microbatches
becomes a Python loop, ``jax.value_and_grad`` is ``torch.autograd.grad``
over the parameter leaves, and ``remat`` runs each layer under
``torch.utils.checkpoint`` (``models/transformer.lm_forward``).

Difference from the reference: the step updates the parameters in place,
under ``torch.no_grad()`` (``p.add_(u)``, in the parameter's dtype, as the
reference's ``(p + u).astype(p.dtype)``, by the optimizer's in-place
``update``, which also overwrites the moments), and returns the same tree;
it marks every parameter ``requires_grad``.  The reference is
functional.

With a mesh (``mesh=``, ``dp_axes``, ``model_axis``: the reference's
FSDP+TP step) every rank calls the step with the parameters and moments
placed on the mesh (``DTensor`` leaves) and the global batch; the loss is
``lm_loss(mesh=)``'s, the leaves differentiated are the ``DTensor``s'
local blocks (marked ``requires_grad`` for the step only), so each rank's
grads are its blocks' of the global loss, which AdamW takes with the
global grad norm.  Microbatches split the global batch, as the
reference's, each then over the dp axes.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as col
from repro_torch.models.transformer import check_mesh, lm_loss
from repro_torch.train.optim import tree_leaves, tree_unflatten


def unread_leaf(params, cfg, batch):
    """The leaf that ``lm_loss`` does not read on ``batch``: the embedding
    table when the batch carries ``"embeds"`` and the head is a leaf of its
    own; else None."""
    if "embeds" in batch and not cfg.tie_embeddings:
        return params["embed"]
    return None


def leaf_grads(loss, leaves, unread=None):
    """``torch.autograd.grad(loss, leaves)``, where the leaf ``unread`` is
    left out of the call and gets zeros, as ``jax.grad`` gives it.  Any
    other leaf that the loss does not reach raises."""
    got = iter(torch.autograd.grad(
        loss, [p for p in leaves if p is not unread]))
    return [torch.zeros_like(p) if p is unread else next(got)
            for p in leaves]


def build_train_step(cfg, optimizer, *, mesh=None, dp_axes=("data",),
                     model_axis="model", remat=False, microbatches: int = 1,
                     impl="chunked", aux_weight=1e-2):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``batch`` = ``{"tokens" or "embeds", "labels"}`` with a
    leading global-batch dim (``"embeds"``: ``(b, S, d_model)`` fed from
    outside, for ``embed_inputs=False`` archs, whose untied table then
    gets zero grads: ``leaf_grads``); with ``microbatches > 1``
    it is split on dim 0 and the grads are accumulated in fp32, then
    divided by the count.  ``metrics``:
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d tensors on the
    parameters' device; ``lr`` as the optimizer gives it).  ``mesh``: the
    sharded step (module docstring)."""
    check_mesh(cfg, mesh)

    def loss_and_grads(params, leaves, batch):
        loss, parts = lm_loss(params, cfg, batch, mesh=mesh, dp_axes=dp_axes,
                              model_axis=model_axis, impl=impl, remat=remat,
                              aux_weight=aux_weight)
        unread = unread_leaf(params, cfg, batch)
        grads = leaf_grads(loss, leaves,
                           None if unread is None else col.local(unread))
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                grads)

    def train_step(params, opt_state, batch):
        leaves = [col.local(p) for p in tree_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, parts, grads = loss_and_grads(params, leaves, batch)
        else:
            n = microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            lsum, parts_all = 0.0, []
            for i in range(n):
                mb = {key: a.reshape(n, a.shape[0] // n, *a.shape[1:])[i]
                      for key, a in batch.items()}
                loss_i, parts_i, grads_i = loss_and_grads(params, leaves, mb)
                for a, g in zip(acc, grads_i):
                    a.add_(g.float())
                lsum = lsum + loss_i
                parts_all.append(parts_i)
            grads = [a / n for a in acc]
            loss = lsum / n
            parts = {key: torch.stack([p[key] for p in parts_all]).mean()
                     for key in parts_all[0]}
        if mesh is not None:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            opt_state, om = optimizer.update(
                tree_unflatten(params, grads), opt_state, params)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step
