"""Mixture-of-experts: top-k routing over expert MLPs.

Port of ``src/repro/models/moe.py`` on one device: ``init_moe``,
``_route``, ``aux_load_balance_loss`` (``axes=()`` only), ``moe_dense``
and ``moe_apply`` (``mesh=None``).  As in the reference on one device,
``moe_apply`` runs the dense realization: every expert on every token,
weighted by the (mostly zero) gate matrix, the uniform DDMM mapping of the
paper's Step 4.  The expert-parallel realizations (``moe_a2a``,
``moe_gathered``, ``moe_gathered2d``) need a mesh; a mesh, or a ``path``
of ``"a2a"`` or ``"gathered"``, raises ``NotImplementedError`` (ROADMAP
queue 1 item 6).  No Pallas kernel stands behind this module: the
reference runs it as XLA einsums, the port as PyTorch products.

Differences from the reference:

* Top-k is a stable descending sort, so of two equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` leaves the order of ties unspecified).
* Where no grad is wanted (serving), ``moe_dense`` takes the tokens in
  blocks of ``token_block`` tokens, so its ``(tokens, experts,
  d_ff_expert)`` intermediates stay near ``BLOCK_ELEMS`` elements
  (deepseek-v3 at 2048 tokens would otherwise hold 4.3 GB in each, in
  fp32).  Each token's arithmetic is the same; the down projection
  contracts experts and ``d_ff_expert`` together in one product, as the
  reference's ``"tef,efd->td"`` does.  Where a grad is wanted it takes all
  tokens in one block: autograd keeps every block's intermediates for the
  backward whatever the blocking, and an expert weight's grad is then one
  fp32 product over all tokens rounded once to bf16, as the reference's
  (blocks would add bf16 grads in bf16).
* The up and down projections keep their fp32 products (``layers.dot``),
  as the reference's ``preferred_element_type`` does, so each token's
  forward and the VJP are the reference's arithmetic.
* Expert weights are drawn one expert at a time into the stacked leaf
  (``torch.Generator`` numbers: not the reference's bits), so no
  ``(experts, d, d_ff)`` fp32 draw is held at full width.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dot, init_linear, init_mlp,
                                       mlp_apply, normal, wide)

# ``moe_dense``'s token blocks keep each (tokens, experts, d_ff_expert)
# intermediate near this many elements (256 MiB in fp32).
BLOCK_ELEMS = 1 << 26

ITEM_6 = ("expert-parallel MoE (a mesh, or path \"a2a\" / \"gathered\") is "
          "not ported (ROADMAP queue 1 item 6); the port runs moe_dense on "
          "one device")


def init_moe(gen, cfg, dtype):
    """Router ``(d, E)``, experts ``wi``/``wg`` ``(E, d, ff)`` and ``wo``
    ``(E, ff, d)`` with std ``1/sqrt(fan_in)``, and the shared expert (an
    MLP of ``ff · n_shared``) where the config has one."""
    mo = cfg.moe
    d, ff = cfg.d_model, mo.d_ff_expert

    def experts(fin, fout):
        out = torch.empty((mo.n_experts, fin, fout), dtype=dtype,
                          device=gen.device)
        for e in range(mo.n_experts):
            out[e] = normal(gen, (fin, fout), dtype, 1.0 / math.sqrt(fin))
        return out

    p = {"router": init_linear(gen, d, mo.n_experts, dtype),
         "wi": experts(d, ff), "wg": experts(d, ff), "wo": experts(ff, d)}
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, ff * mo.n_shared, dtype, cfg.mlp_act)
    return p


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, ties lower index first.  -> (values, indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(params, t, mo):
    """t ``(T, d)`` -> (weights ``(T, k)``, ids ``(T, k)``, probs ``(T,
    E)``): the router in fp32 (``wide``), sigmoid or softmax, top-k, the
    weights renormalised to sum to 1."""
    logits = wide(t) @ wide(params["router"])
    if mo.router == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, -1)
    topw, topi = top_k(probs, mo.top_k)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    return topw, topi, probs


def aux_load_balance_loss(probs, topi, n_experts: int, *, axes=()):
    """Switch-style load-balancing loss: ``E · Σ_e mean_t(probs) ·
    mean_t(tokens routed to e)``.  ``axes`` (mesh axes to average over)
    raises: one device."""
    if axes:
        raise NotImplementedError(ITEM_6)
    me = probs.mean(0)
    ce = F.one_hot(topi, n_experts).to(probs.dtype).sum(1).mean(0)
    return n_experts * torch.sum(me * ce)


def token_block(cfg) -> int:
    """Tokens ``moe_dense`` takes at once where no grad is wanted."""
    mo = cfg.moe
    return max(1, BLOCK_ELEMS // (mo.n_experts * mo.d_ff_expert))


def _experts(params, tb, gates, dtype):
    """Every expert on the tokens ``tb`` ``(n, d)``, weighted by ``gates``
    ``(n, E)``: ``(n, d)`` in ``dtype``."""
    hg = dot(tb, params["wg"])                         # (E, n, ff) fp32
    hi = dot(tb, params["wi"])
    h = (F.silu(hg) * hi * gates.T[:, :, None]).to(dtype)
    E, n, ff = h.shape
    h = h.permute(1, 0, 2).reshape(n, E * ff)
    return dot(h, params["wo"].reshape(E * ff, -1)).to(dtype)


def moe_dense(params, x, cfg):
    """x ``(..., d)`` -> (out like x, aux).  The gate matrix holds each
    token's renormalised top-k weights at its experts and 0 elsewhere;
    ``silu(x wg) · (x wi)`` of every expert, times its gate, goes through
    ``wo`` summed over experts, plus the shared expert."""
    mo = cfg.moe
    t = x.reshape(-1, cfg.d_model)
    topw, topi, probs = _route(params, t, mo)
    gates = torch.zeros_like(probs).scatter(1, topi, topw)      # (T, E)
    grad = torch.is_grad_enabled() and (
        t.requires_grad or any(params[k].requires_grad
                               for k in ("wg", "wi", "wo")))
    n = t.shape[0] if grad else token_block(cfg)
    out = torch.cat([_experts(params, t[i:i + n], gates[i:i + n], x.dtype)
                     for i in range(0, t.shape[0], n)])
    if mo.n_shared:
        out = out + mlp_apply(params["shared"], t, cfg.mlp_act)
    aux = aux_load_balance_loss(probs, topi, mo.n_experts)
    return out.reshape(x.shape), aux


def moe_apply(params, x, cfg, *, mesh=None, dp_axes=("data",),
              model_axis="model", path="auto"):
    """The reference's Step-4 dispatch on one device: ``moe_dense``.  A
    mesh, or ``path`` ``"a2a"`` / ``"gathered"``, raises (item 6);
    ``dp_axes`` and ``model_axis`` name mesh axes and are unused."""
    if mesh is not None or path not in ("auto", "dense"):
        raise NotImplementedError(ITEM_6)
    return moe_dense(params, x, cfg)
