"""Mixture-of-experts: top-k routing over expert MLPs.

Port of ``src/repro/models/moe.py``: ``init_moe``, ``_route``,
``aux_load_balance_loss``, ``moe_dense``, the expert-parallel
realizations ``moe_a2a``, ``moe_gathered`` and ``moe_gathered2d``, and
``moe_apply``'s Step-4 dispatch.  On one device ``moe_apply`` runs the
dense realization: every expert on every token, weighted by the (mostly
zero) gate matrix, the uniform DDMM mapping of the paper's Step 4.  Over a
mesh (``launch.mesh.make_process_mesh``) it picks as the reference does:
``a2a`` (the SpDMM mapping: each rank's tokens go to their experts' owner
with one all-to-all of fixed-capacity buffers and come back with a
second) when the sequence divides over the model axis, else the decode
paths, ``gathered2d`` (experts sharded on both axes, tokens replicated)
when d_model divides over the last dp axis and ``REPRO_MOE_1D`` is unset,
else ``gathered`` (each rank computes the pairs its experts own, summed
over the model axis); ``dense`` where the experts do not divide over the
model axis.  The expert-parallel paths run under the reference's
``shard_map`` layouts: each wrapper takes and returns this rank's block
of ``x`` in its in_spec, reads its expert block (``collectives
.materialize``) and the router and shared expert whole, and moves tokens
with ``torch.distributed`` over the mesh's sub-groups.  Capacity
positions and drops are the reference's: a ``(token, k)`` entry's place
is its rank among the entries bound for the same destination in
flattened order, capacities round up to a multiple of 8, the receiving
side cuts at its own second capacity, and whatever lies past a capacity
is dropped (``mode="drop"``); ``segment_sum`` adds in fp32.  No Pallas
kernel stands behind this module: the reference runs it as XLA einsums,
the port as PyTorch products.

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
import os

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as col
from repro_torch.models.layers import (dot, init_linear, init_mlp,
                                       mesh_axes_active, mlp_apply, normal,
                                       shard_axes, weight, wide, wsc)

# ``moe_dense``'s token blocks keep each (tokens, experts, d_ff_expert)
# intermediate near this many elements (256 MiB in fp32).
BLOCK_ELEMS = 1 << 26


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
    logits = wide(t) @ wide(weight(params["router"]))
    if mo.router == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, -1)
    topw, topi = top_k(probs, mo.top_k)
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    return topw, topi, probs


def aux_load_balance_loss(probs, topi, n_experts: int, *, axes=(),
                          mesh=None):
    """Switch-style load-balancing loss: ``E · Σ_e mean_t(probs) ·
    mean_t(tokens routed to e)``.  ``axes``: mesh axes to average the
    per-token statistics over *before* the product (the loss is bilinear
    in them, so a mean of per-shard losses would not be the global
    batch's); the mesh is ``mesh`` or the active context's."""
    me = probs.mean(0)
    ce = F.one_hot(topi, n_experts).to(probs.dtype).sum(1).mean(0)
    if axes:
        if mesh is None:
            ax = mesh_axes_active()
            if ax is None:
                raise ValueError("aux_load_balance_loss(axes=...) needs a "
                                 "mesh")
            mesh = ax.mesh
        n = math.prod(mesh.shape[a] for a in axes)
        me = col.psum(me, mesh, axes) / n
        ce = col.psum(ce, mesh, axes) / n
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


def _moe_dense_params(params):
    """The expert stacks read whole (``weight``: gathered under a mesh,
    the tensors themselves on one device)."""
    return {k: weight(params[k]) for k in ("wg", "wi", "wo")}


def moe_dense(params, x, cfg):
    """x ``(..., d)`` -> (out like x, aux).  The gate matrix holds each
    token's renormalised top-k weights at its experts and 0 elsewhere;
    ``silu(x wg) · (x wi)`` of every expert, times its gate, goes through
    ``wo`` summed over experts, plus the shared expert."""
    mo = cfg.moe
    t = x.reshape(-1, cfg.d_model)
    topw, topi, probs = _route(params, t, mo)
    gates = torch.zeros_like(probs).scatter(1, topi, topw)      # (T, E)
    experts = _moe_dense_params(params)
    grad = torch.is_grad_enabled() and (
        t.requires_grad or any(w.requires_grad for w in experts.values()))
    n = t.shape[0] if grad else token_block(cfg)
    out = torch.cat([_experts(experts, t[i:i + n], gates[i:i + n], x.dtype)
                     for i in range(0, t.shape[0], n)])
    if mo.n_shared:
        out = out + mlp_apply(params["shared"], t, cfg.mlp_act)
    ax = mesh_axes_active()
    # under a mesh the rows are this rank's share of the batch: the
    # statistics are the global batch's, as GSPMD computes the reference's
    aux = aux_load_balance_loss(probs, topi, mo.n_experts,
                                axes=ax.dp if ax else ())
    return out.reshape(x.shape), aux


# ------------------------------------------------------ expert parallel --
def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _positions(dest, n: int):
    """Each entry's rank among the entries with its ``dest`` (in
    ``[0, n)``; -1, an empty slot, is no destination and counts for none),
    in flattened order: the Switch position."""
    oh = F.one_hot(dest.clamp(min=0), n) * (dest >= 0)[:, None]
    return (oh.cumsum(0) - oh).gather(1, dest.clamp(min=0)[:, None])[:, 0]


def _into_slots(rows, slot, keep, n: int, fill=0):
    """``rows`` written at their ``slot`` of ``n`` (``rows``' other dims,
    ``fill`` elsewhere) where ``keep``, the others dropped: the boolean-mask
    write ``buf[slot[keep]] = rows[keep]`` with a fixed size, the dropped
    rows written to one extra slot past the end and cut off, so no shape
    depends on the data."""
    buf = rows.new_full((n + 1, *rows.shape[1:]), fill)
    buf[torch.where(keep, slot, n)] = rows
    return buf[:n]


def _expert_load(eid, n: int):
    """How many entries of ``eid`` pick each of ``n`` experts:
    ``torch.bincount(eid, minlength=n)`` at a fixed size, its result's
    shape not read from the data."""
    return torch.zeros(n, dtype=torch.long, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))


def _segment_sum(contrib, src, T: int):
    """``jax.ops.segment_sum`` of fp32 rows into ``T`` segments."""
    out = contrib.new_zeros((T, contrib.shape[1]))
    return out.index_add(0, src, contrib)


def _local_experts(params, mesh, model_axis, keep_d=None):
    """The expert stacks as this rank computes with them: its block of
    experts over ``model_axis`` (dim 0), whole on d_model, or also its
    block of d_model over ``keep_d`` (``moe_gathered2d``)."""
    out = {}
    for k, d_dim in (("wi", 1), ("wg", 1), ("wo", 2)):
        keep = {0: model_axis}
        if keep_d is not None:
            keep[d_dim] = keep_d
        out[k] = col.materialize(params[k], mesh, keep)
    out["router"] = col.materialize(params["router"], mesh)
    if "shared" in params:
        out["shared"] = {k: col.materialize(v, mesh)
                         for k, v in params["shared"].items()}
    return out


def _expert_mlp(w, xbuf, dtype):
    """Each local expert's MLP on its own rows: ``xbuf`` ``(e, c, d)`` ->
    ``(e, c, d)`` in ``dtype``, the products fp32 as the reference's
    ``preferred_element_type``."""
    h = F.silu(dot(xbuf, w["wg"])) * dot(xbuf, w["wi"])
    return dot(h.to(dtype), w["wo"]).to(dtype)


def _moe_a2a_local(w, x, cfg, mesh, axis, dp_axes, stats):
    """One rank's part of ``moe_a2a``: x ``(B_loc, S_loc, d)``, ``w`` the
    local expert block, the router and the shared expert whole."""
    mo = cfg.moe
    d = cfg.d_model
    M = mesh.shape[axis]
    e_loc = mo.n_experts // M
    t = x.reshape(-1, d)
    T = t.shape[0]
    topw, topi, probs = _route(w, t, mo)
    dev = t.device
    eid = topi.reshape(-1)                            # (T*k,)
    wt = topw.reshape(-1).float()
    src = torch.arange(T * mo.top_k, device=dev) // mo.top_k
    dest = eid // e_loc                               # owner rank
    pos = _positions(dest, M)
    cap = _ceil8(int(math.ceil(T * mo.top_k / M * mo.capacity_factor)))
    keep = pos < cap
    at = dest * cap + pos
    send_x = _into_slots(t[src], at, keep, M * cap).view(M, cap, d)
    send_e = _into_slots(eid % e_loc, at, keep, M * cap, -1).view(M, cap)
    recv_x = col.all_to_all(send_x, mesh, axis)
    with torch.no_grad():
        recv_e = col.all_to_all(send_e, mesh, axis)
    rt = recv_x.reshape(-1, d)                        # (M*cap, d)
    re = recv_e.reshape(-1)
    n_in = rt.shape[0]
    cap2 = _ceil8(int(math.ceil(n_in / max(e_loc, 1) * mo.capacity_factor)))
    pos2 = _positions(re, e_loc)
    valid2 = (re >= 0) & (pos2 < cap2)
    xbuf = _into_slots(rt, re * cap2 + pos2, valid2,
                       e_loc * cap2).view(e_loc, cap2, d)
    yb = _expert_mlp(w, xbuf, x.dtype)
    y = yb[re.clamp(min=0), pos2.clamp(max=cap2 - 1)] * valid2[:, None]
    recv_back = col.all_to_all(y.reshape(M, cap, d), mesh, axis)
    contrib = (recv_back[dest, pos.clamp(max=cap - 1)]
               * (keep * wt)[:, None])
    out = _segment_sum(contrib.float(), src, T).to(x.dtype)
    if mo.n_shared:
        out = out + mlp_apply(w["shared"], t, cfg.mlp_act)
    if stats is not None:
        with torch.no_grad():
            back = col.all_to_all(valid2.reshape(M, cap).to(torch.int32),
                                  mesh, axis)
            arrived = back[dest, pos.clamp(max=cap - 1)].bool()
        stats["dropped"] = ~(keep & arrived)
        stats["load"] = _expert_load(eid, mo.n_experts)
    aux = aux_load_balance_loss(probs, topi, mo.n_experts,
                                axes=tuple(dp_axes) + (axis,), mesh=mesh)
    return out.reshape(x.shape), aux


def moe_a2a(params, x, cfg, *, mesh, dp_axes=("data",), model_axis="model",
            stats=None):
    """Expert-parallel train/prefill MoE: ``x`` is this rank's block of
    the ``(B, S, d)`` activations in the reference's in_spec ``P(dp,
    model, None)`` (batch over ``dp_axes``, sequence over
    ``model_axis``); returns its block of the output and the aux loss
    (averaged over every rank's tokens).  ``stats``, a dict, gets
    ``"dropped"``: which of this rank's ``(token, k)`` entries a capacity
    dropped, and ``"load"``: how many of them each expert was picked
    for."""
    with shard_axes(mesh=None):
        w = _local_experts(params, mesh, model_axis)
        return _moe_a2a_local(w, x, cfg, mesh, model_axis, dp_axes, stats)


def _gathered_slots(w, t, mo, mesh, axis):
    """The decode paths' routing of tokens ``t`` (the same on every rank
    of ``axis``): this rank's ``(token, k)`` pairs in a capacity buffer.
    -> (top ids, probs, slot, keep, weights, src, xbuf, ebuf, the mask of
    this rank's pairs a capacity dropped)."""
    M = mesh.shape[axis]
    e_loc = mo.n_experts // M
    T = t.shape[0]
    topw, topi, probs = _route(w, t, mo)
    dev = t.device
    eid = topi.reshape(-1)
    wt = topw.reshape(-1).float()
    src = torch.arange(T * mo.top_k, device=dev) // mo.top_k
    is_local = (eid // e_loc) == mesh.axis_index(axis)
    cap = max(_ceil8(int(math.ceil(T * mo.top_k / M * mo.capacity_factor))),
              8)
    pos = torch.cumsum(is_local.long(), 0) - 1
    keep = is_local & (pos < cap)
    slot = torch.where(keep, pos, cap)
    xbuf = _into_slots(t[src], slot, keep, cap)
    ebuf = _into_slots(eid % e_loc, slot, keep, cap)
    return topi, probs, slot, keep, wt, src, xbuf, ebuf, is_local & ~keep


def _pair_dot(xs, ws):
    """Each slot's row against its own expert's matrix: ``(c, a)`` ×
    ``(c, a, b)`` -> ``(c, b)`` fp32 (``einsum("cd,cdf->cf")``)."""
    return dot(xs[:, None, :], ws)[:, 0]


def _moe_gathered_local(w, x, cfg, mesh, axis, fsdp, aux_axes, stats):
    """One rank's part of ``moe_gathered`` (``fsdp`` None: x ``(B_loc,
    S, d)``, the expert blocks whole on d_model) or of
    ``moe_gathered2d`` (x whole, the expert blocks' d_model sharded over
    ``fsdp``: each rank's d-slice of the products, summed over it)."""
    mo = cfg.moe
    t = x.reshape(-1, cfg.d_model)
    topi, probs, slot, keep, wt, src, xbuf, ebuf, dropped = \
        _gathered_slots(w, t, mo, mesh, axis)
    # each slot's expert: the reference's one-hot product picks the same
    # entries exactly
    xsl = xbuf if fsdp is None else col.take_block(xbuf, mesh, 1, fsdp)
    hg = _pair_dot(xsl, w["wg"][ebuf])
    hi = _pair_dot(xsl, w["wi"][ebuf])
    if fsdp is not None:
        hg, hi = col.psum(hg, mesh, fsdp), col.psum(hi, mesh, fsdp)
    y = _pair_dot((F.silu(hg) * hi).to(x.dtype), w["wo"][ebuf])
    if fsdp is not None:
        y = col.gather(y, mesh, 1, fsdp)               # (cap, d) fp32
    contrib = y[slot.clamp(max=y.shape[0] - 1)] * (keep * wt)[:, None]
    out = col.psum(_segment_sum(contrib, src, t.shape[0]), mesh,
                   axis).to(x.dtype)
    if mo.n_shared:
        out = out + mlp_apply(w["shared"], t, cfg.mlp_act)
    if stats is not None:
        stats["dropped"] = dropped
    aux = aux_load_balance_loss(probs, topi, mo.n_experts, axes=aux_axes,
                                mesh=mesh)
    return out.reshape(x.shape), aux


def moe_gathered(params, x, cfg, *, mesh, dp_axes=("data",),
                 model_axis="model", stats=None):
    """Decode-path EP: ``x`` is this rank's block in ``P(dp, None, None)``
    (the few tokens whole on the model axis); each rank computes the
    pairs its expert block owns and the outputs are summed over the model
    axis.  Returns its block of the output and the aux loss.  ``stats``
    as ``moe_a2a``'s (the pairs this rank owns)."""
    with shard_axes(mesh=None):
        w = _local_experts(params, mesh, model_axis)
        return _moe_gathered_local(w, x, cfg, mesh, model_axis, None,
                                   tuple(dp_axes), stats)


def moe_gathered2d(params, x, cfg, *, mesh, dp_axes=("data",),
                   model_axis="model", stats=None):
    """Decode-path EP with the expert weights sharded on both axes
    (experts over ``model_axis``, d_model over the last dp axis), never
    gathered: ``x`` ``(B, S, d)`` whole on every rank (in_spec ``P(None,
    None, None)``); each rank computes its d-slice of its experts' pairs,
    the partial products summed over the dp axis and the outputs over the
    model axis.  Returns the whole output and the aux loss."""
    fsdp = dp_axes[-1] if dp_axes else None
    with shard_axes(mesh=None):
        w = _local_experts(params, mesh, model_axis, keep_d=fsdp)
        return _moe_gathered_local(w, x, cfg, mesh, model_axis, fsdp, (),
                                   stats)


def moe_apply(params, x, cfg, *, mesh=None, dp_axes=("data",),
              model_axis="model", path="auto"):
    """Step-4 dispatch (module docstring): ``a2a``, ``gathered`` /
    ``gathered2d`` or ``dense``, as the reference picks them.  ``x`` is
    ``(B, S, d)``, under a mesh this rank's batch rows whole on the model
    axis (``lm_forward``'s layout); the output comes back in the same
    layout.  A mesh must be bound to ``torch.distributed``."""
    mo = cfg.moe
    if mesh is not None and getattr(mesh, "device_mesh", None) is None:
        raise TypeError("moe_apply(mesh=) takes a launch.mesh.Mesh bound to "
                        "torch.distributed (make_process_mesh)")
    ep_ok = mesh is not None and mo.n_experts % mesh.shape[model_axis] == 0
    if path == "auto":
        path = "dense"
        if mo.impl == "a2a" and ep_ok:
            path = ("a2a" if x.shape[1] % mesh.shape[model_axis] == 0
                    else "gathered")
    kw = dict(mesh=mesh, dp_axes=dp_axes, model_axis=model_axis)
    with shard_axes(dp_axes, model_axis, mesh):
        if path == "a2a" and ep_ok:
            out, aux = moe_a2a(params, wsc(x, None, "model", None), cfg, **kw)
            return col.gather(out, mesh, 1, model_axis), aux
        if path == "gathered" and ep_ok:
            fsdp = dp_axes[-1] if dp_axes else None
            if fsdp and cfg.d_model % mesh.shape[fsdp] == 0 \
                    and not os.environ.get("REPRO_MOE_1D"):
                out, aux = moe_gathered2d(
                    params, col.gather(x, mesh, 0, dp_axes), cfg, **kw)
                return wsc(out, "dp", None, None), aux
            return moe_gathered(params, x, cfg, **kw)
        return moe_dense(params, x, cfg)
