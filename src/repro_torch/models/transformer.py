"""Decoder-only LM assembled from a block pattern.

Port of ``src/repro/models/transformer.py`` (``_embed``, ``build_stages``,
``init_lm``, ``_attn_block`` with the ``mlp`` variant, ``_rec_block``,
``lm_forward``, ``lm_loss``, ``init_caches``, ``lm_decode_step``,
``_decode_stage``,
``lm_prefill``; the reference's ``_forward_shared``, ``_decode_shared``
and ``_prefill_shared`` walk one schedule, ``_super_steps`` here).  Block
kinds: attention (GQA or MLA) with an MLP or a mixture of experts (the
``moe`` variant, ``models/moe.py``: a stage's blocks from
``moe.first_dense_layers`` on), and the recurrent ``mamba2``, ``mlstm``
and ``slstm`` blocks (``models/ssm.py``); zamba2's shared GQA + MLP blocks
(``shared_attn_every``: shared block ``idx % n_shared_blocks`` runs after
every ``shared_attn_every`` backbone blocks, super-step ``idx``).
Parameters and caches keep the reference's tree: each stage's layers are
stacked on a leading axis; ``lax.scan`` over a stage becomes a Python loop
over its layers.  MLA caches hold the latent ``ckv`` and the rope key
``kr`` per position, GQA's K and V.  ``lm_forward``, ``lm_prefill`` and
``lm_loss`` take token ids or embeddings fed from outside (``embeds``
``(b, S, d_model)``, cast to the embedding table's dtype: the frontend
stubs of chameleon's image patches and musicgen's audio frames,
``embed_inputs=False``); sinusoidal positions (musicgen) are added to the
input rows in fp32 and rounded once, in a prefill at ``0..S-1`` and in a
decode step at each row's own length.  The MoE blocks' load-balancing
losses sum into ``lm_forward``'s aux.

``impl`` picks the attention core (``chunked``: the flash kernel;
``naive``, ``chunked_scan`` or ``tri``: plain PyTorch,
``models/attention.py``), ``rec_impl`` the recurrences' form in a
forward or a prefill (``chunked`` or ``seq``); a decode step runs them as
``seq``, one token, as the reference does.  Recurrent states are fp32
caches (the conv tails in the model dtype).

``remat=True`` runs each layer under ``torch.utils.checkpoint`` (the
reference wraps each scanned block in ``jax.checkpoint``).

``mesh=`` (a ``launch.mesh.Mesh`` bound to ``torch.distributed``, one
process per entry; ``dp_axes`` and ``model_axis`` name its axes, as in
the reference) runs ``lm_forward``, ``lm_loss``, ``lm_decode_step``
and ``lm_prefill`` sharded, for every block kind: every rank passes the
global batch and the parameters placed by the rule table
(``distributed.sharding.device_put``; a plain tensor is read as
replicated), and runs under ``layers.shard_axes``: its batch rows (the dp
block, ``wsc``; a batch that does not divide over the dp axes is held
whole on every dp rank, as the reference's ``wsc`` leaves it, and the
call runs as if the mesh had no dp axes: ``_batch_axes``), each weight
gathered on its fsdp dims when read, attention and the MLP
tensor-parallel over the model axis (this rank's heads and hidden units,
the output projections' partial sums added over the model axis; heads
whole where the model axis is wider than the head count), the MoE blocks
by ``moe_apply``'s expert-parallel dispatch, the recurrent blocks on this
rank's heads where they divide (``models/ssm.py``), zamba2's shared
blocks as attention blocks, each super-step's block a view of the placed
stack.  Activations between blocks hold the rank's rows whole on the
model axis.  Outputs and decode caches are the rank's rows
(``init_caches(mesh=)``: its rows; of the attention caches every kv head
and its block of the sequence, the reference's ``cache_specs`` layout;
its recurrent heads' states).  ``lm_loss`` is the global batch's mean
over every label ``!= -1`` (each rank's sum over the global count, not a
mean of per-rank means; rows held whole on the dp ranks count once) and
its backward gives each rank its shards' grads of that global loss
(``distributed.collectives``).

Differences from the reference: ``impl`` is an argument only (no
``REPRO_ATTN_IMPL`` override); ``lm_forward`` takes no ``positions`` (they
are ``0..S-1``, the reference's default); ``lm_prefill`` projects q, k
and v once and feeds both the attention and the cache from that
projection (the reference projects twice, to the same values) and
defaults to ``chunked``, the flash kernel (the reference's default is
``tri``, its plain prefill schedule); decode
and prefill write the caches in place (K/V rows and recurrent states
alike) and decode returns the same dict.  ``init_lm`` draws each layer in
turn and writes it into stacked leaves allocated once (``_init_stage``),
so a stage never exists twice in memory.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives as col
from repro_torch.models import ssm
from repro_torch.distributed.sharding import seq_block
from repro_torch.models.attention import (_mla_qkr, _pos_vec,
                                          cache_block_rows, gqa_attend,
                                          gqa_decode, gqa_project, init_gqa,
                                          init_mla, mla_attend, mla_decode)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy_sum, dot, dtype_of,
                                       init_linear, init_mlp,
                                       mesh_axes_active, mlp_apply, normal,
                                       rms_norm, shard_axes, sinusoidal_pos,
                                       unbind_params, weight, wide, wsc)
from repro_torch.models.moe import init_moe, moe_apply

REC_KINDS = ("mamba2", "mlstm", "slstm")
_INIT_REC = {"mamba2": ssm.init_mamba2, "mlstm": ssm.init_mlstm,
             "slstm": ssm.init_slstm}
_REC_STATE = {"mamba2": ssm.mamba2_init_state,
              "mlstm": ssm.mlstm_init_state,
              "slstm": ssm.slstm_init_state}


def _embed(params, cfg, tokens, embeds, positions):
    """The input rows: the embedding table's rows of ``tokens``, or
    ``embeds`` cast to its dtype; sinusoidal positions added in fp32
    (``wide``) and rounded once to that dtype."""
    x = weight(params["embed"])[tokens] if embeds is None \
        else embeds.to(params["embed"].dtype)
    if cfg.pos_emb == "sinusoidal":
        xf = wide(x)
        x = (xf + sinusoidal_pos(positions, cfg.d_model, xf.dtype)).to(
            x.dtype)
    return x


def _inputs(tokens, embeds):
    """``(b, S, device)`` of whichever input is given; exactly one must
    be."""
    if (tokens is None) == (embeds is None):
        raise ValueError("give tokens or embeds, not both or neither")
    t = tokens if embeds is None else embeds
    return t.shape[0], t.shape[1], t.device


# ==================================================================== plan ==
def build_stages(cfg: ModelConfig):
    """Group the block pattern into maximal same-(kind, variant) runs:
    a list of ``(kind, variant, layer_indices)``; variant is ``"mlp"`` or
    ``"moe"`` for attn blocks, ``""`` otherwise."""
    out: list[tuple[str, str, list[int]]] = []
    attn_seen = 0
    for i, kind in enumerate(cfg.pattern):
        variant = ""
        if kind == "attn":
            if cfg.moe is not None and attn_seen >= cfg.moe.first_dense_layers:
                variant = "moe"
            else:
                variant = "mlp"
            attn_seen += 1
        if out and out[-1][0] == kind and out[-1][1] == variant:
            out[-1][2].append(i)
        else:
            out.append((kind, variant, [i]))
    return out


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every stage is an attention block (GQA or MLA) with an
    MLP or a mixture of experts, or a recurrent block (mamba2, mlstm,
    slstm), with or without shared blocks: the reference's block
    kinds."""
    what = []
    if cfg.attn_type not in ("gqa", "mla"):
        what.append(f"attn_type={cfg.attn_type}")
    for kind, _, _ in build_stages(cfg):
        if kind != "attn" and kind not in REC_KINDS:
            what.append(kind)
    if what:
        raise ValueError(
            f"{cfg.name}: {', '.join(sorted(set(what)))} is not a block "
            f"of the reference; the port runs GQA and MLA attention with "
            f"an MLP or MoE, mamba2, mlstm and slstm blocks, and shared "
            f"blocks")


def _dense_ff(cfg):
    if cfg.moe is not None and cfg.moe.d_ff_dense:
        return cfg.moe.d_ff_dense
    return cfg.d_ff


# ==================================================================== init ==
def _init_attn(gen, cfg, dtype, d_ff, *, variant="mlp", mla=False):
    dev = gen.device
    p = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
         "attn": (init_mla if mla else init_gqa)(gen, cfg, dtype),
         "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if variant == "moe":
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, d_ff, dtype, cfg.mlp_act)
    return p


def _init_block(gen, cfg, kind, variant, dtype):
    if kind == "attn":
        return _init_attn(gen, cfg, dtype, _dense_ff(cfg), variant=variant,
                          mla=cfg.attn_type == "mla")
    return {"norm": torch.ones((cfg.d_model,), dtype=dtype,
                               device=gen.device),
            "body": _INIT_REC[kind](gen, cfg, dtype)}


def _init_stage(n: int, make) -> dict:
    """``n`` layers ``make()`` draws in turn, stacked on a new axis 0: the
    stacked leaves are allocated at the first layer and each layer is
    copied in and freed, so the peak is the stage plus one layer (the
    reference's ``stack_params`` of a list would hold the stage twice:
    45 GB for deepseek-v3's two MoE layers); a one-layer stage is that
    layer's leaves as views, with no copy."""
    def view(t):
        if isinstance(t, dict):
            return {k: view(v) for k, v in t.items()}
        return t[None]

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    layer = make()
    if n == 1:
        return view(layer)
    out = alloc(layer)
    for i in range(n):
        if i:
            layer = make()
        put(out, layer, i)
        del layer
    return out


def init_lm(seed: int, cfg: ModelConfig, dtype=None, *, device="cuda"):
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``),
    in the reference's tree, scales and leaf dtypes: std ``1/sqrt(fan_in)``
    for linears, 0.02 for the embedding, ones for norms; the recurrent
    blocks' gate and decay leaves stay fp32 (``models/ssm.py``)."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"embed": normal(gen, (cfg.vocab, cfg.d_model), dtype, 0.02),
              "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=device)}
    if not cfg.tie_embeddings:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab, dtype)
    for si, (kind, variant, idxs) in enumerate(build_stages(cfg)):
        params[f"stage_{si}"] = _init_stage(
            len(idxs), lambda: _init_block(gen, cfg, kind, variant, dtype))
    if cfg.shared_attn_every:
        params["shared"] = _init_stage(
            cfg.n_shared_blocks, lambda: _init_attn(gen, cfg, dtype,
                                                    cfg.d_ff))
    return params


# ================================================================= forward ==
def _ffn(p, h, cfg):
    """A block's second half on its normed input: ``(out, aux)``, the
    mixture of experts where the block has one (aux its load-balancing
    loss), else the MLP (aux 0.0)."""
    if "moe" in p:
        ax = mesh_axes_active()
        if ax is None:
            return moe_apply(p["moe"], h, cfg)
        return moe_apply(p["moe"], h, cfg, mesh=ax.mesh, dp_axes=ax.dp,
                         model_axis=ax.model)
    return mlp_apply(p["mlp"], h, cfg.mlp_act), 0.0


def _attn_block(p, x, positions, cfg, *, impl, offset=0):
    """One attention block (MLA where the config says, else GQA, which
    zamba2's shared blocks always are); returns ``(x, aux, cache rows)``:
    ``{"k", "v"}`` ``(b, S, Hkv, hd)``, or MLA's ``{"ckv"}`` ``(b, S,
    kv_lora)`` and ``{"kr"}`` ``(b, S, rope)``."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if "wdq" in p["attn"]:
        qn, qr, ckv, kr = _mla_qkr(p["attn"], h, positions, cfg)
        x = x + mla_attend(p["attn"], h, qn, qr, ckv, kr, cfg, impl=impl,
                           offset=offset)
        rows = {"ckv": ckv, "kr": kr[:, :, 0]}
    else:
        q, k, v = gqa_project(p["attn"], h, positions, cfg)
        x = x + gqa_attend(p["attn"], h, q, k, v, impl=impl, offset=offset)
        rows = {"k": k, "v": v}
    out, aux = _ffn(p, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
    return x + out, aux, rows


def _rec_block(p, x, cfg, kind, *, impl, state=None):
    """One recurrent block; returns ``(x, new_state)``."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if kind == "mamba2":
        out, st = ssm.mamba2_forward(p["body"], h, cfg, state=state,
                                     impl=impl)
    elif kind == "mlstm":
        out, st = ssm.mlstm_block(p["body"], h, cfg, state=state, impl=impl)
    else:
        out, st = ssm.slstm_block(p["body"], h, cfg, state=state)
    return x + out, st


def _layers(params, cfg):
    """``(stage key, kind, layer index within the stage, layer params)``
    for every layer of the stages, in order."""
    for si, (kind, _, _) in enumerate(build_stages(cfg)):
        for li, p in enumerate(unbind_params(params[f"stage_{si}"])):
            yield f"stage_{si}", kind, li, p


def _super_steps(params, cfg):
    """zamba2's schedule: for each super-step ``idx``, ``(idx, kind, its
    backbone layers as (index in stage_0, params), the shared block that
    serves it)``.  The backbone must be one stage of whole super-steps."""
    stages = build_stages(cfg)
    every = cfg.shared_attn_every
    if len(stages) != 1 or len(stages[0][2]) % every:
        raise ValueError(f"{cfg.name}: shared blocks need one homogeneous "
                         f"backbone stage of a multiple of {every} layers")
    kind = stages[0][0]
    layers = unbind_params(params["stage_0"])
    shared = unbind_params(params["shared"])
    for idx in range(len(layers) // every):
        span = range(idx * every, (idx + 1) * every)
        yield (idx, kind, [(li, layers[li]) for li in span],
               shared[idx % cfg.n_shared_blocks])


def _head(params, cfg):
    return (weight(params["embed"]).T if cfg.tie_embeddings
            else weight(params["head"]))


def _block_out(p, x, positions, cfg, kind, impl, rec_impl):
    """One layer of a forward: ``(x, aux)``."""
    if kind == "attn":
        return _attn_block(p, x, positions, cfg, impl=impl)[:2]
    return _rec_block(p, x, cfg, kind, impl=rec_impl)[0], 0.0


def lm_forward(params, cfg: ModelConfig, tokens=None, embeds=None, *,
               impl="chunked", rec_impl="chunked", mesh=None,
               dp_axes=("data",), model_axis="model", remat=False):
    """Full-sequence forward over tokens ``(b, S)`` or embeddings ``(b, S,
    d_model)``.  Returns ``(logits (b, S, V) fp32, aux)``; aux is the MoE
    blocks' load-balancing losses summed over the layers (fp32), 0.0 for a
    model without experts.  ``remat``: each layer (and each shared block)
    runs under ``torch.utils.checkpoint`` (its activations recomputed in
    the backward, its input saved).  ``mesh``: sharded (module
    docstring); the logits are this rank's batch rows."""
    check_mesh(cfg, mesh)
    if mesh is not None:
        params = col.sharded_tree(params, mesh)
        dp_axes = _batch_axes(_inputs(tokens, embeds)[0], dp_axes, mesh)
    with shard_axes(dp_axes, model_axis, mesh):
        return _forward(params, cfg, tokens, embeds, impl, rec_impl, remat)


def _batch_axes(b: int, dp_axes, mesh) -> tuple:
    """The dp axes a global batch of ``b`` rows is cut over: ``dp_axes``,
    or none where ``b`` does not divide over them; the rows are then held
    whole on every dp rank, as the reference's ``wsc`` leaves a dim that
    does not divide, and the call runs as if the mesh had no dp axes."""
    dp_axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
    n = math.prod(mesh.shape[a] for a in dp_axes)
    return dp_axes if b % n == 0 else ()


def _rows(t):
    """The global batch ``t``'s rows of this rank's dp block (``wsc``)."""
    if t is None or not torch.is_tensor(t) or not t.ndim:
        return t
    return wsc(t, "dp", *([None] * (t.ndim - 1)))


def _forward(params, cfg, tokens, embeds, impl, rec_impl, remat):
    """``lm_forward``'s body, under the caller's sharding context."""
    ax = mesh_axes_active()
    tokens, embeds = _rows(tokens), _rows(embeds)
    b, S, dev = _inputs(tokens, embeds)
    positions = torch.arange(S, device=dev)[None].expand(b, S)
    x = _embed(params, cfg, tokens, embeds, positions)
    aux = 0.0

    def block(*args):
        # a checkpointed layer's recomputation runs in the backward,
        # outside the caller's context: it enters its own
        with shard_axes(*((ax.dp, ax.model, ax.mesh) if ax else ())):
            return _block_out(*args)

    def run(p, x, kind):
        if remat:
            return checkpoint(block, p, x, positions, cfg, kind, impl,
                              rec_impl, use_reentrant=False)
        return _block_out(p, x, positions, cfg, kind, impl, rec_impl)

    if cfg.shared_attn_every:
        for _, kind, layers, shared in _super_steps(params, cfg):
            for _, p in layers:
                x, a = run(p, x, kind)
                aux = aux + a
            x, a = run(shared, x, "attn")
            aux = aux + a
    else:
        for _, kind, _, p in _layers(params, cfg):
            x, a = run(p, x, kind)
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, _head(params, cfg)), aux


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise unless ``cfg``'s blocks are the reference's and ``mesh`` is
    None or a mesh bound to ``torch.distributed``."""
    check_supported(cfg)
    if mesh is not None and getattr(mesh, "device_mesh", None) is None:
        raise TypeError("mesh= takes a launch.mesh.Mesh bound to "
                        "torch.distributed (launch.mesh.make_process_mesh, "
                        "one process per entry)")


# ==================================================================== loss ==
def lm_loss(params, cfg: ModelConfig, batch, *, mesh=None,
            dp_axes=("data",), model_axis="model", impl="chunked",
            rec_impl="chunked", remat=False, aux_weight=1e-2):
    """Next-token loss of ``batch = {"tokens" or "embeds", "labels"}``
    (labels ``-1`` ignored): ``(loss, {"ce", "aux"})`` with ``loss = ce +
    aux_weight · aux``.  Under a mesh (module docstring) ``batch`` is the
    global batch on every rank, ``ce`` the global mean and the loss the
    same value on every rank, whose backward on every rank gives each its
    shards' grads of it."""
    if mesh is not None:
        check_mesh(cfg, mesh)
        dp_axes = _batch_axes(batch["labels"].shape[0], dp_axes, mesh)
    logits, aux = lm_forward(params, cfg, batch.get("tokens"),
                             batch.get("embeds"), impl=impl,
                             rec_impl=rec_impl, mesh=mesh, dp_axes=dp_axes,
                             model_axis=model_axis, remat=remat)
    with shard_axes(dp_axes, model_axis, mesh) as ax:
        labels = _rows(batch["labels"])
    total, count = cross_entropy_sum(logits, labels)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=total.device)
    if mesh is None:
        ce = total / count.clamp(min=1.0)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    with torch.no_grad():
        count = col.psum(count, mesh, ax.dp).clamp(min=1.0)
    # each rank's share: its rows' sum over the global count, divided
    # among the ranks that hold the same rows (the model ranks, and every
    # dp rank where the rows are whole: the autograd convention of
    # distributed.collectives)
    ce = col.replicated_sum(total / count / (mesh.size // ax.dp_size), mesh,
                            mesh.axis_names)
    return (ce + aux_weight * col.scale_grad(aux, 1.0 / mesh.size),
            {"ce": ce, "aux": aux})


# ================================================================== caches ==
def _kv_cache(n, cfg, batch, max_len, dtype, device, *, mla=False):
    if mla:
        m = cfg.mla
        return {name: torch.zeros((n, batch, max_len, width), dtype=dtype,
                                  device=device)
                for name, width in (("ckv", m.kv_lora_rank),
                                    ("kr", m.rope_head_dim))}
    hd = cfg.resolved_head_dim
    return {name: torch.zeros((n, batch, max_len, cfg.n_kv_heads, hd),
                              dtype=dtype, device=device)
            for name in ("k", "v")}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                device="cuda", mesh=None, dp_axes=("data",),
                model_axis="model"):
    """Per-layer decode caches, stacked per stage, zeros (the recurrent
    states at their initial values): ``{"stage_i": {"k", "v": (L, batch,
    max_len, Hkv, hd)}}`` for GQA attention, ``{"ckv": (L, batch,
    max_len, kv_lora), "kr": (L, batch, max_len, rope)}`` for MLA, the
    block's state leaves with a
    leading ``L`` for a recurrent stage (fp32 states, ``ssm.acc``; conv
    tails in ``dtype``), and ``"shared": {"k", "v"}`` with one slab per
    shared-block application (``n_layers // shared_attn_every``).

    Under a mesh, the reference's ``cache_specs`` layout: this rank's rows
    of a global ``batch`` (all of them where ``batch`` does not divide over
    the dp axes), and of the attention leaves (GQA's and the shared
    blocks' ``k`` and ``v``, MLA's ``ckv`` and ``kr``) every kv head and
    this rank's block of the sequence (``sharding.seq_block``:
    ``max_len`` over ``model``, over dp + model where the batch does not
    divide over dp, whole where ``max_len`` does not divide).  The
    recurrent states keep the port's layout by heads (``models/ssm.py``),
    which is the spec's where the heads divide over ``model``; leaf by
    leaf, the rest: Mamba2's ``ssm`` is whole where a split of its heads
    would cut a B/C group (the spec cuts the heads all the same), and its
    ``conv`` tail holds this rank's heads' ``x`` channels and their
    groups' B/C channels (the spec cuts the concatenated channels into
    equal blocks); mLSTM's ``conv`` tail and sLSTM's ``c``, ``n``, ``m``
    and ``h`` are whole (the spec cuts them over ``model``).  At
    ``decode_32k`` over (16, 16) these leaves hold 0.03% (zamba2-2.7b) and
    0.3% (xlstm-350m) more bytes than the spec's."""
    check_mesh(cfg, mesh)
    if mesh is None:
        return _init_caches(cfg, batch, max_len, dtype, device)
    block = seq_block(mesh, batch, max_len, dp=dp_axes, model=model_axis)
    dp_axes = _batch_axes(batch, dp_axes, mesh)
    with shard_axes(dp_axes, model_axis, mesh) as ax:
        return _init_caches(cfg, batch // ax.dp_size, max_len, dtype,
                            device, block)


def _init_caches(cfg, batch, max_len, dtype, device, block=None):
    """``init_caches`` of ``batch`` rows (the attention leaves ``block``'s
    positions, else ``max_len``), under the caller's sharding context."""
    if block is not None:
        max_len = block.hi - block.lo
    dtype = dtype or dtype_of(cfg.dtype)
    caches = {}
    stages = build_stages(cfg)
    for si, (kind, _, idxs) in enumerate(stages):
        L = len(idxs)
        if kind == "attn":
            caches[f"stage_{si}"] = _kv_cache(
                L, cfg, batch, max_len, dtype, device,
                mla=cfg.attn_type == "mla")
            continue
        state = _REC_STATE[kind](cfg, batch, dtype, device=device)
        caches[f"stage_{si}"] = {
            name: t[None].expand(L, *t.shape).contiguous()
            for name, t in state.items()}
    if cfg.shared_attn_every:
        n_apps = len(stages[0][2]) // cfg.shared_attn_every
        caches["shared"] = _kv_cache(n_apps, cfg, batch, max_len, dtype,
                                     device)
    return caches


def _store(stage_cache, li, state) -> None:
    """Write a recurrent block's state into layer ``li``'s cache rows."""
    for name, t in state.items():
        stage_cache[name][li].copy_(t)


def lm_decode_step(params, cfg: ModelConfig, tokens, caches, length, *,
                   mesh=None, dp_axes=("data",), model_axis="model",
                   max_len: int | None = None):
    """One decode step.  tokens ``(b,)``; length int or ``(b,)`` (current
    context size, each row's position).  Writes the caches in place;
    returns ``(logits (b, V), caches)``.  Under a mesh, ``tokens`` and a
    ``(b,)`` length are the global batch's, the caches and logits this
    rank's rows (``init_caches(mesh=)``, whose ``max_len`` a model with
    attention must pass: a rank's caches hold its block of the sequence,
    ``sharding.seq_block``); the attention blocks run the split softmax
    over the sequence blocks (``models/attention.py``), the MoE blocks
    ``moe_apply``'s decode paths."""
    check_mesh(cfg, mesh)
    if mesh is None:
        return _decode(params, cfg, tokens, caches, length)
    block = None
    if "attn" in cfg.pattern or cfg.shared_attn_every:
        if max_len is None:
            raise ValueError("lm_decode_step(mesh=) needs max_len=, the "
                             "caches' init_caches(max_len): each rank "
                             "holds its block of their sequence")
        block = seq_block(mesh, tokens.shape[0], max_len, dp=dp_axes,
                          model=model_axis)
    params = col.sharded_tree(params, mesh)
    dp_axes = _batch_axes(tokens.shape[0], dp_axes, mesh)
    with shard_axes(dp_axes, model_axis, mesh):
        return _decode(params, cfg, _rows(tokens), caches, _rows(length),
                       block)


def _decode(params, cfg, tokens, caches, length, block=None):
    positions = _pos_vec(length, tokens.shape[0], tokens.device)
    x = _embed(params, cfg, tokens[:, None], None, positions)   # (b, 1, d)
    if cfg.shared_attn_every:
        for idx, kind, layers, shared in _super_steps(params, cfg):
            for li, p in layers:
                x = _decode_stage(p, caches["stage_0"], li, x, length, cfg,
                                  kind, block)
            x = _decode_stage(shared, caches["shared"], idx, x, length, cfg,
                              "attn", block)
    else:
        for key, kind, li, p in _layers(params, cfg):
            x = _decode_stage(p, caches[key], li, x, length, cfg, kind,
                              block)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, _head(params, cfg))[:, 0], caches


def _decode_stage(p, stage_cache, li, x, length, cfg, kind, block=None):
    """Layer ``li`` of a stage at one decode step (the body of the
    reference's scan): attention reads and writes its cache row
    ``length`` (GQA's K/V, MLA's ckv/kr; ``block``, the caches' block of
    the sequence under a mesh), then the MLP or the experts; a recurrent
    block steps its state (``impl="seq"``, one token) and writes it
    back."""
    if kind != "attn":
        state = {name: c[li] for name, c in stage_cache.items()}
        x, state = _rec_block(p, x, cfg, kind, impl="seq", state=state)
        _store(stage_cache, li, state)
        return x
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if "wdq" in p["attn"]:
        out, _, _ = mla_decode(p["attn"], h, stage_cache["ckv"][li],
                               stage_cache["kr"][li], length, cfg, block)
    else:
        out, _, _ = gqa_decode(p["attn"], h, stage_cache["k"][li],
                               stage_cache["v"][li], length, cfg, block)
    x = x + out
    return x + _ffn(p, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)[0]


def lm_prefill(params, cfg: ModelConfig, tokens=None, embeds=None, *,
               max_len: int, impl="chunked", rec_impl="chunked", mesh=None,
               dp_axes=("data",), model_axis="model", last_index=None,
               cache_batch: int | None = None):
    """Prefill: forward over the prompt, tokens ``(b, S)`` or embeddings
    ``(b, S, d_model)``, filling fresh decode caches.

    Returns ``(last_logits (b, V), caches, length)``.  Cache layout as
    ``init_caches``; K/V (MLA: ckv/kr) are written at positions ``[0,
    S)``, recurrent
    states after the last token.  ``last_index``: int or ``(b,)`` index of
    the true last prompt token (right-padded prompts are causal-safe for
    attention: pads never reach positions at or before it; a recurrent
    state absorbs them, so recurrent models are prefilled at their exact
    length); ``length`` is then ``last_index + 1``, else ``S``.  ``mesh``:
    sharded (module docstring); the logits, caches (``init_caches(mesh=)``'s
    layout) and a ``(b,)`` length are this rank's rows.  The attention
    core runs on this rank's heads; each layer's k and v rows go to the
    ranks whose blocks of the sequence hold them (``attention
    .cache_block_rows``: one all-to-all over the model axis).
    ``cache_batch``: the global batch whose ``init_caches(mesh=)`` layout
    the caches' sequence takes (a serving pool's slots, into which a
    one-row prefill is copied); the prompts' batch by default.
    """
    check_mesh(cfg, mesh)
    if mesh is None:
        return _prefill(params, cfg, tokens, embeds, max_len, impl,
                        rec_impl, last_index)
    b = _inputs(tokens, embeds)[0]
    block = seq_block(mesh, cache_batch or b, max_len, dp=dp_axes,
                      model=model_axis)
    params = col.sharded_tree(params, mesh)
    dp_axes = _batch_axes(b, dp_axes, mesh)
    with shard_axes(dp_axes, model_axis, mesh):
        return _prefill(params, cfg, _rows(tokens), _rows(embeds), max_len,
                        impl, rec_impl, _rows(last_index), block)


def _prefill(params, cfg, tokens, embeds, max_len, impl, rec_impl,
             last_index, block=None):
    """``lm_prefill``'s body on this rank's rows (the caches' attention
    leaves ``block``'s positions), under the caller's sharding context."""
    b, S, dev = _inputs(tokens, embeds)
    positions = torch.arange(S, device=dev)[None].expand(b, S)
    x = _embed(params, cfg, tokens, embeds, positions)
    caches = _init_caches(cfg, b, max_len, params["embed"].dtype, dev,
                          block)

    def attn(p, x, cache, li):
        x, _, rows = _attn_block(p, x, positions, cfg, impl=impl)
        for name, t in rows.items():
            if block is not None:
                t = cache_block_rows(t, block, cfg,
                                     latent=name in ("ckv", "kr"))
            cache[name][li, :, :t.shape[1]] = t
        return x

    def rec(p, x, cache, li, kind):
        x, state = _rec_block(p, x, cfg, kind, impl=rec_impl)
        _store(cache, li, state)
        return x

    if cfg.shared_attn_every:
        for idx, kind, layers, shared in _super_steps(params, cfg):
            for li, p in layers:
                x = rec(p, x, caches["stage_0"], li, kind)
            x = attn(shared, x, caches["shared"], idx)
    else:
        for key, kind, li, p in _layers(params, cfg):
            x = (attn(p, x, caches[key], li) if kind == "attn"
                 else rec(p, x, caches[key], li, kind))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_index is None:
        x_last = x[:, -1:]
        length = S
    else:
        idx = torch.as_tensor(last_index, dtype=torch.long,
                              device=dev).reshape(-1).expand(b)
        x_last = x[torch.arange(b, device=dev), idx.clamp(0, S - 1)][:, None]
        length = idx + 1
    return dot(x_last, _head(params, cfg))[:, 0], caches, length
