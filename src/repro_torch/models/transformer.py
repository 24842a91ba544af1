"""Decoder-only LM assembled from a block pattern: the dense attention stages.

Port of ``src/repro/models/transformer.py`` (``build_stages``, ``init_lm``,
``_attn_block`` with the ``mlp`` variant, ``lm_forward``, ``lm_loss``,
``init_caches``, ``lm_decode_step``, ``_decode_stage``, ``lm_prefill``).
Parameters and caches keep the reference's tree: each stage's layers are
stacked on a leading axis; ``lax.scan`` over a stage becomes a Python loop
over its layers.  Other block kinds (mamba2, mlstm, slstm), the ``moe``
variant, MLA, ``shared_attn_every``, input embeddings fed from outside
(``embed_inputs=False``) and sinusoidal positions raise
``NotImplementedError`` (ROADMAP queue 1 item 10); ``lm_forward`` and
``lm_prefill`` therefore take tokens only, and positions ``0..S-1``.

``remat=True`` runs each layer under ``torch.utils.checkpoint`` (the
reference wraps each scanned block in ``jax.checkpoint``).  A ``mesh``
(sharded training) raises ``NotImplementedError`` (ROADMAP queue 1 item
6).

Differences from the reference: ``impl`` is an argument only (no
``REPRO_ATTN_IMPL`` override); ``lm_prefill`` projects q, k and v once and
feeds both the attention and the cache from that projection (the
reference projects twice, to the same values) and defaults to ``chunked``,
the flash kernel (the reference's default ``tri`` is not ported); decode
writes the caches in place and returns the same dict.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (gqa_attend, gqa_decode,
                                          gqa_project, init_gqa, _pos_vec)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, dot, dtype_of,
                                       init_linear, init_mlp, mlp_apply,
                                       normal, rms_norm, stack_params,
                                       unbind_params)


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
    """Raise unless every stage is a dense GQA attention block with an MLP."""
    what = []
    if not cfg.embed_inputs:
        what.append("embed_inputs=False")
    if cfg.pos_emb == "sinusoidal":
        what.append("pos_emb=sinusoidal")
    if cfg.attn_type != "gqa":
        what.append(f"attn_type={cfg.attn_type}")
    if cfg.shared_attn_every:
        what.append("shared_attn_every")
    for kind, variant, _ in build_stages(cfg):
        if (kind, variant) != ("attn", "mlp"):
            what.append(f"{kind}/{variant}" if variant else kind)
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(what)))} not ported "
            f"(ROADMAP queue 1 item 10); the port runs dense GQA stages")


def _dense_ff(cfg):
    if cfg.moe is not None and cfg.moe.d_ff_dense:
        return cfg.moe.d_ff_dense
    return cfg.d_ff


# ==================================================================== init ==
def _init_block(gen, cfg, dtype):
    dev = gen.device
    return {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "attn": init_gqa(gen, cfg, dtype),
            "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            "mlp": init_mlp(gen, cfg.d_model, _dense_ff(cfg), dtype,
                            cfg.mlp_act)}


def init_lm(seed: int, cfg: ModelConfig, dtype=None, *, device="cuda"):
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``),
    in the reference's tree and scales: std ``1/sqrt(fan_in)`` for
    linears, 0.02 for the embedding, ones for norms."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"embed": normal(gen, (cfg.vocab, cfg.d_model), dtype, 0.02),
              "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=device)}
    if not cfg.tie_embeddings:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab, dtype)
    for si, (_, _, idxs) in enumerate(build_stages(cfg)):
        params[f"stage_{si}"] = stack_params(
            [_init_block(gen, cfg, dtype) for _ in idxs])
    return params


# ================================================================= forward ==
def _attn_block(p, x, positions, cfg, *, impl, offset=0):
    """One dense block; returns ``(x, k, v)`` (k, v for the cache)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q, k, v = gqa_project(p["attn"], h, positions, cfg)
    x = x + gqa_attend(p["attn"], h, q, k, v, impl=impl, offset=offset)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act), k, v


def _layers(params, cfg):
    """``(stage key, layer index within the stage, layer params)`` for
    every layer, in order."""
    for si in range(len(build_stages(cfg))):
        for li, p in enumerate(unbind_params(params[f"stage_{si}"])):
            yield f"stage_{si}", li, p


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _block_out(p, x, positions, cfg, impl):
    return _attn_block(p, x, positions, cfg, impl=impl)[0]


def lm_forward(params, cfg: ModelConfig, tokens, *, impl="chunked",
               remat=False):
    """Full-sequence forward over tokens ``(b, S)``.  Returns ``(logits
    (b, S, V) fp32, aux)``; aux is 0.0 (it is the MoE load-balancing loss
    in the reference).  ``remat``: each layer runs under
    ``torch.utils.checkpoint`` (its activations recomputed in the
    backward, its input saved)."""
    check_supported(cfg)
    b, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
    x = params["embed"][tokens]
    for _, _, p in _layers(params, cfg):
        if remat:
            x = checkpoint(_block_out, p, x, positions, cfg, impl,
                           use_reentrant=False)
        else:
            x = _block_out(p, x, positions, cfg, impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, _head(params, cfg)), 0.0


def check_single_device(mesh) -> None:
    """Raise for a mesh: the port trains on one device."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (mesh=...) is not ported (ROADMAP queue 1 "
            "item 6); the port trains on one device")


# ==================================================================== loss ==
def lm_loss(params, cfg: ModelConfig, batch, *, mesh=None, impl="chunked",
            remat=False, aux_weight=1e-2):
    """Next-token loss of ``batch = {"tokens", "labels"}`` (labels ``-1``
    ignored): ``(loss, {"ce", "aux"})`` with ``loss = ce + aux_weight ·
    aux``.  The reference's mesh axes (``dp_axes``, ``model_axis``) have no
    counterpart on one device."""
    check_single_device(mesh)
    if batch.get("embeds") is not None:
        raise NotImplementedError("embeddings fed from outside (batch "
                                  "\"embeds\") are not ported (ROADMAP "
                                  "queue 1 item 10)")
    logits, aux = lm_forward(params, cfg, batch["tokens"], impl=impl,
                             remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ================================================================== caches ==
def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                device="cuda"):
    """Per-layer decode caches, stacked per stage: ``{"stage_i": {"k", "v":
    (L, batch, max_len, Hkv, hd)}}``, zeros."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    return {f"stage_{si}": {
        name: torch.zeros((len(idxs), batch, max_len, cfg.n_kv_heads, hd),
                          dtype=dtype, device=device)
        for name in ("k", "v")}
        for si, (_, _, idxs) in enumerate(build_stages(cfg))}


def lm_decode_step(params, cfg: ModelConfig, tokens, caches, length):
    """One decode step.  tokens ``(b,)``; length int or ``(b,)`` (current
    context size).  Writes the caches in place; returns ``(logits (b, V),
    caches)``."""
    check_supported(cfg)
    positions = _pos_vec(length, tokens.shape[0], tokens.device)
    x = params["embed"][tokens[:, None]]                        # (b, 1, d)
    for key, li, p in _layers(params, cfg):
        x = _decode_stage(p, caches[key], li, x, length, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dot(x, _head(params, cfg))[:, 0], caches


def _decode_stage(p, stage_cache, li, x, length, cfg):
    """Layer ``li`` of a stage at one decode step (the body of the
    reference's scan)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, _, _ = gqa_decode(p["attn"], h, stage_cache["k"][li],
                           stage_cache["v"][li], length, cfg)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.mlp_act)


def lm_prefill(params, cfg: ModelConfig, tokens, *, max_len: int,
               impl="chunked", last_index=None):
    """Prefill: forward over the prompt tokens ``(b, S)``, filling fresh
    decode caches.

    Returns ``(last_logits (b, V), caches, length)``.  Cache layout as
    ``init_caches``; K/V are written at positions ``[0, S)``.
    ``last_index``: int or ``(b,)`` index of the true last prompt token
    (right-padded prompts are causal-safe: pads never reach positions at
    or before it); ``length`` is then ``last_index + 1``, else ``S``.
    """
    check_supported(cfg)
    b, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None].expand(b, S)
    x = params["embed"][tokens]
    caches = init_caches(cfg, b, max_len, params["embed"].dtype,
                         device=dev)
    for key, li, p in _layers(params, cfg):
        x, k, v = _attn_block(p, x, positions, cfg, impl=impl)
        caches[key]["k"][li, :, :S] = k
        caches[key]["v"][li, :, :S] = v
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
