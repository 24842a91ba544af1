"""GQA attention for the LM stack.

Port of the GQA part of ``src/repro/models/attention.py``: ``naive_attention``,
``decode_attention``, ``init_gqa``, ``gqa_project``, ``gqa_forward``,
``_pos_vec`` and ``gqa_decode``.  Activations keep the reference's
``(B, S, H, hd)`` layout.  Two of the reference's implementations of the
attention core are ported:

  naive    full ``(Sq, Sk)`` scores in plain PyTorch — the oracle, and the
           decode path (per-row lengths), as the reference runs it in XLA.
  chunked  the reference's default, its XLA twin of the Pallas flash
           kernel; here the hand-written CUDA kernel
           (``kernels/flash_attention.py``), which reads q, k and v as
           permuted views.  On CPU tensors it runs its plain version.
           When grad is enabled and an input needs it, it runs through
           ``FlashAttentionFn``, the port of the reference's
           ``flash_attention_xla`` custom_vjp: the forward kernel saves the
           LSE and the backward kernel recomputes the scores.

``tri`` and ``chunked_scan`` compute the same function and are not ported
(ROADMAP queue 1 item 10); nor is MLA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.models.layers import (dot, head_rms_norm, init_linear,
                                       rope, wide)

NEG = -1e30


# ----------------------------------------------------------------- cores --
def naive_attention(q, k, v, *, causal: bool, offset: int = 0,
                    scale: float | None = None, length=None):
    """q ``(B, Sq, H, hd)``; k, v ``(B, Sk, Hkv, hd)``.  ``length``: valid kv
    length — an int or a ``(B,)`` tensor (continuous-batching decode)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale or 1.0 / math.sqrt(hd)
    qf = wide(q).reshape(B, Sq, Hkv, group, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, wide(k)) * scale
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + offset
        mask &= (kpos[None, :] <= qpos)[None]
    if length is not None:
        lv = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1)
        mask &= kpos[None, None, :] < lv
    s = torch.where(mask[:, None, None], s, NEG)
    p = torch.softmax(s, -1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, wide(v))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def flash_chunked_attention(q, k, v, *, causal: bool, offset: int = 0,
                            scale: float | None = None):
    """The flash kernel on ``(B, S, H, hd)`` activations: q, k and v go in
    as permuted views and the output comes back in q's layout.  Under
    autograd (grad enabled and an input that needs it) it is
    ``FlashAttentionFn``, the counterpart of the reference's
    ``flash_attention_xla``, whose backward is the flash backward kernel."""
    if offset != k.shape[1] - q.shape[1]:
        raise ValueError(f"flash attention aligns query i with key "
                         f"i + Sk - Sq = {k.shape[1] - q.shape[1]}, got "
                         f"offset {offset}")
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if torch.is_grad_enabled() and any(t.requires_grad for t in views):
        out = FlashAttentionFn.apply(*views, causal, scale)
    else:
        out = flash_attention(*views, causal=causal, scale=scale)
    return out.transpose(1, 2)


ATTN_IMPLS = {"naive": naive_attention, "chunked": flash_chunked_attention}


def attention_impl(impl: str):
    if impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported (ROADMAP queue 1 item "
            f"10); the port has {', '.join(ATTN_IMPLS)}")
    return ATTN_IMPLS[impl]


def decode_attention(q, kcache, vcache, length, *,
                     scale: float | None = None):
    """Single-token decode: q ``(B, 1, H, hd)``, caches ``(B, S, Hkv, hd)``,
    ``length`` = valid length (int or ``(B,)``)."""
    return naive_attention(q, kcache, vcache, causal=False, scale=scale,
                           length=length)


# ------------------------------------------------------------------- GQA --
def init_gqa(gen, cfg, dtype):
    hd = cfg.resolved_head_dim
    p = {"wq": init_linear(gen, cfg.d_model, cfg.n_heads * hd, dtype),
         "wk": init_linear(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
         "wv": init_linear(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
         "wo": init_linear(gen, cfg.n_heads * hd, cfg.d_model, dtype)}
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def gqa_project(params, x, positions, cfg):
    """-> q ``(B, S, H, hd)``, k, v ``(B, S, Hkv, hd)`` with bias, qk-norm
    and rope applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = dot(x, params["wq"])
    k = dot(x, params["wk"])
    v = dot(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].float()
        k = k + params["bk"].float()
        v = v + params["bv"].float()
    q = q.to(x.dtype).reshape(B, S, cfg.n_heads, hd)
    k = k.to(x.dtype).reshape(B, S, cfg.n_kv_heads, hd)
    v = v.to(x.dtype).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(params, x, q, k, v, *, impl="chunked", offset=0):
    """Attention of projected q, k, v and the output projection."""
    out = attention_impl(impl)(q, k, v, causal=True, offset=offset)
    B, S = x.shape[:2]
    return dot(out.reshape(B, S, -1), params["wo"]).to(x.dtype)


def gqa_forward(params, x, positions, cfg, *, impl="chunked", offset=0):
    q, k, v = gqa_project(params, x, positions, cfg)
    return gqa_attend(params, x, q, k, v, impl=impl, offset=offset)


def _pos_vec(length, b, device):
    """length int or ``(b,)`` -> positions ``(b, 1)``."""
    lv = torch.as_tensor(length, dtype=torch.long, device=device)
    return lv.reshape(-1, 1).expand(b, 1)


def gqa_decode(params, x, cache_k, cache_v, length, cfg):
    """x ``(B, 1, d)``; ``length`` int or ``(B,)``.  Writes the new k and v
    at row ``length`` of each cache in place (a row at or past the cache's
    end is dropped, as the reference's ``mode="drop"``) and returns
    ``(out, cache_k, cache_v)``."""
    b, max_len = x.shape[0], cache_k.shape[1]
    positions = _pos_vec(length, b, x.device)
    q, k1, v1 = gqa_project(params, x, positions, cfg)
    rows = torch.arange(b, device=x.device)
    pos = positions[:, 0]
    keep = (pos < max_len)[:, None, None]
    at = (rows, pos.clamp(max=max_len - 1))
    cache_k.index_put_(at, torch.where(keep, k1[:, 0], cache_k[at]))
    cache_v.index_put_(at, torch.where(keep, v1[:, 0], cache_v[at]))
    out = decode_attention(q, cache_k, cache_v, positions[:, 0] + 1)
    out = out.reshape(b, 1, -1)
    return dot(out, params["wo"]).to(x.dtype), cache_k, cache_v
