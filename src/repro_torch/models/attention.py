"""GQA and MLA attention for the LM stack.

Port of ``src/repro/models/attention.py``: ``naive_attention``,
``decode_attention``, ``init_gqa``, ``gqa_project``, ``gqa_forward``,
``_pos_vec``, ``gqa_decode``, and MLA (DeepSeek's multi-head latent
attention): ``init_mla``, ``_mla_qkr``, ``mla_forward`` and ``mla_decode``;
the decode over sequence blocks has no counterpart file (below).
Activations keep the reference's
``(B, S, H, hd)`` layout.  The reference's four implementations of the
attention core (``impl``):

  naive         full ``(Sq, Sk)`` scores in plain PyTorch — the oracle, and
                the decode path (per-row lengths), as the reference runs it
                in XLA.
  chunked       the reference's default, its XLA twin of the Pallas flash
                kernel; here the hand-written CUDA kernel
                (``kernels/flash_attention.py``), which reads q, k and v as
                permuted views.  On CPU tensors it runs its plain version.
                When grad is enabled and an input needs it, it runs through
                ``FlashAttentionFn``, the port of the reference's
                ``flash_attention_xla`` custom_vjp: the forward kernel saves
                the LSE and the backward kernel recomputes the scores.
  chunked_scan  ``chunked_attention``: the online softmax over key chunks
                of 512, in plain PyTorch (the reference's ``lax.scan``, a
                loop here); differentiable by autograd.
  tri           ``tri_attention``: causal prefill over the chunks at or
                below the diagonal only, in plain PyTorch; an inference
                path, as in the reference (not reverse-differentiable
                there), so it raises under autograd.

No Pallas kernel stands behind ``chunked_scan`` or ``tri`` in the
reference: both are XLA realizations of the same function, ported as
plain PyTorch.

MLA projects q through a rank-``q_lora`` bottleneck and k, v through a
shared rank-``kv_lora`` latent ``ckv`` plus one rope key ``kr`` shared by
the heads.  A forward or a prefill decompresses per-head k and v and runs
the attention core with q·k over ``nope + rope`` (192 for deepseek-v3)
and v of ``v_head_dim`` (128): the flash kernel's (192, 128)
instantiation under ``chunked``.  A decode step is the reference's
weight-absorbed form: scores and context in the latent space, from the
cache of ``ckv`` and ``kr`` alone, as fp32 einsums (no kernel stands
behind it in the reference either).

Under a mesh context (``layers.shard_axes``) each rank runs its model
rank's share of the heads (``local_heads``, ``layers.head_part``; all of
them, whole on every model rank, where the model axis is wider than the
head count) on its batch rows: the projections read only
those heads' columns (a weight sharded over the model axis on exactly
them is not gathered; one split elsewhere, mid-head, is gathered whole
and cut at whole heads), the
attention core (the flash forward and backward kernels under
``chunked``) runs on the local ``(batch / dp, heads / model)`` slice,
and the output projection's partial sums over the model axis meet in
fp32 (``layers.psum_model``), as the reference's layout pins them.  A
GQA group's q heads read their kv head on the same rank: a rank's kv
heads are those its q heads read, each repeated per q head where the
rank's heads cut a group unevenly.  MLA's latent projections (``wdq``,
``wdkv``) are read whole, so the shared latent and rope key are the same
on every model rank.

A decode step under a mesh reads caches in the reference's
``cache_specs`` layout (``sharding.seq_block``): a rank holds its block
of the sequence, every kv head (MLA: the latent).  XLA derives the
reference's partial softmaxes from those shardings; here they are
spelled out: q is gathered over the model axis to every head, the new k
and v to every kv head (each once), the rank whose block holds a row's
position writes it, each rank runs a softmax over its block
(``gqa_block_partial`` / ``mla_block_partial``), and the blocks meet in
a max and a sum all-reduce (``combine_blocks``); the rank keeps its
heads' rows for the output projection.  A step moves q, the new row and
the ``(m, l, acc)`` triple, whatever ``max_len``.  Over one block (the
sequence whole) the rank's q heads attend to their kv heads as without
a mesh.  A prefill sends each layer's k and v rows to their blocks
(``cache_block_rows``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import collectives as col
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.models.layers import (dot, head_part, head_rms_norm,
                                       head_shares, init_linear,
                                       mesh_axes_active, psum_model,
                                       rms_norm, rope, weight, wide)

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


def _online_step(qs, kb, vb, keep, m, l, acc, scores, context):
    """One key chunk of the online softmax: scores ``einsum(scores, qs,
    kb)`` masked to ``NEG`` outside ``keep``, the running max ``m``, sum
    ``l`` and output ``acc`` rescaled and updated."""
    s = torch.einsum(scores, qs, wide(kb))
    if keep is not None:
        s = torch.where(keep, s, NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(context, p, wide(vb))
    return m_new, l, acc


def chunked_attention(q, k, v, *, causal: bool, offset: int = 0,
                      scale: float | None = None, chunk: int = 512):
    """Online softmax over key chunks of ``min(chunk, Sk)`` (``Sk`` a
    multiple of it), at all H heads (k and v repeated over each group, as
    the reference's ``chunked_attention`` does); fp32 (``wide``), rows
    whose sum is 0 divided by 1.  Differentiable by autograd."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale or 1.0 / math.sqrt(hd)
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"chunked_scan: Sk = {Sk} is not a multiple of "
                         f"its chunk {chunk}")
    dv = v.shape[-1]
    qf = wide(q) * scale
    if group > 1:
        k = k.repeat_interleave(group, 2)
        v = v.repeat_interleave(group, 2)
    qpos = torch.arange(Sq, device=q.device) + offset
    acc_t = qf.dtype
    m = torch.full((B, H, Sq), -math.inf, dtype=acc_t, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=acc_t, device=q.device)
    acc = torch.zeros((B, H, Sq, dv), dtype=acc_t, device=q.device)
    for c0 in range(0, Sk, chunk):
        keep = None
        if causal:
            kpos = c0 + torch.arange(chunk, device=q.device)
            keep = kpos[None, :] <= qpos[:, None]
        m, l, acc = _online_step(qf, k[:, c0:c0 + chunk],
                                 v[:, c0:c0 + chunk], keep, m, l, acc,
                                 "bqhd,bkhd->bhqk", "bhqk,bkhd->bhqd")
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def tri_attention(q, k, v, *, causal: bool = True, offset: int = 0,
                  scale: float | None = None, chunk: int = 512):
    """Causal prefill in query chunks of ``min(chunk, Sq, Sk)`` (dividing
    both), each visiting only the key chunks at or below its diagonal
    (``(qi·chunk + chunk - 1 + offset) // chunk + 1`` of them, at most
    all): about half the products of a full pass at long prompts.  GQA
    groups stay grouped; fp32 (``wide``), rows whose sum is 0 divided by
    1.  Causal only (``causal`` is the cores' signature).  Inference only,
    as the reference's (``fori_loop`` over a dynamic bound, not
    reverse-differentiable): raises under autograd."""
    if not causal:
        raise ValueError("tri attention is causal only")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("tri attention is an inference path (the "
                           "reference's is not reverse-differentiable): "
                           "train with impl='chunked' or 'chunked_scan'")
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = scale or 1.0 / math.sqrt(hd)
    chunk = min(chunk, Sq, Sk)
    if Sq % chunk or Sk % chunk:
        raise ValueError(f"tri: Sq = {Sq} and Sk = {Sk} must be multiples "
                         f"of their chunk {chunk}")
    nkc = Sk // chunk
    dv = v.shape[-1]
    qf = (wide(q) * scale).reshape(B, Sq, Hkv, group, hd)
    acc_t, dev = qf.dtype, q.device
    outs = []
    for q0 in range(0, Sq, chunk):
        qb = qf[:, q0:q0 + chunk]
        qpos = q0 + torch.arange(chunk, device=dev) + offset
        m = torch.full((B, Hkv, group, chunk), -math.inf, dtype=acc_t,
                       device=dev)
        l = torch.zeros((B, Hkv, group, chunk), dtype=acc_t, device=dev)
        acc = torch.zeros((B, Hkv, group, chunk, dv), dtype=acc_t,
                          device=dev)
        diag = min((q0 + chunk - 1 + offset) // chunk + 1, nkc)
        for ci in range(diag):
            kpos = ci * chunk + torch.arange(chunk, device=dev)
            sl = slice(ci * chunk, (ci + 1) * chunk)
            m, l, acc = _online_step(qb, k[:, sl], v[:, sl],
                                     kpos[None, :] <= qpos[:, None], m, l,
                                     acc, "bqhgd,bkhd->bhgqk",
                                     "bhgqk,bkhd->bhgqd")
        out = acc / torch.where(l == 0, 1.0, l)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, chunk, H, dv))
    return torch.cat(outs, 1).to(q.dtype)


ATTN_IMPLS = {"naive": naive_attention, "chunked": flash_chunked_attention,
              "chunked_scan": chunked_attention, "tri": tri_attention}


def attention_impl(impl: str):
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; the port has "
                         f"{', '.join(ATTN_IMPLS)}")
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


def local_heads(n_heads: int, n_kv: int):
    """This model rank's q heads ``[lo, hi)`` (``layers.head_part``) and
    the kv heads they read, in order: a range, one per group (the group's
    q heads sit on this rank with it), or a list, one per q head where the
    rank's heads cut a group unevenly.  All heads without a mesh context, or
    where the model axis is wider than the head count."""
    lo, hi = head_part(n_heads, uneven=True)
    return lo, hi, _kv_of(n_heads, n_kv, lo, hi)


def _kv_of(n_heads: int, n_kv: int, lo: int, hi: int):
    """The kv heads q heads ``[lo, hi)`` read (``local_heads``' rule)."""
    if (lo, hi) == (0, n_heads):
        return range(n_kv)
    g = n_heads // n_kv
    kv = [h // g for h in range(lo, hi)]
    distinct = range(kv[0], kv[-1] + 1)
    per, rest = divmod(hi - lo, len(distinct))
    if not rest and kv == [h for h in distinct for _ in range(per)]:
        return distinct
    return kv


def _head_cols(heads, width: int, device):
    """The columns of ``heads`` (a range, or a list of heads) in a ``(..,
    heads · width)`` projection: a slice, or an index tensor."""
    if isinstance(heads, range):
        return slice(heads.start * width, heads.stop * width)
    return torch.tensor([h * width + i for h in heads for i in range(width)],
                        device=device)


def gqa_project(params, x, positions, cfg):
    """-> q ``(B, S, H, hd)``, k, v ``(B, S, Hkv, hd)`` with bias, qk-norm
    and rope applied (this rank's heads under a mesh: ``local_heads``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    lo, hi, kv = local_heads(cfg.n_heads, cfg.n_kv_heads)
    qc, kc = slice(lo * hd, hi * hd), _head_cols(kv, hd, x.device)
    q = dot(x, weight(params["wq"], -1, qc))
    k = dot(x, weight(params["wk"], -1, kc))
    v = dot(x, weight(params["wv"], -1, kc))
    if cfg.qkv_bias:
        q = q + weight(params["bq"], 0, qc).float()
        k = k + weight(params["bk"], 0, kc).float()
        v = v + weight(params["bv"], 0, kc).float()
    q = q.to(x.dtype).reshape(B, S, hi - lo, hd)
    k = k.to(x.dtype).reshape(B, S, len(kv), hd)
    v = v.to(x.dtype).reshape(B, S, len(kv), hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, x, out, head_width: int):
    """The output projection of the attention output ``out`` ``(B, S,
    H, head_width)``: this rank's heads' rows of ``wo``, the partial sums
    added over the model axis in fp32 under a mesh, cast once."""
    B, S = x.shape[:2]
    n = params["wo"].shape[0] // head_width
    lo, hi = head_part(n, uneven=True)
    rows = slice(lo * head_width, hi * head_width)
    y = dot(out.reshape(B, S, -1), weight(params["wo"], 0, rows))
    return (y if (lo, hi) == (0, n) else psum_model(y)).to(x.dtype)


def gqa_attend(params, x, q, k, v, *, impl="chunked", offset=0):
    """Attention of projected q, k, v and the output projection."""
    out = attention_impl(impl)(q, k, v, causal=True, offset=offset)
    return _out_proj(params, x, out, v.shape[-1])


def gqa_forward(params, x, positions, cfg, *, impl="chunked", offset=0):
    q, k, v = gqa_project(params, x, positions, cfg)
    return gqa_attend(params, x, q, k, v, impl=impl, offset=offset)


# ------------------------------------------------------------------- MLA --
def init_mla(gen, cfg, dtype):
    m, H, dev = cfg.mla, cfg.n_heads, gen.device
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "wdq": init_linear(gen, cfg.d_model, m.q_lora_rank, dtype),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
        "wuq": init_linear(gen, m.q_lora_rank, H * qh, dtype),
        "wdkv": init_linear(gen, cfg.d_model,
                            m.kv_lora_rank + m.rope_head_dim, dtype),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
        "wukv": init_linear(gen, m.kv_lora_rank,
                            H * (m.nope_head_dim + m.v_head_dim), dtype),
        "wo": init_linear(gen, H * m.v_head_dim, cfg.d_model, dtype),
    }


def _mla_qkr(params, x, positions, cfg):
    """The shared projections: q_nope ``(B, S, H, nope)``, q_rope ``(B, S,
    H, rope)``, ckv ``(B, S, kv_lora)``, kr ``(B, S, 1, rope)``."""
    m = cfg.mla
    B, S, _ = x.shape
    qh = m.nope_head_dim + m.rope_head_dim
    lo, hi = head_part(cfg.n_heads, uneven=True)
    cq = rms_norm(dot(x, weight(params["wdq"])).to(x.dtype),
                  params["q_norm"], cfg.norm_eps)
    q = dot(cq, weight(params["wuq"], -1, slice(lo * qh, hi * qh))).to(
        x.dtype).reshape(B, S, hi - lo, qh)
    qn, qr = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    qr = rope(qr, positions, cfg.rope_theta)
    dkv = dot(x, weight(params["wdkv"])).to(x.dtype)
    ckv = rms_norm(dkv[..., :m.kv_lora_rank], params["kv_norm"],
                   cfg.norm_eps)
    kr = rope(dkv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    return qn, qr, ckv, kr


def mla_attend(params, x, qn, qr, ckv, kr, cfg, *, impl="chunked",
               offset=0):
    """Attention of ``_mla_qkr``'s projections and the output projection:
    per-head k and v decompressed from ckv, q·k over ``nope + rope`` with
    scale ``1/sqrt(nope + rope)``, v of ``v_head_dim`` (a view into the
    decompressed kv, read in place by the kernel)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = qn.shape[2]
    kv = dot(ckv, _wukv(params, cfg)).to(x.dtype).reshape(
        B, S, H, m.nope_head_dim + m.v_head_dim)
    kn, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    q = torch.cat([qn, qr], -1)
    k = torch.cat([kn, kr.expand(B, S, H, m.rope_head_dim)], -1)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    out = attention_impl(impl)(q, k, v, causal=True, offset=offset,
                               scale=scale)
    return _out_proj(params, x, out, m.v_head_dim)


def _wukv(params, cfg):
    """``wukv``'s columns of this rank's heads (``(kv_lora, H · (nope +
    v))``)."""
    width = cfg.mla.nope_head_dim + cfg.mla.v_head_dim
    lo, hi = head_part(cfg.n_heads, uneven=True)
    return weight(params["wukv"], -1, slice(lo * width, hi * width))


def mla_forward(params, x, positions, cfg, *, impl="chunked", offset=0):
    """Training / prefill MLA: decompress per-head k and v, then standard
    attention (``impl``: ``chunked``, the flash kernel; ``naive``,
    ``chunked_scan`` or ``tri``, plain PyTorch)."""
    qn, qr, ckv, kr = _mla_qkr(params, x, positions, cfg)
    return mla_attend(params, x, qn, qr, ckv, kr, cfg, impl=impl,
                      offset=offset)


def _pos_vec(length, b, device):
    """length int or ``(b,)`` -> positions ``(b, 1)``."""
    lv = torch.as_tensor(length, dtype=torch.long, device=device)
    return lv.reshape(-1, 1).expand(b, 1)


def _live(start: int, n: int, length):
    """``(B, n)``: which of a cache block's ``n`` positions from global
    position ``start`` lie below each row's ``length`` ``(B,)``."""
    pos = start + torch.arange(n, device=length.device)
    return pos[None] < length.reshape(-1, 1)


def _block_partial(s, live, v, context: str):
    """A sequence block's share of a softmax: scores ``s`` ``(..., n)``
    masked to ``NEG`` outside ``live``; returns their max ``m`` (``NEG``
    where no key is live), ``l``, the sum of ``exp(s - m)`` over the live
    keys (0 where none is), and ``acc``, ``einsum(context, p, v)`` of
    those weights."""
    s = torch.where(live, s, NEG)
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum(context, p, v)


def combine_blocks(m, l, acc, pmax, psum):
    """The split softmax's combine across sequence blocks (each holding
    ``_block_partial``'s ``m``, ``l``, ``acc``): ``M = pmax(m)``, then one
    ``psum`` of ``[l·e^(m−M), acc·e^(m−M)]`` packed together; returns the
    sum of ``acc`` over that of ``l`` (divided by 1 where no key is live
    anywhere).  A block with no live key adds exactly 0: ``e^(NEG − M)``
    underflows to 0 beside any live score.  ``pmax`` and ``psum`` reduce
    over the blocks (collectives over the axes that cut the sequence)."""
    w = torch.exp(m - pmax(m))
    packed = psum(torch.cat([(l * w)[..., None], acc * w[..., None]], -1))
    total = packed[..., :1]
    return packed[..., 1:] / torch.where(total == 0, 1.0, total)


def _reducers(block):
    """``combine_blocks``' reductions over the axes of ``block``
    (``sharding.SeqBlock``) of the active mesh."""
    mesh = mesh_axes_active().mesh
    return (lambda t: col.pmax(t, mesh, block.axes),
            lambda t: col.psum(t, mesh, block.axes))


def _head_index(held, width: int, want) -> list[int]:
    """Where each head of ``want`` sits in the model ranks' heads
    concatenated (rank ``k``'s ``held[k]`` padded to ``width``): at the
    first rank that holds it."""
    where: dict = {}
    for k, heads in enumerate(held):
        for i, h in enumerate(heads):
            where.setdefault(h, k * width + i)
    return [where[h] for h in want]


def _pad_heads(t, width: int):
    """``t`` ``(B, S, n, ...)`` with zero heads appended up to ``width``."""
    if t.shape[2] == width:
        return t
    pad = t.new_zeros((*t.shape[:2], width - t.shape[2], *t.shape[3:]))
    return torch.cat([t, pad], 2)


def _select_heads(g, idx):
    """The heads ``idx`` of ``g`` (dim 2), ``g`` itself where they are
    all of them in order."""
    if idx == list(range(g.shape[2])):
        return g
    return g.index_select(2, torch.tensor(idx, device=g.device))


def _gather_heads(t, held, want):
    """``t`` ``(B, S, n, ...)`` holds this model rank's heads, ``held[k]``
    those model rank ``k`` holds: the heads ``want``, each read from the
    first rank that holds it, through one all-gather over the model axis
    (each rank's heads padded to the most any rank holds)."""
    ax = mesh_axes_active()
    width = max(len(h) for h in held)
    g = col.gather(_pad_heads(t, width), ax.mesh, 2, ax.model)
    return _select_heads(g, _head_index(held, width, want))


def _all_q(q, n_heads: int):
    """This model rank's heads of ``q`` ``(B, S, heads, ...)`` as all
    ``n_heads`` in the global order (itself where every rank holds them
    all)."""
    shares = head_shares(n_heads)
    if shares[0] == (0, n_heads):
        return q
    return _gather_heads(q, [range(lo, hi) for lo, hi in shares],
                         range(n_heads))


def _kv_held(n_heads: int, n_kv: int) -> list:
    """Each model rank's kv heads (``local_heads``), in the axis' order."""
    return [_kv_of(n_heads, n_kv, lo, hi) for lo, hi in head_shares(n_heads)]


def _all_kv(k, n_heads: int, n_kv: int):
    """This model rank's kv heads of ``k`` ``(B, S, local kv, hd)`` as all
    ``n_kv``, each once."""
    if head_shares(n_heads)[0] == (0, n_heads):
        return k
    return _gather_heads(k, _kv_held(n_heads, n_kv), range(n_kv))


def _heads(cache, kv):
    """The kv heads ``kv`` (a range: a view; a list: a copy) of a cache
    ``(B, S, n_kv, hd)``."""
    if isinstance(kv, range):
        return cache[:, :, kv.start:kv.stop]
    return cache.index_select(2, torch.tensor(kv, device=cache.device))


def cache_block_rows(t, block, cfg, *, latent: bool = False):
    """A prefill's cache rows of one layer as this rank holds them in its
    caches: its block ``[block.lo, min(block.hi, S))`` of the prompt's
    positions, every kv head.  ``t`` is the layer's ``(b, S, local kv,
    hd)`` (``gqa_project``'s heads), or with ``latent`` MLA's ``(b, S,
    width)``, whole on every model rank.  Where the rank's q heads are all
    of them, and for the latent, a slice.  Else one all-to-all over the
    model axis: each rank sends each other rank of its model group the
    prompt positions of that rank's block of its own kv heads, 1/model
    of the rows, no sequence gathered whole; where the sequence is whole
    (``block.axes`` empty), every kv head is gathered."""
    b, S = t.shape[:2]
    H, n_kv = cfg.n_heads, cfg.n_kv_heads
    if latent or head_shares(H)[0] == (0, H):
        return t[:, block.lo:min(block.hi, S)]
    held = _kv_held(H, n_kv)
    if not block.axes:
        return _gather_heads(t, held, range(n_kv))
    ax = mesh_axes_active()
    m, k = ax.model_size, ax.model_index
    size = block.hi - block.lo
    first = block.lo - k * size           # the model group's first block
    sent = [max(0, min(size, S - first - j * size)) for j in range(m)]
    if not sum(sent):
        return t.new_zeros((b, 0, n_kv, t.shape[3]))
    width = max(len(h) for h in held)
    src = _pad_heads(t[:, first:first + sum(sent)], width)
    got = col.all_to_all(src.transpose(0, 1), ax.mesh, ax.model, sent=sent,
                         got=[sent[k]] * m)
    hd = t.shape[3]
    got = got.reshape(m, sent[k], b, width, hd).permute(2, 1, 0, 3, 4)
    return _select_heads(got.reshape(b, sent[k], m * width, hd),
                         _head_index(held, width, range(n_kv)))


def gqa_decode(params, x, cache_k, cache_v, length, cfg, block=None):
    """x ``(B, 1, d)``; ``length`` int or ``(B,)``.  Writes the new k and v
    at row ``length`` of each cache in place (a row at or past the cache's
    end is dropped, as the reference's ``mode="drop"``) and returns
    ``(out, cache_k, cache_v)``.

    ``block`` (``sharding.SeqBlock``; under a mesh context): the caches
    hold this rank's block of the sequence, every kv head, as the
    reference's ``cache_specs`` lays them out.  This rank's heads are
    projected; the new k and v are gathered to every kv head and written
    by the rank whose block holds the row's position.  Over one block
    (the sequence whole) this rank's q heads attend to their kv heads as
    without a mesh; over several, q is gathered to every head, each rank
    runs a partial softmax over its block (``_block_partial``), the blocks
    meet in two collectives (``combine_blocks``), and the rank keeps its
    heads' rows for the output projection."""
    b = x.shape[0]
    positions = _pos_vec(length, b, x.device)
    q, k1, v1 = gqa_project(params, x, positions, cfg)
    rows = torch.arange(b, device=x.device)
    pos = positions[:, 0]
    if block is None:
        _write_row(cache_k, rows, pos, k1[:, 0])
        _write_row(cache_v, rows, pos, v1[:, 0])
        out = decode_attention(q, cache_k, cache_v, pos + 1)
        return _out_proj(params, x, out, out.shape[-1]), cache_k, cache_v
    H, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, k1.shape[-1]
    kv1 = _all_kv(torch.cat([k1, v1], -1), H, n_kv)[:, 0]   # one gather
    _write_row(cache_k, rows, pos, kv1[..., :hd], block.lo)
    _write_row(cache_v, rows, pos, kv1[..., hd:], block.lo)
    lo, hi, kv = local_heads(H, n_kv)
    if not block.axes:
        out = decode_attention(q, _heads(cache_k, kv), _heads(cache_v, kv),
                               pos + 1)
    else:
        part = gqa_block_partial(_all_q(q, H), cache_k, cache_v, block.lo,
                                 pos + 1)
        out = combine_blocks(*part, *_reducers(block))
        out = out.reshape(b, 1, H, -1)[:, :, lo:hi].to(x.dtype)
    return _out_proj(params, x, out, out.shape[-1]), cache_k, cache_v


def gqa_block_partial(q, k, v, start: int, length):
    """A decode step's attention over one block of the sequence: q ``(B,
    1, H, hd)`` every head; k, v ``(B, n, Hkv, hd)``, the block from
    global position ``start``; ``length`` ``(B,)``.  Returns
    ``_block_partial``'s ``(m, l, acc)`` per row, kv head and q head of
    its group (``(B, Hkv, H / Hkv)``, ``acc`` with ``v``'s width last),
    fp32 (``wide``), for ``combine_blocks``."""
    b, _, H, hd = q.shape
    n_kv = k.shape[2]
    qa = wide(q).reshape(b, n_kv, H // n_kv, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qa, _heads_major(k)) \
        * (1.0 / math.sqrt(hd))
    live = _live(start, k.shape[1], length)[:, None, None]
    return _block_partial(s, live, _heads_major(v), "bhgk,bhkd->bhgd")


def _heads_major(t):
    """A cache block ``(B, n, Hkv, d)`` as ``(B, Hkv, n, d)``, contiguous,
    in fp32 (``wide``): one copy, the cast and the transpose together,
    which the products then read as batched matrices without another."""
    dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    return t.transpose(1, 2).to(dtype, memory_format=torch.contiguous_format)


def mla_block_partial(q_abs, q_rope, ckv, kr, start: int, length,
                      qk_dim: int):
    """``gqa_block_partial`` in MLA's latent space: ``q_abs`` ``(B, 1, H,
    kv_lora)`` and ``q_rope`` ``(B, 1, H, rope)`` every head, the block of
    ``ckv`` ``(B, n, kv_lora)`` and ``kr`` ``(B, n, rope)`` (fp32);
    scores over ``sqrt(qk_dim)``.  ``(m, l, acc)`` per row and head
    (``(B, H, 1)``; ``acc``, the latent context, ``kv_lora`` wide)."""
    s = torch.einsum("bthk,bsk->bhts", q_abs, ckv)
    s = s + torch.einsum("bthr,bsr->bhts", q_rope, kr)
    s = s / math.sqrt(qk_dim)
    live = _live(start, ckv.shape[1], length)[:, None, None]
    return _block_partial(s, live, ckv, "bhts,bsk->bhtk")


def _write_row(cache, rows, pos, new, lo: int = 0) -> None:
    """Write ``new[b]`` at ``cache[b, pos[b] - lo]`` in place: the cache
    holds positions ``[lo, lo + n)``.  A row outside them is dropped:
    at or past the last block's end, as the reference's ``mode="drop"``;
    in another block, whose rank writes it."""
    n = cache.shape[1]
    at_pos = pos - lo
    keep = ((at_pos >= 0) & (at_pos < n)).reshape(
        -1, *([1] * (new.dim() - 1)))
    at = (rows, at_pos.clamp(0, n - 1))
    cache.index_put_(at, torch.where(keep, new, cache[at]))


def mla_decode(params, x, cache_ckv, cache_kr, length, cfg, block=None):
    """Absorbed decode in the compressed space.  x ``(B, 1, d)``; caches
    ckv ``(B, S, kv_lora)`` and kr ``(B, S, rope)``, written in place at
    row ``length`` (dropped at or past the end); ``length`` int or
    ``(B,)``.  Scores ``= (q_nope W_uk) ckvᵀ + q_rope krᵀ``, the context
    stays rank ``kv_lora`` until ``W_uv``; fp32 (``wide``).  Returns
    ``(out, cache_ckv, cache_kr)``.  ``block``: as ``gqa_decode``'s, in
    the latent space: over several blocks ``q_abs`` and ``q_rope`` are
    gathered to every head, each rank scores its block of ``ckv`` and
    ``kr``, the blocks combine, and ``W_uv`` maps this rank's heads'
    context."""
    m = cfg.mla
    B = x.shape[0]
    positions = _pos_vec(length, B, x.device)
    qn, qr, ckv1, kr1 = _mla_qkr(params, x, positions, cfg)
    H = qn.shape[2]
    rows = torch.arange(B, device=x.device)
    start = 0 if block is None else block.lo
    _write_row(cache_ckv, rows, positions[:, 0], ckv1[:, 0], start)
    _write_row(cache_kr, rows, positions[:, 0], kr1[:, 0, 0], start)
    wukv = _wukv(params, cfg).reshape(m.kv_lora_rank, H,
                                      m.nope_head_dim + m.v_head_dim)
    w_uk = wide(wukv[..., :m.nope_head_dim])         # (kv_lora, H, nope)
    w_uv = wide(wukv[..., m.nope_head_dim:])         # (kv_lora, H, v)
    ckv, kr = wide(cache_ckv), wide(cache_kr)
    q_abs = torch.einsum("bthn,khn->bthk", wide(qn), w_uk)
    if block is None or not block.axes:
        s = torch.einsum("bthk,bsk->bhts", q_abs, ckv)
        s = s + torch.einsum("bthr,bsr->bhts", wide(qr), kr)
        s = s / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        lv = torch.as_tensor(length, device=x.device).reshape(-1, 1, 1, 1)
        mask = torch.arange(ckv.shape[1], device=x.device)[
            None, None, None] <= lv
        p = torch.softmax(torch.where(mask, s, NEG), -1)
        ctx = torch.einsum("bhts,bsk->bthk", p, ckv)
    else:
        qa = _all_q(torch.cat([q_abs, wide(qr)], -1), cfg.n_heads)
        part = mla_block_partial(
            qa[..., :m.kv_lora_rank], qa[..., m.kv_lora_rank:], ckv, kr,
            block.lo, positions[:, 0] + 1, m.nope_head_dim + m.rope_head_dim)
        lo, hi = head_part(cfg.n_heads, uneven=True)
        ctx = combine_blocks(*part, *_reducers(block))[:, lo:hi]
        ctx = ctx.transpose(1, 2)                    # (B, 1, H, kv_lora)
    out = torch.einsum("bthk,khv->bthv", ctx, w_uv).to(x.dtype)
    return _out_proj(params, x, out, m.v_head_dim), cache_ckv, cache_kr
