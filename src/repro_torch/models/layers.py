"""Shared LM building blocks: norms, RoPE, dense MLP, init.

Port of ``src/repro/models/layers.py`` (``dot``, ``rms_norm``,
``head_rms_norm``, ``rope``, ``sinusoidal_pos``, ``mlp_apply``,
``causal_mask``, ``cross_entropy``, ``init_linear``, ``init_mlp``).
Parameters are plain nested dicts of tensors, stacked per stage on a
leading layer axis as in the reference (``transformer._init_stage``
stacks them, in place of the reference's ``stack_params``).  Norms and
the MLP's gate run in fp32 and cast back.

``dot`` returns fp32, as the reference's ``preferred_element_type``
does (float64 operands stay float64: ``wide``, the compute dtype of
norms, products and the recurrences, is fp32 or wider, so a float64 model
runs in float64 throughout, a check free of fp32 rounding).  bf16 operands
give the fp32 result of their product, unrounded, and their VJP is the
reference's: ``dx = bf16(g @ wᵀ)`` and ``dw = bf16(xᵀ @ g)`` with the fp32
cotangent ``g`` unrounded (``WideDot``).  On the card that is cuBLAS with
bf16 operands and an fp32 output (``torch.mm(out_dtype=)``), ``g`` split
into two bf16 parts (about 2^-16 of ``g`` left out, below the result's
own bf16 rounding); no weight is widened there.  On the CPU the operands
are widened, which is the reference's arithmetic.  fp32 and float64
operands take ``torch.matmul`` as they are.

The reference's mesh constraints (``shard_axes``, ``wsc``) are a no-op on
one device and are not ported.  ``causal_mask`` and ``cross_entropy`` (the
training loss) are ported as they are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` as fp32, or as it is in float64."""
    return t if t.dtype == torch.float64 else t.float()


def _parts(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A bf16 operand as it is; an fp32 one (a cotangent) as two bf16
    parts whose sum is it to about 2^-16 of each entry."""
    if t.dtype == torch.bfloat16:
        return (t,)
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) as fp32, each operand bf16 or an
    fp32 cotangent: widened on the CPU; on the card bf16 cuBLAS products
    with fp32 outputs over ``_parts``, summed in fp32."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    mm = torch.mm if a.ndim == 2 else torch.bmm
    out = None
    for x in _parts(a):
        for y in _parts(b):
            part = mm(x, y, out_dtype=torch.float32)
            out = part if out is None else out.add_(part)
    return out


def _wide_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``WideDot``'s forward: x ``(..., K)`` @ w ``(K, N)``, or x ``(n, K)``
    against each expert of w ``(E, K, N)``."""
    if w.ndim == 3:
        return _mm32(x.expand(w.shape[0], *x.shape), w)
    return _mm32(x.reshape(-1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


class WideDot(torch.autograd.Function):
    """bf16 ``x @ w`` as its fp32 result, the reference's ``dot_general``
    with ``preferred_element_type=float32``, with that product's VJP: each
    input's grad is the fp32 product of the unrounded fp32 cotangent,
    rounded once to bf16.  ``w`` is ``(K, N)`` (x ``(..., K)`` ->
    ``(..., N)``) or a stack of experts ``(E, K, N)`` (x ``(n, K)`` ->
    ``(E, n, N)``, the reference's ``einsum("td,edf->tef")`` in the
    port's layout; x's grad sums over the experts in fp32)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _wide_dot(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if w.ndim == 3:
            if ctx.needs_input_grad[0]:
                dx = _mm32(g, w.mT).sum(0).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _mm32(x.mT.expand(w.shape[0], *x.mT.shape),
                           g).to(w.dtype)
            return dx, dw
        g2 = g.reshape(-1, g.shape[-1])
        if ctx.needs_input_grad[0]:
            dx = _mm32(g2, w.mT).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm32(x.reshape(-1, x.shape[-1]).mT, g2).to(w.dtype)
        return dx, dw


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis, as fp32 (``wide``); ``w`` may be a
    stack of experts ``(E, K, N)`` (-> ``(E, n, N)``).  bf16 operands keep
    the fp32 product unrounded (``WideDot``)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        if w.ndim == 3:
            # x against each expert as one batched product: ``matmul``'s
            # fold of (n, K) @ (E, K, N) copies the weight, and autograd
            # keeps that copy for the backward
            x = x.expand(w.shape[0], *x.shape)
        return wide(torch.matmul(x, w))
    return WideDot.apply(x, w)


def rms_norm(x, scale, eps=1e-5):
    xf = wide(x)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * wide(scale)).to(x.dtype)


def head_rms_norm(x, scale, eps=1e-5):
    """Per-head qk-norm (qwen3): x ``(..., H, hd)``."""
    return rms_norm(x, scale, eps)


def rope(x, positions, theta: float = 10_000.0):
    """x: ``(..., S, H, hd)``, positions: ``(..., S)`` int."""
    half = x.shape[-1] // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(1.0 / theta, exps)       # no host-to-device copy
    ang = positions[..., :, None].float()[..., None, :] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)       # (..., S, 1, half)
    x1, x2 = wide(x[..., :half]), wide(x[..., half:])
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d_model: int, dtype=torch.float32):
    """The sinusoidal position table ``(..., d_model)`` of integer
    ``positions`` ``(...)``: the sin half, then the cos half, at
    frequencies ``1e-4 ** (i / half)``, in ``dtype`` (fp32 as the
    reference computes it; float64 for a float64 model).  The fp32
    frequencies are the fp32 power rounded once from float64: the
    reference's at musicgen's widths, where ``torch.pow`` in fp32 is an
    ulp off at some ``i`` (an ulp of a frequency moves the angle at
    position 2048 by up to 1.2e-4)."""
    half = d_model // 2
    dev = positions.device
    if dtype == torch.float64:
        exps = torch.arange(half, dtype=dtype, device=dev) / half
        freqs = torch.pow(1e-4, exps)
    else:
        exps = torch.arange(half, dtype=torch.float32, device=dev) / half
        base = float(torch.tensor(1e-4, dtype=torch.float32))
        freqs = torch.pow(base, exps.double()).to(dtype)
    ang = positions[..., None].to(dtype) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def mlp_apply(params, x, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(dot(x, params["wg"])) * dot(x, params["wi"])
    else:                                  # jax.nn.gelu: tanh approximation
        h = F.gelu(dot(x, params["wi"]), approximate="tanh")
    return dot(h.to(x.dtype), params["wo"]).to(x.dtype)


def causal_mask(sq: int, sk: int, offset: int, device=None):
    """``(sq, sk)`` bool: key j is visible to query i when ``j <= i +
    offset``."""
    q = torch.arange(sq, device=device)[:, None] + offset
    return torch.arange(sk, device=device)[None, :] <= q


def cross_entropy(logits, labels, *, ignore_id: int = -1):
    """Mean next-token loss over the labels ``!= ignore_id``: logits
    ``(..., V)`` cast to fp32, labels ``(...)`` integers; the gold logit is
    picked through ``labels.clip(0)`` (an ignored label picks token 0,
    then weighs 0), as the reference does."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels != ignore_id).float()
    return ((logz - gold) * valid).sum() / valid.sum().clamp(min=1.0)


# ------------------------------------------------------------------- init --
def normal(gen: torch.Generator, shape, dtype, scale) -> torch.Tensor:
    """Standard normal in fp32 from ``gen`` (on ``gen``'s device), times
    ``scale``, cast to ``dtype``: the reference's ``_normal``."""
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return (out * scale).to(dtype)


def init_linear(gen, fin, fout, dtype, *, scale=None):
    """``(fin, fout)`` with std ``1/sqrt(fin)`` unless ``scale``."""
    return normal(gen, (fin, fout), dtype,
                  scale if scale is not None else 1.0 / math.sqrt(fin))


def init_mlp(gen, d, ff, dtype, act="swiglu"):
    p = {"wi": init_linear(gen, d, ff, dtype),
         "wo": init_linear(gen, ff, d, dtype)}
    if act == "swiglu":
        p["wg"] = init_linear(gen, d, ff, dtype)
    return p


def unbind_params(tree) -> list:
    """The layers of a stacked nested dict, as views (no copies): one
    ``unbind`` per leaf, whose backward stacks all the layers' grads at
    once.  (Indexing each layer on its own makes autograd build and add a
    full-size zero-padded grad of the stacked leaf per layer.)"""
    if isinstance(tree, dict):
        parts = {k: unbind_params(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))
