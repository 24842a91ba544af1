"""Optimizers: AdamW (fp32 or int8-quantized moments) and SGD.

Port of ``src/repro/train/optim.py``.  The int8 moment store keeps Adam's m
and v as int8 log-spaced codes with one fp32 scale per block of
``QBLOCK = 256`` elements along the last dim, dequantized inside the update
(8 -> 2.25 bytes a parameter, scales included).  Codes are log-spaced over
``_QRANGE = 24`` octaves below each block's absmax: code c in [-127, 127]
stands for ``sign(c) · 2^((|c| - 1)/126 · R - R) · absmax``.

API as the reference's (optax-like): ``opt = adamw(...)``; ``state =
opt.init(params)``; ``updates, state, metrics = opt.update(grads, state,
params)``; the caller adds each update to its parameter.  Trees are nested
dicts of tensors; an int8 moment is a ``QTensor``.  The global grad-norm
clip sums the leaves in the reference's order (sorted keys), the bias
corrections are fp32, weight decay applies where ``p.ndim >= 2`` (each
stage's stacked ``(L, d)`` norm scales too, as in the reference), and each
update is cast to its parameter's dtype (bf16 parameters keep no fp32
master copy).

Difference from the reference: the fp32 moments are updated in place and
the returned state holds the same tensors (the reference is functional);
the arithmetic, in the reference's order, is the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

QBLOCK = 256
_QRANGE = 24.0   # octaves below the block absmax representable


# ------------------------------------------------------------------ trees --
def tree_leaves(tree) -> list:
    """The leaves of a nested dict in the reference's order (sorted keys);
    a ``QTensor`` is one leaf."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {key: build(tree[key]) for key in sorted(tree)}
        return next(it)

    return build(like)


# ------------------------------------------------------------ quantization --
def _pad_len(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x fp32 ``(..., L)`` -> (int8 log-codes ``(..., Lpad)``, fp32 absmax
    ``(..., nb)``)."""
    pad = _pad_len(x.shape[-1]) - x.shape[-1]
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, QBLOCK)
    scale = blocks.abs().amax(-1).clamp(min=1e-12)
    a = blocks.abs() / scale[..., None]
    mag = torch.clamp(torch.round(
        (torch.log2(a.clamp(min=2.0 ** -_QRANGE)) + _QRANGE)
        * (126.0 / _QRANGE)) + 1, 1, 127)
    codes = torch.where(a < 2.0 ** (-_QRANGE), 0.0,
                        torch.sign(blocks) * mag).to(torch.int8)
    return codes.reshape(*x.shape[:-1], -1), scale


def dequantize_i8(codes: torch.Tensor, scale: torch.Tensor,
                  shape) -> torch.Tensor:
    blocks = codes.reshape(*codes.shape[:-1], -1, QBLOCK)
    c = blocks.float()
    mag = 2.0 ** ((c.abs() - 1.0) * (_QRANGE / 126.0) - _QRANGE)
    out = torch.where(c == 0, 0.0, torch.sign(c) * mag) * scale[..., None]
    return out.reshape(*codes.shape[:-1], -1)[..., :shape[-1]]


class QTensor(NamedTuple):
    codes: torch.Tensor       # int8, param shape with last dim padded
    scale: torch.Tensor       # fp32, (..., n_blocks)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


# ----------------------------------------------------------------- AdamW ----
def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0,
          quantized: bool = False) -> Optimizer:
    """AdamW.  ``lr`` may be a schedule ``fn(step) -> lr`` (``step``: the
    int32 step count after this update, from 1).  ``quantized`` stores the
    moments as int8 ``QTensor``s."""
    def lr_at(step):
        return lr(step) if callable(lr) else lr

    def init(params):
        def zeros_like_state(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return QTensor(*quantize_i8(z)) if quantized else z

        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params)),
                "m": tree_map(zeros_like_state, params),
                "v": tree_map(zeros_like_state, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        # global grad-norm clip
        gsq = sum(torch.sum(torch.square(g.float()))
                  for g in tree_leaves(grads))
        gnorm = torch.sqrt(gsq)
        clip = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0) if grad_clip else 1.0
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        lr_t = lr_at(step)

        def upd(g, m, v, p):
            g = g.float() * clip
            if quantized:
                mf = dequantize_i8(m.codes, m.scale, g.shape)
                vf = dequantize_i8(v.codes, v.scale, g.shape)
                mf = b1 * mf + (1.0 - b1) * g
                vf = b2 * vf + (1.0 - b2) * g * g
            else:                       # in place, the same arithmetic
                mf = m.mul_(b1).add_((1.0 - b1) * g)
                vf = v.mul_(b2).add_((1.0 - b2) * g * g)
            u = -(lr_t * (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
                  + lr_t * weight_decay * p.float() * float(p.ndim >= 2))
            if quantized:
                return (u.to(p.dtype), QTensor(*quantize_i8(mf)),
                        QTensor(*quantize_i8(vf)))
            return u.to(p.dtype), mf, vf

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(params))]
        updates = tree_unflatten(grads, [o[0] for o in out])
        new_state = {"step": step,
                     "m": tree_unflatten(grads, [o[1] for o in out]),
                     "v": tree_unflatten(grads, [o[2] for o in out])}
        return updates, new_state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        if momentum:
            return {"step": step, "m": tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)}
        return {"step": step}

    def update(grads, state, params):
        step = state["step"] + 1
        if momentum:
            m = tree_map(lambda mm, g: momentum * mm + g.float(),
                         state["m"], grads)
            upd = tree_map(lambda mm, p: (-lr * mm).to(p.dtype), m, params)
            return upd, {"step": step, "m": m}, {}
        upd = tree_map(lambda g, p: (-lr * g).to(p.dtype), grads, params)
        return upd, {"step": step}, {}

    return Optimizer(init=init, update=update)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine down
    to ``floor · peak`` at ``total``; ``lr(step)`` takes an integer tensor
    (or int) and returns fp32."""
    def lr(step):
        s = torch.as_tensor(step).float()
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)

    return lr
