"""Optimizers: AdamW (fp32 or int8-quantized moments) and SGD.

Port of ``src/repro/train/optim.py``.  The int8 moment store keeps Adam's m
and v as int8 log-spaced codes with one fp32 scale per block of
``QBLOCK = 256`` elements along the last dim, dequantized inside the update
(8 -> 2.25 bytes a parameter, scales included).  Codes are log-spaced over
``_QRANGE = 24`` octaves below each block's absmax: code c in [-127, 127]
stands for ``sign(c) · 2^((|c| - 1)/126 · R - R) · absmax``.

API as the reference's (optax-like) but in place: ``opt = adamw(...)``;
``state = opt.init(params)``; ``state, metrics = opt.update(grads, state,
params)`` adds each update to its parameter.  Trees are nested dicts of
tensors; an int8 moment is a ``QTensor``.  The global grad-norm clip sums
the leaves in the reference's order (sorted keys), the bias corrections
are fp32, weight decay applies where ``p.ndim >= 2`` (each stage's stacked
``(L, d)`` norm scales too, as in the reference), and each update is cast
to its parameter's dtype and added there, as the reference's ``(p +
u).astype(p.dtype)`` (bf16 parameters keep no fp32 master copy).

Difference from the reference, which is functional (it returns the updates
and a new state): the arithmetic, element by element in the reference's
order, is the same, but each parameter gets its update added in place and
each moment, int8 codes and scales included, is overwritten in place, a
leaf's rows ``CHUNK_ELEMS`` elements at a time (int8 blocks run along the
last axis, so rows quantize alone).  Neither an updates tree nor a second
state is ever held, and a leaf's fp32 temporaries stay near 256 MiB: a
1.6 B-element expert leaf (grok-1's) would otherwise need about 40 GB of
them.  The returned state is the one passed in.

Sharded parameters (``DTensor`` leaves, ``distributed.sharding
.device_put``): each moment takes its parameter's placements (a
``DTensor`` over a local block of the same shape), the grads are the
local blocks' (``train.step``), and every update is elementwise on the
local blocks.  The grad norm, and the clip from it, is the global one:
each rank sums the squares of its blocks, a block replicated over some
mesh axes counted only on the ranks at coordinate 0 of those axes (once),
and the sums are added over the group.

An int8 moment on a mesh is a ``QTensor`` of ``DTensor``s whose codes and
scales are the reference's blocks of each global row along the last dim:
gathered whole (``QTensor.whole`` pads the codes), they are what one
process gives from the same grads, bit for bit.  Where the parameter's
last dim is not sharded, or is cut into local widths that are multiples
of ``QBLOCK``, each rank's rows quantize alone and codes and scales take
the parameter's placements.  Where it is cut at other widths, a shard's
edge cuts a block: each rank then holds its columns' codes (placed like
the parameter, the global codes ``(..., L)`` unpadded) and its rows'
scales of every block of the row (replicated over the axes that cut the
last dim), and quantizing takes each block's absmax as the max of the
ranks' partial absmaxes, one all-reduce over those axes.  That moves the
scales only (a 256th of the codes' elements); exchanging a straddling
block's columns with the neighbour rank would move columns both ways and
still need the absmax of the whole block.  The codes of a column depend
on its value and its block's scale alone, so no column crosses ranks.
``moment_shardings`` gives the ``NamedSharding``s to restore such a state
onto a mesh (``CheckpointManager.restore(shardings=)``, which saves
``QTensor.whole`` and restores ``QTensor.fit``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import collectives as col

QBLOCK = 256
_QRANGE = 24.0   # octaves below the block absmax representable
# AdamW's update takes a leaf's rows this many elements at a time
CHUNK_ELEMS = 1 << 26


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
    return _unflatten(like, iter(leaves))


def _unflatten(tree, it):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would hold ``leaves`` (a step's grads) until
    # the cyclic collector runs
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], it) for key in sorted(tree)}
    return next(it)


# ------------------------------------------------------------ quantization --
def _pad_len(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def _encode(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 blocks ``(..., nb, QBLOCK)`` and their scales ``(..., nb)`` ->
    int8 codes ``(..., nb, QBLOCK)``."""
    a = blocks.abs() / scale[..., None]
    mag = torch.clamp(torch.round(
        (torch.log2(a.clamp(min=2.0 ** -_QRANGE)) + _QRANGE)
        * (126.0 / _QRANGE)) + 1, 1, 127)
    return torch.where(a < 2.0 ** (-_QRANGE), 0.0,
                       torch.sign(blocks) * mag).to(torch.int8)


def _decode(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``_encode``'s inverse: codes ``(..., nb, QBLOCK)`` -> fp32."""
    c = blocks.float()
    mag = 2.0 ** ((c.abs() - 1.0) * (_QRANGE / 126.0) - _QRANGE)
    return torch.where(c == 0, 0.0, torch.sign(c) * mag) * scale[..., None]


def quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x fp32 ``(..., L)`` -> (int8 log-codes ``(..., Lpad)``, fp32 absmax
    ``(..., nb)``)."""
    pad = _pad_len(x.shape[-1]) - x.shape[-1]
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, QBLOCK)
    scale = blocks.abs().amax(-1).clamp(min=1e-12)
    return _encode(blocks, scale).reshape(*x.shape[:-1], -1), scale


def dequantize_i8(codes: torch.Tensor, scale: torch.Tensor,
                  shape) -> torch.Tensor:
    blocks = codes.reshape(*codes.shape[:-1], -1, QBLOCK)
    out = _decode(blocks, scale)
    return out.reshape(*codes.shape[:-1], -1)[..., :shape[-1]]


def _in_blocks(x: torch.Tensor, off: int):
    """``x`` ``(..., w)``, the global columns ``[off, off + w)`` of a row,
    as whole blocks of the row: zero-padded to block edges on both sides.
    -> (blocks ``(..., k, QBLOCK)``, the first block's index, the left
    pad)."""
    left = off % QBLOCK
    w = x.shape[-1]
    x = F.pad(x, (left, _pad_len(left + w) - left - w))
    return x.reshape(*x.shape[:-1], -1, QBLOCK), off // QBLOCK, left


def quantize_i8_at(x: torch.Tensor, off: int, n_blocks: int,
                   max_over) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_i8`` of the columns ``[off, off + w)`` of rows whose
    other columns other ranks hold: ``max_over(partial)`` takes the
    elementwise max of the ranks' partial absmaxes ``(..., n_blocks)`` in
    place.  -> (codes ``(..., w)``, the rows' scales of all ``n_blocks``
    blocks): the reference's codes of these columns and its scales."""
    blocks, j0, left = _in_blocks(x, off)
    k = blocks.shape[-2]
    scale = x.new_zeros((*x.shape[:-1], n_blocks))
    scale[..., j0:j0 + k] = blocks.abs().amax(-1)
    max_over(scale)
    scale = scale.clamp(min=1e-12)
    codes = _encode(blocks, scale[..., j0:j0 + k])
    codes = codes.reshape(*x.shape[:-1], -1)
    return codes[..., left:left + x.shape[-1]], scale


def dequantize_i8_at(codes: torch.Tensor, scale: torch.Tensor,
                     off: int) -> torch.Tensor:
    """``quantize_i8_at``'s inverse: the columns ``[off, off + w)`` of
    codes ``(..., w)`` against the rows' scales of every block."""
    blocks, j0, left = _in_blocks(codes, off)
    out = _decode(blocks, scale[..., j0:j0 + blocks.shape[-2]])
    return out.reshape(*codes.shape[:-1], -1)[..., left:left
                                                  + codes.shape[-1]]


class QTensor(NamedTuple):
    codes: torch.Tensor       # int8, param shape with last dim padded
    scale: torch.Tensor       # fp32, (..., n_blocks)

    def whole(self) -> "QTensor":
        """This moment gathered whole (every rank of its mesh taking part)
        in the reference's layout: codes ``(..., Lpad)``, zero codes
        appended where a leaf whose shards cut blocks holds them
        unpadded."""
        codes, scale = col.whole(self.codes), col.whole(self.scale)
        pad = _pad_len(codes.shape[-1]) - codes.shape[-1]
        return QTensor(F.pad(codes, (0, pad)) if pad else codes, scale)

    def fit(self, like: "QTensor") -> "QTensor":
        """Codes and scales in the reference's layout (``whole``'s) as
        ``like`` holds them globally: the codes cut to its width."""
        return QTensor(self.codes[..., :like.codes.shape[-1]], self.scale)

    def local(self, p) -> torch.Tensor:
        """This rank's block of the moment of ``p`` (its parameter),
        dequantized: fp32 of ``p``'s local shape."""
        at = _straddle_ctx(p)
        codes, scale = col.local(self.codes), col.local(self.scale)
        if at is None:
            return dequantize_i8(codes, scale, col.local(p).shape)
        return dequantize_i8_at(codes, scale, at[0])


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # ``update(grads, state, params) -> (state, metrics)``, in place
    update: Callable[..., Any]


def _row_chunks(t: torch.Tensor, rows_per: int):
    """``t`` viewed (never copied: written through) as ``(rows, last)``, in
    chunks of ``rows_per`` rows."""
    flat = t.view(-1, t.shape[-1]) if t.ndim else t.view(1, 1)
    return flat.split(rows_per)


def _device_of(tree) -> torch.device:
    return col.local(tree_leaves(tree)[0]).device


def _sharded(leaves) -> bool:
    """Whether the parameters are placed on a mesh (any ``DTensor``)."""
    return any(col.is_dtensor(p) for p in leaves)


def _cut_last(p) -> list[int]:
    """The mesh dims that cut a ``DTensor`` ``p``'s last dim, in mesh
    order (none for a plain tensor)."""
    if not col.is_dtensor(p):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(p.placements)
            if isinstance(pl, Shard) and pl.dim % p.ndim == p.ndim - 1]


def _straddles(p) -> bool:
    """Whether a shard's edge cuts ``QBLOCK`` blocks of ``p``'s rows: its
    last dim is cut at local widths that are not multiples of
    ``QBLOCK``."""
    return bool(_cut_last(p)) and col.local(p).shape[-1] % QBLOCK != 0


def _q_zeros(p) -> QTensor:
    """The int8 moment of zeros for ``p`` (module docstring's layouts)."""
    if not col.is_dtensor(p):
        return QTensor(*quantize_i8(torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)))
    from torch.distributed.tensor import DTensor, Replicate
    loc = col.local(p)
    if not _straddles(p):
        codes, scale = quantize_i8(torch.zeros(loc.shape, dtype=torch.float32,
                                               device=loc.device))
        scale_pl = p.placements
    else:
        codes = torch.zeros(loc.shape, dtype=torch.int8, device=loc.device)
        scale = torch.full((*loc.shape[:-1], -(-p.shape[-1] // QBLOCK)),
                           1e-12, dtype=torch.float32, device=loc.device)
        cut = _cut_last(p)
        scale_pl = [Replicate() if i in cut else pl
                    for i, pl in enumerate(p.placements)]
    return QTensor(
        DTensor.from_local(codes, p.device_mesh, p.placements,
                           run_check=False),
        DTensor.from_local(scale, p.device_mesh, scale_pl, run_check=False))


def _straddle_ctx(p):
    """For a parameter whose shards cut blocks (``_straddles``): its
    columns' offset in the row, the row's block count and the in-place
    max over the ranks that cut the row; else None."""
    if not _straddles(p):
        return None
    import torch.distributed as dist
    mesh, cut = p.device_mesh, _cut_last(p)
    coord = mesh.get_coordinate()
    idx = 0
    for d in cut:
        idx = idx * mesh.size(d) + coord[d]
    groups = [mesh.get_group(d) for d in cut]

    def max_over(t):
        for g in groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
            col.note("all-reduce", t, 2)

    return (idx * col.local(p).shape[-1], -(-p.shape[-1] // QBLOCK),
            max_over)


def moment_shardings(params, shardings, *, quantized: bool = False):
    """The ``NamedSharding``s of AdamW's ``m`` (and ``v``, the same tree)
    for parameters placed by ``shardings``: each moment's its
    parameter's; an int8 moment's a ``QTensor`` of the codes' (its
    parameter's) and the scales' (its parameter's, but replicated over
    the axes that cut the last dim where they cut blocks: module
    docstring).  For ``CheckpointManager.restore(shardings=)``."""
    from repro_torch.distributed.sharding import NamedSharding

    def one(p, sh):
        if not quantized:
            return sh
        spec = list(sh.spec) + [None] * (len(p.shape) - len(sh.spec))
        axes = col.axes_of(spec[-1])
        n = math.prod(sh.mesh.shape[a] for a in axes)
        if axes and (p.shape[-1] // n) % QBLOCK:
            spec[-1] = None
        return QTensor(sh, NamedSharding(sh.mesh, tuple(spec)))

    return tree_map(one, params, shardings)


def _zeros_like(p, make):
    """``make(shape, device)`` for the local block of ``p``, as a
    ``DTensor`` with ``p``'s placements where ``p`` is one."""
    if not col.is_dtensor(p):
        return make(p.shape, p.device)
    from torch.distributed.tensor import DTensor
    loc = col.local(p)
    return DTensor.from_local(make(loc.shape, loc.device), p.device_mesh,
                              p.placements, run_check=False)


def _grad_sq(grads, params) -> torch.Tensor:
    """Σ of the squared grads, over the whole of each sharded leaf when
    the parameters are placed on a mesh (module docstring)."""
    gs, ps = tree_leaves(grads), tree_leaves(params)
    if not _sharded(ps):
        return sum(torch.sum(torch.square(col.local(g).float())) for g in gs)
    total = torch.zeros((), dtype=torch.float32,
                        device=col.local(ps[0]).device)
    for g, p in zip(gs, ps):
        if col.counted_here(p):
            total = total + torch.sum(torch.square(col.local(g).float()))
    dist.all_reduce(total)
    col.note("all-reduce", total, 2)
    return total


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
            if quantized:
                return _q_zeros(p)
            return _zeros_like(p, lambda shape, device: torch.zeros(
                shape, dtype=torch.float32, device=device))

        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params)),
                "m": tree_map(zeros_like_state, params),
                "v": tree_map(zeros_like_state, params)}

    def prepare(grads, state, params):
        """-> (step, clip, bias corrections, lr, grad norm)."""
        step = state["step"] + 1
        # global grad-norm clip
        gnorm = torch.sqrt(_grad_sq(grads, params))
        clip = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0) if grad_clip else 1.0
        t = step.float()
        return step, clip, 1.0 - b1 ** t, 1.0 - b2 ** t, lr_at(step), gnorm

    def upd(g, m, v, p, decay, clip, bc1, bc2, lr_t, at):
        """Rows of one leaf: -> (update in p's dtype, new m, new v); fp32
        m and v are updated in place.  ``at``: ``_straddle_ctx``'s."""
        g = g.float() * clip
        if quantized:
            if at is None:
                mf = dequantize_i8(m.codes, m.scale, g.shape)
                vf = dequantize_i8(v.codes, v.scale, g.shape)
            else:
                mf = dequantize_i8_at(m.codes, m.scale, at[0])
                vf = dequantize_i8_at(v.codes, v.scale, at[0])
            mf = b1 * mf + (1.0 - b1) * g
            vf = b2 * vf + (1.0 - b2) * g * g
        else:                       # in place, the same arithmetic
            mf = m.mul_(b1).add_((1.0 - b1) * g)
            vf = v.mul_(b2).add_((1.0 - b2) * g * g)
        u = -(lr_t * (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
              + lr_t * weight_decay * p.float() * decay)
        if not quantized:
            return u.to(p.dtype), mf, vf
        if at is None:
            return (u.to(p.dtype), QTensor(*quantize_i8(mf)),
                    QTensor(*quantize_i8(vf)))
        return (u.to(p.dtype), QTensor(*quantize_i8_at(mf, *at)),
                QTensor(*quantize_i8_at(vf, *at)))

    def local(t):
        if isinstance(t, QTensor):
            return QTensor(col.local(t.codes), col.local(t.scale))
        return col.local(t)

    def update(grads, state, params):
        step, clip, bc1, bc2, lr_t, gnorm = prepare(grads, state, params)
        for g, m, v, leaf in zip(*(tree_leaves(t) for t in (
                grads, state["m"], state["v"], params))):
            at = _straddle_ctx(leaf) if quantized else None
            g, m, v, p = (local(t) for t in (g, m, v, leaf))
            decay = float(p.ndim >= 2)
            rows = max(1, CHUNK_ELEMS // max(1, p.shape[-1] if p.ndim
                                                 else 1))
            parts = [_row_chunks(t, rows) for t in (g, p)]
            moments = [([_row_chunks(q.codes, rows),
                         _row_chunks(q.scale, rows)] if quantized
                        else [_row_chunks(q, rows)]) for q in (m, v)]
            for i, (gc, pc) in enumerate(zip(*parts)):
                if quantized:
                    mc = QTensor(moments[0][0][i], moments[0][1][i])
                    vc = QTensor(moments[1][0][i], moments[1][1][i])
                else:
                    mc, vc = moments[0][0][i], moments[1][0][i]
                u, mf, vf = upd(gc, mc, vc, pc, decay, clip, bc1, bc2, lr_t,
                                at)
                pc.add_(u)
                if quantized:
                    for dst, src in zip((*mc, *vc), (*mf, *vf)):
                        dst.copy_(src)
        state["step"] = step
        return state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        if momentum:
            return {"step": step, "m": tree_map(
                lambda p: _zeros_like(p, lambda shape, device: torch.zeros(
                    shape, dtype=torch.float32, device=device)), params)}
        return {"step": step}

    def update(grads, state, params):
        state["step"] = state["step"] + 1
        moments = (tree_leaves(state["m"]) if momentum
                   else [None] * len(tree_leaves(params)))
        for g, m, p in zip(*(map(col.local, t) for t in (
                tree_leaves(grads), moments, tree_leaves(params)))):
            d = g.float()
            if momentum:
                d = m.mul_(momentum).add_(d)
            p.add_((-lr * d).to(p.dtype))
        return state, {}

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
