"""Differentiable collectives over the named axes of a process mesh.

It has no counterpart file in the reference, which takes these from
``jax.lax`` (``all_gather``, ``psum``, ``all_to_all``, ``ppermute``) inside
``shard_map``, and from GSPMD's resharding.  Every function here takes a
``launch.mesh.Mesh`` bound to a ``torch.distributed`` device mesh
(``mesh.group(axis)``) and axis names; an axis of size 1 moves nothing.

Autograd convention (what makes the sharded step's grads the one-device
step's): a program run on R ranks is differentiated as the sum of the R
ranks' outputs, and every collective's backward is its exact transpose —
an all-gather's is a reduce-scatter of sums, an all-reduce's an
all-reduce, an all-to-all's the all-to-all back, a shift's the shift the
other way.  A tensor that every rank holds the same copy of and feeds into
a rank's loss must then be counted once: ``replicated_sum`` reduces
forward and passes its cotangent through unchanged, ``scale_grad`` divides
the cotangent of a value every rank holds by the number of holders.

``materialize`` is how a sharded parameter is read: a leaf (a ``Sharded``
pair of local block and spec, or a ``DTensor``) is all-gathered on the
dims it is sharded over (its transpose reduce-scatters the grad back to
the block), and its grad is also summed over the mesh axes it is
replicated on, the ranks that computed partial sums of it.  A plain tensor
under a mesh counts as replicated on every axis.  ``Sharded`` is what the
model code walks: a ``DTensor`` hides its local tensor from autograd, so
a step takes each leaf's local tensor as the leaf to differentiate and
slices per layer on that (``sharded_tree``).

``tallied()`` counts what this rank's collectives move while it is open
(``Tally``; the counterpart of the reference's ``launch/hlo_analysis
.collective_bytes``, which reads the partitioned HLO): per kind, in
bytes, under the ring model of ``hlo_analysis.py``'s docstring.  It is
off by default, and off it costs each collective one read of ``_TALLY``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["Sharded", "sharded_tree", "is_dtensor", "counted_here",
           "spec_of", "local", "materialize",
           "gather", "take_block", "psum", "pmax", "replicated_sum",
           "scale_grad",
           "all_to_all", "ppermute", "axes_of", "Tally", "tallied", "note"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


class Tally:
    """Per-device bytes each collective kind moves, under the reference's
    ring model (N ranks in the group, ``(N - 1) / N`` rounded to 1): an
    all-gather its result, a reduce-scatter its operand, an all-reduce
    twice its result (a reduce-scatter and an all-gather), an all-to-all
    and a permute their result.  ``calls`` counts the calls per kind."""

    def __init__(self):
        self.bytes = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.calls[kind] += 1

    def per_device(self) -> dict:
        """The reference's ``collective_bytes`` record: bytes per kind,
        their ``total`` and the calls per kind (``op_counts``)."""
        return {**self.bytes, "total": sum(self.bytes.values()),
                "op_counts": dict(self.calls)}


_TALLY: Tally | None = None


@contextlib.contextmanager
def tallied():
    """Count this rank's collectives into a fresh ``Tally`` (yielded)
    while the block runs."""
    global _TALLY
    prev, _TALLY = _TALLY, Tally()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def note(kind: str, t, times: int = 1) -> None:
    """Count a collective on ``t`` made outside this module (``kind`` and
    the tensor the ring model reads: ``Tally``)."""
    if _TALLY is not None:
        _TALLY.add(kind, times * _nbytes(t))


def axes_of(entry) -> tuple:
    """A spec entry (None, a name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def counted_here(t) -> bool:
    """Whether this rank counts ``t``'s block in a sum over the whole
    leaf: a ``DTensor`` block replicated over some mesh dims is counted
    by the ranks at coordinate 0 of those dims only; a plain tensor (the
    same on every rank) by global rank 0."""
    if not is_dtensor(t):
        return not dist.is_initialized() or dist.get_rank() == 0
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if pl.is_replicate())


def local(t):
    """A leaf's own local tensor (a ``DTensor``'s the object itself, so an
    in-place update writes the parameter), else ``t``."""
    if isinstance(t, Sharded):
        return t.local
    return t._local_tensor if is_dtensor(t) else t


def whole(t):
    """A ``DTensor`` gathered whole, every rank of its mesh taking part;
    any other leaf as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(
        placements=[Replicate()] * t.device_mesh.ndim).to_local()


def spec_of(t, mesh) -> tuple:
    """The spec (one entry per dim) of a ``Sharded`` leaf or a ``DTensor``
    over ``mesh``; a plain tensor's is all None (replicated)."""
    if isinstance(t, Sharded):
        return t.spec
    if not is_dtensor(t):
        return (None,) * t.ndim
    from torch.distributed.tensor import Shard
    dims = [[] for _ in range(t.ndim)]
    for axis, pl in zip(mesh.axis_names, t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(axis)
        elif not pl.is_replicate():
            raise ValueError(f"a leaf placed {pl} is neither sharded nor "
                             f"replicated")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)


class Sharded:
    """A parameter as a rank holds it: ``local`` (its block, the tensor
    autograd sees) and ``spec`` (one entry per dim of the full tensor);
    ``shape`` is the full tensor's; ``summed``, the mesh axes an earlier
    gather's transpose already sums its grad over (``unbind``)."""

    __slots__ = ("local", "spec", "shape", "summed")

    def __init__(self, local, spec, shape, summed=()):
        self.local, self.spec, self.shape = local, tuple(spec), tuple(shape)
        self.summed = tuple(summed)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def unbind(self, mesh) -> list:
        """The layers of a stacked leaf.  A leaf the rule table shards on
        its layer axis (a stacked shared expert, read as an expert stack)
        is gathered on it first, every rank taking part."""
        t, summed = self.local, self.summed
        axes = axes_of(self.spec[0])
        if axes:
            t = gather(t, mesh, 0, axes)
            summed += axes
        return [Sharded(layer, self.spec[1:], self.shape[1:], summed)
                for layer in torch.unbind(t, 0)]


def sharded_tree(tree, mesh):
    """A parameter tree with each leaf as ``Sharded``: a ``DTensor`` over
    its local tensor (the object itself: grads taken with respect to it
    are the leaf's), a plain tensor as replicated."""
    if isinstance(tree, dict):
        return {k: sharded_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree
    return Sharded(local(tree), spec_of(tree, mesh), tree.shape)


# torch 2.13 renames the two (the old names warn there); 2.11 has only
# the old ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather_axis(t, dim, mesh, axis):
    n = mesh.shape[axis]
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _ALL_GATHER(out, src, group=mesh.group(axis))
    if _TALLY is not None:
        _TALLY.add("all-gather", _nbytes(out))
    return out.movedim(0, dim)


def _scatter_axis(t, dim, mesh, axis):
    n = mesh.shape[axis]
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    if _TALLY is not None:
        _TALLY.add("reduce-scatter", _nbytes(src))
    return out.movedim(0, dim)


def _all_reduce(t, mesh, axes, op=dist.ReduceOp.SUM):
    for axis in axes:
        if mesh.shape[axis] > 1:
            t = t.contiguous()
            dist.all_reduce(t, op=op, group=mesh.group(axis))
            if _TALLY is not None:
                _TALLY.add("all-reduce", 2 * _nbytes(t))
    return t


def _gather_dims(t, mesh, plan):
    """All-gather ``t`` along each ``(dim, axes)`` of ``plan``; a dim over
    several axes gathers the innermost first, so blocks land in the
    outer-major order of the spec (the reference's and DTensor's)."""
    for dim, axes in plan:
        for axis in reversed(axes):
            t = _gather_axis(t, dim, mesh, axis)
    return t


def _scatter_dims(t, mesh, plan):
    """The transpose of ``_gather_dims``: reduce-scatters of sums, in the
    reverse order."""
    for dim, axes in reversed(plan):
        for axis in axes:
            t = _scatter_axis(t, dim, mesh, axis)
    return t


class _Materialize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, plan, replicated):
        ctx.mesh, ctx.plan, ctx.replicated = mesh, plan, replicated
        out = _gather_dims(t, mesh, plan)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        g = _scatter_dims(g, ctx.mesh, ctx.plan)
        g = _all_reduce(g.clone() if ctx.replicated else g, ctx.mesh,
                        ctx.replicated)
        return g, None, None, None


def _block(t, dim, mesh, axes):
    """This rank's block of ``t`` along ``dim`` over ``axes`` (outer
    axis first), a view."""
    for axis in axes:
        n = mesh.shape[axis]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(axis) * size, size)
    return t


def materialize(w, mesh, keep=None):
    """The leaf ``w`` (``Sharded``, a ``DTensor``, or a plain tensor,
    replicated) as a plain tensor this rank computes with: whole on every
    dim but those of ``keep`` (``{dim: axes}``), which hold this rank's
    block over those axes.  A kept dim the leaf is sharded on exactly so is not gathered;
    any other dim is gathered whole, and a kept one then cut to the block.
    Differentiable: the grad goes back to ``w``'s local tensor summed over
    the ranks that share each entry (module docstring)."""
    keep = {d: axes_of(a) for d, a in (keep or {}).items()}
    spec = spec_of(w, mesh)
    plan, used = [], set(w.summed if isinstance(w, Sharded) else ())
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        used.update(axes)
        if axes and keep.get(dim) != axes:
            plan.append((dim, axes))
    replicated = tuple(a for a in mesh.axis_names
                       if a not in used and mesh.shape[a] > 1)
    t = local(w)
    if plan or replicated:
        t = _Materialize.apply(t, mesh, tuple(plan), replicated)
    for dim, axes in keep.items():
        if axes_of(spec[dim]) != axes:
            t = _block(t, dim, mesh, axes)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        return _gather_dims(t, mesh, plan)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dims(g, ctx.mesh, ctx.plan), None, None


def gather(t, mesh, dim, axes):
    """All-gather ``t`` along ``dim`` over ``axes``: the inverse of
    ``take_block``; its transpose reduce-scatters."""
    axes = tuple(a for a in axes_of(axes) if mesh.shape[a] > 1)
    if not axes:
        return t
    return _Gather.apply(t, mesh, ((dim, axes),))


def take_block(t, mesh, dim, axes):
    """This rank's block of a tensor every rank of ``axes`` holds whole:
    a view, whose transpose pads the grad with zeros."""
    return _block(t, dim, mesh, axes_of(axes))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, transpose):
        ctx.mesh, ctx.axes, ctx.transpose = mesh, axes, transpose
        return _all_reduce(t.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.transpose:
            g = _all_reduce(g.clone(), ctx.mesh, ctx.axes)
        return g, None, None, None


def psum(t, mesh, axes):
    """Sum over ``axes`` (``jax.lax.psum``); the backward sums the
    cotangents the same way, its exact transpose."""
    axes = tuple(a for a in axes_of(axes) if mesh.shape[a] > 1)
    return _Psum.apply(t, mesh, axes, True) if axes else t


def pmax(t, mesh, axes):
    """The max over ``axes`` (``jax.lax.pmax``), into a new tensor; not
    differentiable (a split softmax's running max, which the reference's
    autodiff does not differentiate through either)."""
    axes = tuple(a for a in axes_of(axes) if mesh.shape[a] > 1)
    if not axes:
        return t
    return _all_reduce(t.detach().clone(), mesh, axes, dist.ReduceOp.MAX)


def replicated_sum(t, mesh, axes):
    """Sum over ``axes`` into a value every rank then holds and uses the
    same way (a loss, the pipeline's output): the backward passes each
    rank's cotangent through unchanged, so the value is counted once."""
    axes = tuple(a for a in axes_of(axes) if mesh.shape[a] > 1)
    return _Psum.apply(t, mesh, axes, False) if axes else t


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def scale_grad(t, factor: float):
    """``t`` unchanged, its cotangent times ``factor``."""
    return t if factor == 1 else _ScaleGrad.apply(t, factor)


def _a2a(t, mesh, axis, splits=None):
    if splits is None:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=mesh.group(axis))
    else:
        sent, got = splits
        out = t.new_empty((sum(got), *t.shape[1:]))
        dist.all_to_all_single(out, t.contiguous(), list(got), list(sent),
                               group=mesh.group(axis))
    if _TALLY is not None:
        _TALLY.add("all-to-all", _nbytes(out))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, splits):
        ctx.mesh, ctx.axis, ctx.splits = mesh, axis, splits
        return _a2a(t, mesh, axis, splits)

    @staticmethod
    def backward(ctx, g):
        back = None if ctx.splits is None else ctx.splits[::-1]
        return _a2a(g, ctx.mesh, ctx.axis, back), None, None, None


def all_to_all(t, mesh, axis, *, sent=None, got=None):
    """``jax.lax.all_to_all(t, axis, 0, 0, tiled=False)``: block ``i`` of
    dim 0 (``t.shape[0]`` is the axis size) goes to rank ``i`` of the
    axis, which puts it at this rank's index; equal splits, one
    ``all_to_all_single``.  With ``sent`` and ``got`` (rows of dim 0 per
    rank of the axis, in its order) the splits are those: ``sent[i]``
    rows go to rank ``i``, ``got[i]`` come from it, in rank order.  Its
    transpose is itself, the splits swapped."""
    if mesh.shape[axis] == 1:
        return t
    splits = None if sent is None else (tuple(sent), tuple(got))
    return _AllToAll.apply(t, mesh, axis, splits)


def _shift(t, mesh, axis, step):
    """Send ``t`` to rank ``i + step`` of the axis and receive from ``i -
    step`` (mod its size): one batched isend/irecv pair, so the crossing
    sends of a ring cannot deadlock."""
    n = mesh.shape[axis]
    group = mesh.group(axis)
    ranks = mesh.axis_ranks(axis)
    i = mesh.axis_index(axis)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if _TALLY is not None:
        _TALLY.add("collective-permute", _nbytes(out))
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _shift(t, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.step), None, None, None


def ppermute(t, mesh, axis, step: int = 1):
    """``jax.lax.ppermute`` over the ring ``i -> i + step`` of ``axis``;
    its backward sends the cotangent the other way."""
    if mesh.shape[axis] == 1:
        return t
    return _PPermute.apply(t, mesh, axis, step)
