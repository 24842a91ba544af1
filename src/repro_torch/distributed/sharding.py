"""Sharding rules: parameter/activation/cache partition specs per arch.

Port of ``src/repro/distributed/sharding.py``.  This is the LM-scale
analogue of the paper's *data-layout-centric mapping* (§V-C4): the layout
of every tensor is chosen once, at compile time, so that layer-to-layer
transitions never materialize a standalone re-layout.

Scheme (train/prefill): FSDP+TP.  Every 2-D weight is sharded on its
d_model dim over the fsdp axes and on its "wide" dim over the model axis;
MoE experts are additionally expert-sharded over model (EP).  Batch is
sharded over the dp axes.  Decode: KV caches are sequence-sharded over
model (flash-decode) with batch over dp; ``seq_block`` gives a rank its
block of that sequence, which the model code reads.

A dim is sharded only if divisible by the axis size — otherwise the rule
degrades to replication on that dim (recorded by ``explain()``).

A spec is a tuple with one entry per dim, as ``tuple(PartitionSpec(...))``
reads in the reference: an axis name, a tuple of names, or None
(replicated).  A one-name tuple is written as the name, as
``PartitionSpec`` normalizes it.  The rules are pure functions of shapes
and a mesh's axis sizes (``mesh.shape[axis]``): any object with a
``shape`` mapping serves, ``launch.mesh.Mesh`` included.  Trees are the
port's nested dicts; a leaf is a shape tuple (``models.weights
.param_shapes(cfg)``, which allocates nothing) or anything with a
``.shape`` (tensors; ``init_caches(..., device="meta")`` gives a cache
tree without allocating).

``shardings`` binds a spec tree to a mesh bound to ``torch.distributed``
(``launch.mesh.make_process_mesh``): a ``NamedSharding`` per leaf, whose
``placements`` are the ``DTensor`` placements of the spec (``Shard(dim)``
on each mesh dim a tensor dim is split over, ``Replicate()`` on the
others).  ``device_put`` is the counterpart of ``jax.device_put(tree,
shardings)``: every rank holds the full tensors and keeps its own block
of each as a ``DTensor``, the block a spec of several axes cuts outer axis
first, as the reference's layout does.  A dim ``_fit`` left unsharded is
replicated, as the rule table says; ``explain()``'s bytes per device are
the bytes of each rank's block.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

__all__ = ["param_spec", "param_specs", "batch_specs", "cache_specs",
           "SeqBlock", "seq_block", "NamedSharding", "shardings",
           "device_put", "explain"]


def P(*entries) -> tuple:
    """A spec from its entries, a one-name tuple written as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def _fit(mesh, dim, axes):
    """axes if dim divisible by their product else None."""
    return axes if axes and dim % _axsize(mesh, axes) == 0 else None


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map_with_path(fn, tree, *others, path=()):
    """``fn(path, leaf, *other_leaves)`` over nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(o[k] for o in others),
                                  path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *others)


# ------------------------------------------------------------------ rules --
# (regex on "/"-joined param path) -> (shard_in_dim, shard_out_dim) roles.
# Interpreted for the *trailing* dims of the array (leading stack dims are
# replicated). "in" = the d_model-ish dim sharded over fsdp, "out" = the
# wide dim sharded over model.
_W_IN_OUT = re.compile(
    r"(wq|wk|wv|wi|wg|up|in_proj|wdq|wuq|wdkv|wukv|head|w)$")
_W_OUT_IN = re.compile(r"(wo|out_proj|down|out)$")
_EMBED = re.compile(r"embed$")
_ROUTER = re.compile(r"router$")
_CONV = re.compile(r"conv_w$")
_BIAS = re.compile(r"(bq|bk|bv|conv_b|skip|if_bias)$")
_REC = re.compile(r"r$")


def param_spec(path: str, shape, mesh, *, fsdp=("data",), model="model"):
    """The spec of one parameter. ``path`` is its "/"-joined key path."""
    nd = len(shape)
    leaf = path.split("/")[-1]

    def pad(spec_tail):
        return P(*([None] * (nd - len(spec_tail)) + list(spec_tail)))

    if _EMBED.search(path):                       # (V, d)
        return P(_fit(mesh, shape[0], model), _fit(mesh, shape[1], fsdp))
    if _ROUTER.search(leaf):                      # (d, E) — replicated E
        return pad([_fit(mesh, shape[-2], fsdp), None])
    if _CONV.search(leaf):                        # (K, C)
        return pad([None, _fit(mesh, shape[-1], model)])
    if _BIAS.search(leaf):
        return pad([_fit(mesh, shape[-1], model)])
    if _REC.fullmatch(leaf):                      # sLSTM (H, hd, 4hd)
        return pad([None, None, None])
    # MoE expert stacks: .../moe/(wi|wg|wo) with 3 trailing dims (E, a, b)
    if "/moe/" in path and nd >= 3 and leaf in ("wi", "wg", "wo"):
        e, a, b = shape[-3], shape[-2], shape[-1]
        e_ax = _fit(mesh, e, model)
        if e_ax is None:
            # small-E arch (grok): EP impossible — dense-TP instead, model
            # axis shards the expert d_ff
            if leaf == "wo":                      # (E, ff, d)
                return pad([None, _fit(mesh, a, model),
                            _fit(mesh, b, fsdp)])
            return pad([None, _fit(mesh, a, fsdp), _fit(mesh, b, model)])
        if leaf == "wo":                          # (E, ff, d)
            return pad([e_ax, None, _fit(mesh, b, fsdp)])
        return pad([e_ax, _fit(mesh, a, fsdp), None])
    if _W_OUT_IN.search(leaf) and nd >= 2:        # (wide, d)
        return pad([_fit(mesh, shape[-2], model), _fit(mesh, shape[-1],
                                                       fsdp)])
    if _W_IN_OUT.search(leaf) and nd >= 2:        # (d, wide)
        return pad([_fit(mesh, shape[-2], fsdp), _fit(mesh, shape[-1],
                                                      model)])
    return P()                                    # norms, scalars, gates


def param_specs(shapes, mesh, *, fsdp=("data",), model="model"):
    """Tree of specs for a parameter tree (shapes or tensors)."""
    return _map_with_path(
        lambda path, leaf: param_spec("/".join(map(str, path)), _shape(leaf),
                                      mesh, fsdp=fsdp, model=model),
        shapes)


# ------------------------------------------------------------ activations --
def batch_specs(shape_kind: str, mesh, *, dp=("data",), model="model"):
    """Specs for the input batch of a given shape kind."""
    if shape_kind == "train":
        return {"tokens": P(dp, None), "labels": P(dp, None),
                "embeds": P(dp, None, None)}
    if shape_kind == "prefill":
        return {"tokens": P(dp, None), "embeds": P(dp, None, None)}
    if shape_kind == "decode":
        return {"tokens": P(dp)}
    raise ValueError(shape_kind)


def cache_specs(cache_shapes, mesh, *, dp=("data",), model="model"):
    """Decode-cache specs: batch over dp, sequence over model (the
    sequence-sharded flash-decode layout); recurrent states: heads over
    model when divisible, else replicated.

    Cache trees are ``{stage_i: {leaf: (L, B, S, ...)}}`` — the leading L
    stack dim replicated.  For B == 1 the sequence dim is sharded over
    (dp + model) combined so every device contributes memory.
    """
    def visit(path, leaf):
        name = str(path[-1])
        shape = _shape(leaf)
        nd = len(shape)
        bspec = _fit(mesh, shape[1], dp)
        if name in ("k", "v", "ckv", "kr"):       # (L, B, S, ...)
            seq_axes = model if bspec else tuple(
                ([dp] if isinstance(dp, str) else list(dp)) + [model])
            sspec = _fit(mesh, shape[2], seq_axes)
            return P(None, bspec, sspec, *([None] * (nd - 3)))
        if name == "ssm":                         # (L, B, H, N, P)
            return P(None, bspec, _fit(mesh, shape[2], model), None, None)
        if name == "conv":                        # (L, B, K-1, C)
            return P(None, bspec, None, _fit(mesh, shape[3], model))
        if name in ("C",):                        # mlstm (L, B, H, P, P)
            return P(None, bspec, _fit(mesh, shape[2], model), None, None)
        if name in ("n", "m", "c", "h"):
            return P(None, bspec, _fit(mesh, shape[2], model),
                     *([None] * (nd - 3)))
        return P(*([None] * nd))

    return _map_with_path(visit, cache_shapes)


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """A rank's block ``[lo, hi)`` of a decode cache's sequence and the
    mesh axes the sequence is cut over (outer first; ``()`` where it is
    whole)."""
    axes: tuple
    lo: int
    hi: int


def seq_block(mesh, batch: int, max_len: int, *, dp=("data",),
              model="model") -> SeqBlock:
    """This rank's block of the sequence of a ``k``/``v``/``ckv``/``kr``
    cache leaf of a global ``batch`` and ``max_len`` positions, by
    ``cache_specs``' rule: over ``model`` where the batch divides over
    ``dp``, over ``dp + model`` where it does not, whole where
    ``max_len`` does not divide over those axes (or they hold one
    rank).  ``mesh`` must be bound (``axis_index``)."""
    entry = cache_specs({"k": (1, batch, max_len, 1, 1)}, mesh, dp=dp,
                        model=model)["k"][2]
    axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
    if _axsize(mesh, axes) == 1:
        return SeqBlock((), 0, max_len)
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + mesh.axis_index(a)
    size = max_len // _axsize(mesh, axes)
    return SeqBlock(axes, index * size, (index + 1) * size)


class NamedSharding:
    """A spec bound to a process mesh: the port's
    ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec):
        if getattr(mesh, "device_mesh", None) is None:
            raise ValueError("shardings need a mesh bound to "
                             "torch.distributed (launch.mesh"
                             ".make_process_mesh)")
        self.mesh, self.spec = mesh, tuple(spec)
        names = mesh.axis_names
        for entry in self.spec:
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if any(a not in names for a in axes):
                raise ValueError(f"spec {self.spec} names an axis the mesh "
                                 f"{names} lacks")
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {self.spec}: a dim's axes must "
                                 f"follow the mesh's order {names}")

    @property
    def placements(self) -> list:
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.mesh.axis_names]
        for dim, entry in enumerate(self.spec):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                out[self.mesh.axis_names.index(a)] = Shard(dim)
        return out

    def block(self, full):
        """This rank's block of the full tensor ``full`` (a view)."""
        for dim, entry in enumerate(self.spec):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                n = self.mesh.shape[a]
                if full.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(full.shape)} "
                                     f"does not divide over {a} ({n})")
                size = full.shape[dim] // n
                full = full.narrow(dim, self.mesh.axis_index(a) * size, size)
        return full

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec}, axes={self.mesh.axis_names})"


def shardings(spec_tree, mesh):
    """A ``NamedSharding`` per spec of ``spec_tree`` over ``mesh``."""
    return _map_with_path(lambda _, spec: NamedSharding(mesh, spec),
                          spec_tree)


def place(full, sharding: NamedSharding):
    """One tensor as a ``DTensor`` holding this rank's block of it (a copy
    of its own, on the rank's device)."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    block = sharding.block(full).to(mesh.device).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(block, mesh.device_mesh, sharding.placements,
                              run_check=False)


def device_put(tree, sharding_tree):
    """``jax.device_put(tree, shardings)``: each leaf of ``tree`` (the
    full tensor, the same on every rank) placed by its sharding, a
    ``DTensor`` of this rank's block; a leaf whose sharding is missing or
    None is returned as it is."""
    if isinstance(tree, dict):
        return {k: device_put(v, (sharding_tree or {}).get(k))
                for k, v in tree.items()}
    if sharding_tree is None:
        return tree
    return place(tree, sharding_tree)


def explain(shapes, specs, mesh, dtypes=None):
    """Human-readable table: ``(path, shape, str(spec), bytes/device)`` per
    leaf.  A leaf's dtype comes from the leaf (a tensor) or from
    ``dtypes``, a tree of ``torch.dtype``s (``models.weights
    .param_dtypes``) beside a tree of shapes."""
    rows = []

    def visit(path, leaf, spec, dtype=None):
        dtype = dtype if dtype is not None else leaf.dtype
        n_shards = 1
        for ax in spec:
            if ax is not None:
                n_shards *= _axsize(mesh, ax)
        shape = _shape(leaf)
        nbytes = math.prod(shape) * dtype.itemsize
        rows.append(("/".join(map(str, path)), shape, str(spec),
                     nbytes / n_shards))

    if dtypes is None:
        _map_with_path(visit, shapes, specs)
    else:
        _map_with_path(visit, shapes, specs, dtypes)
    return rows
