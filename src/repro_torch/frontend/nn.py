"""User-facing op library for the tracing frontend (paper §V-A).

Port of ``src/repro/frontend/nn.py``.  GNN aggregation written in raw torch
dissolves into gather/scatter soup under tracing (``index_add_``,
``scatter_reduce`` over index arithmetic), and the tracer could never
recover the paper's MP/VIP layers from it.  These helpers are therefore
``torch.library.custom_op``s in the ``gcv`` namespace, each with a
``register_fake`` shape function: inside a user model they run their plain
torch bodies below (so a task function also runs directly), and in a traced
aten graph each survives as **one** ``gcv.*`` node that the tracer maps 1:1
onto an ``mp`` / ``vip`` / ``norm`` / ``knn_graph`` / ``softmax`` layer.

This mirrors how the paper's PyTorch frontend recognizes
``MessagePassing`` / ``BatchNorm`` *modules* rather than re-deriving them
from aten ops.  Everything else in a model (conv, matmul, pooling,
activations, reshapes) is plain ``torch``; the tracer understands those.

``batch_norm`` must be this op, not ``F.batch_norm``: the tasks run convs on
per-sample ``(C, H, W)`` maps, where ``F.batch_norm`` would read dim 1 (H)
as the channels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ref import knn_ref

__all__ = ["batch_norm", "knn_graph", "message_passing", "relu",
           "segment_softmax", "vip"]


def _t(a, dtype=None):
    """A tensor from a numpy array, a tensor or a number (no copy where
    torch can share the buffer)."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------------ mp ----
@torch.library.custom_op("gcv::message_passing", mutates_args=())
def _mp(x: torch.Tensor, adj: torch.Tensor, reduce: str) -> torch.Tensor:
    if not adj.is_floating_point():                 # (N, k) neighbor indices
        msg = x[adj.long()]                         # (N, k, F)
        return msg.amax(1) if reduce == "max" else msg.sum(1)
    if reduce == "max":
        gathered = adj[..., None] * x[None]         # (N, N, F)
        valid = (adj != 0)[..., None]
        agg = torch.where(valid, gathered, float("-inf")).amax(1)
        return torch.where(torch.isneginf(agg), x, agg)
    if x.ndim == 3:                                 # (C, T, V) x A^T
        c, t, v = x.shape
        return (x.reshape(c * t, v) @ adj.T).reshape(c, t, v)
    return adj @ x


@_mp.register_fake
def _(x, adj, reduce):
    return torch.empty_like(x)


@torch.library.custom_op("gcv::message_passing_coo", mutates_args=())
def _mp_coo(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
            vals: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    msg = vals[:, None] * x[cols.long()]
    idx = rows.long()[:, None].expand_as(msg)
    if reduce == "max":
        init = torch.full((n, x.shape[1]), float("-inf"), dtype=msg.dtype)
        agg = init.scatter_reduce(0, idx, msg, "amax", include_self=True)
        return torch.where(torch.isneginf(agg), x, agg)
    return torch.zeros((n, x.shape[1]), dtype=msg.dtype).scatter_add(
        0, idx, msg)


@_mp_coo.register_fake
def _(x, rows, cols, vals, n, reduce):
    return x.new_empty((n, x.shape[1]))


def message_passing(adj, x, *, reduce: str = "sum"):
    """GNN aggregation ``rho({e_uv * h_u})`` over a graph.

    ``adj`` is a dense ``(N, N)`` adjacency (a constant for model-structure
    graphs, or a traced tensor for learned affinities, b1), or a COO
    4-tuple ``(rows, cols, vals, num_nodes)`` for dataset-scale
    connectivity.  An *integer* ``(N, k)`` tensor is per-node neighbor
    indices (a ``knn_graph`` output): unweighted gather + reduce over each
    row's k neighbors.  ``x``: node features ``(N, F)`` (dense also takes
    the ST-GCN ``(C, T, V)`` layout).  ``reduce``: ``'sum'`` or ``'max'``.
    """
    assert reduce in ("sum", "max"), reduce
    if isinstance(adj, tuple):
        rows, cols, vals, n = adj
        return _mp_coo(x, _t(rows, torch.int32), _t(cols, torch.int32),
                       _t(vals, torch.float32), int(n), reduce)
    a = _t(adj)
    if not a.is_floating_point():
        assert a.ndim == 2, f"neighbor indices must be (N, k), got {a.shape}"
    return _mp(x, a, reduce)


# ----------------------------------------------------------- knn graph ----
@torch.library.custom_op("gcv::knn_graph", mutates_args=())
def _knn_graph(x: torch.Tensor, mask: Optional[torch.Tensor], k: int,
               self_loops: bool) -> torch.Tensor:
    return knn_ref(x, k, mask=mask, self_loops=self_loops)


@_knn_graph.register_fake
def _(x, mask, k, self_loops):
    return x.new_empty((x.shape[0], k), dtype=torch.int32)


def knn_graph(x, *, k: int, self_loops: bool = False, mask=None):
    """Dynamic graph construction: ``(N, F)`` points -> int32 ``(N, k)``
    nearest-neighbor indices under squared-L2 distance, rebuilt per input
    (the selection semantics of ``kernels/ref.knn_ref``).  ``mask``: an
    optional ``(N,)``/``(N, 1)`` validity tensor; zero entries are never
    selected.  Feed the result to ``message_passing``.  The raw spelling of
    the same idiom (``|xi|^2 + |xj|^2 - 2 xi.xj`` consumed by
    ``torch.topk(-d, k)`` or a stable ``argsort(d)[:, 1:k+1]``) is also
    recognized by the tracer; this op is the explicit, mask-capable
    form."""
    return _knn_graph(x, None if mask is None else _t(mask), int(k),
                      bool(self_loops))


# ----------------------------------------------------------------- vip ----
@torch.library.custom_op("gcv::vip", mutates_args=())
def _vip(x: torch.Tensor, mask: Optional[torch.Tensor],
         rows: Optional[torch.Tensor],
         cols: Optional[torch.Tensor]) -> torch.Tensor:
    if rows is not None:
        return (x[rows.long()] * x[cols.long()]).sum(-1)
    if mask is not None:
        return (x @ x.T) * mask
    return x @ x.T


@_vip.register_fake
def _(x, mask, rows, cols):
    if rows is not None:
        return x.new_empty((rows.shape[0],))
    return x.new_empty((x.shape[0], x.shape[0]))


def vip(x, *, mask=None, edges=None):
    """Vector-inner-product layer ``e_uv = <h_u, h_v>``.

    Dense (default): the full ``(N, N)`` score matrix.  ``mask``: a dense
    0/1 sampling matrix (SDDMM).  ``edges``: COO ``(rows, cols)``, per-edge
    scores of shape ``(nnz,)``.
    """
    if edges is not None:
        return _vip(x, None, _t(edges[0], torch.int32),
                    _t(edges[1], torch.int32))
    return _vip(x, None if mask is None else _t(mask, torch.float32),
                None, None)


# ---------------------------------------------------------------- norm ----
@torch.library.custom_op("gcv::batch_norm", mutates_args=())
def _batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                mean: torch.Tensor, var: torch.Tensor,
                eps: float) -> torch.Tensor:
    shape = {2: (1, -1), 3: (-1, 1, 1), 4: (1, -1, 1, 1)}[x.ndim]
    return ((x - mean.reshape(shape)) * scale.reshape(shape)
            * torch.rsqrt(var.reshape(shape) + eps) + bias.reshape(shape))


@_batch_norm.register_fake
def _(x, scale, bias, mean, var, eps):
    return torch.empty_like(x)


def batch_norm(x, scale, bias, mean, var, *, eps: float = 1e-5):
    """Inference batch norm with recorded statistics over the channel axis
    of an ``(N, F)``, ``(C, H, W)`` or ``(N, C, H, W)`` tensor; survives
    tracing as a ``norm`` layer, so Step-1 fusion folds it into the
    producing conv/linear as it does for builder graphs."""
    return _batch_norm(x, _t(scale), _t(bias), _t(mean), _t(var),
                       float(eps))


# ----------------------------------------------------- segment softmax ----
@torch.library.custom_op("gcv::segment_softmax", mutates_args=())
def _segment_softmax(x: torch.Tensor, seg: torch.Tensor,
                     n: int) -> torch.Tensor:
    idx = seg.long()
    m = torch.full((n,), float("-inf"), dtype=x.dtype).scatter_reduce(
        0, idx, x, "amax", include_self=True)
    e = torch.exp(x - m[idx])
    s = torch.zeros(n, dtype=x.dtype).scatter_add(0, idx, e)
    return e / torch.where(s[idx] == 0, 1.0, s[idx])


@_segment_softmax.register_fake
def _(x, seg, n):
    return torch.empty_like(x)


def segment_softmax(x, segment_ids, num_segments: int):
    """Per-neighborhood softmax over segment-grouped scores (GAT attention:
    normalize each destination node's incoming edge scores).  ``x``:
    per-edge values ``(nnz,)``; ``segment_ids``: the static destination of
    each edge."""
    return _segment_softmax(x, _t(segment_ids, torch.int32),
                            int(num_segments))


# ---------------------------------------------------- activations etc. ----
def relu(x):
    """``max(x, 0)``; ``torch.relu`` and ``F.relu`` trace the same way."""
    return torch.relu(x)

