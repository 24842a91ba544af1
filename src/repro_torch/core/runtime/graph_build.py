"""Dynamic graph construction — the ``knn_graph`` MatOp handler.

Port of ``src/repro/core/runtime/graph_build.py``.  The op consumes the
points/features tensor (plus an optional validity mask for padded
variable-size graphs) and emits the int32 ``(N, k)`` neighbor-index matrix
that downstream ``mm`` ops with ``weight_side="left_knn"`` gather over.
``cuda_knn`` runs the KNN kernel (``kernels/knn.py``), ``torch_knn`` its
plain version; both give the same indices (semantics on ``ref.knn_ref``).
"""
from __future__ import annotations

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.registry import op_kernel, register_op
from repro_torch.kernels import ref
from repro_torch.kernels.knn import knn


@register_op("knn_graph")
def run_knn_graph(op: MatOp, env, params=None):
    select = knn if op_kernel(op) == "cuda_knn" else ref.knn_ref
    x = env[op.inputs[0]]
    mask = env[op.inputs[1]] if op.attrs.get("masked") else None
    return select(x.contiguous(), op.attrs["k"], mask=mask,
                  self_loops=bool(op.attrs.get("self_loops")))
