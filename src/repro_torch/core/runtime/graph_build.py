"""Dynamic graph construction (``knn_graph``) — port of
``src/repro/core/runtime/graph_build.py``, not on b4's path yet."""
from __future__ import annotations

from repro_torch.core.runtime.registry import not_ported, register_op

register_op("knn_graph")(not_ported(
    "dynamic KNN graph construction",
    "ROADMAP queue 1 item 7, queue 2 item 5"))
