"""Trace-provenance linter: which aten nodes produced each layer.

Port of ``src/repro/frontend/lint.py``.  Tracing shreds a model into aten
soup and the canonicalizer reassembles it; when a model mis-traces (a
pattern almost-matches and a layer comes out as the wrong kind, or an
``UnsupportedOpError`` points at an op the user never wrote), the first
question is *which aten nodes did this layer come from?*  Every
``TraceNode`` records the aten nodes it was lifted from (op and result
shape, ``aten.mm.default:(196, 192)``), pattern rewrites fold their
partners' provenance into the surviving node, and ``_emit`` carries the
result in ``graph.meta["aten_nodes"]`` — ``lint`` renders it per layer.
"""
from __future__ import annotations

from repro_torch.core.ir import Graph


def lint(graph: Graph) -> str:
    """Human-readable provenance report for a traced ``Graph``.

    One line per layer: name, kind, and the aten nodes (op + result shape)
    the layer was recovered from.  Layers assembled from several nodes (a
    folded bias add, a softmax chain, a DM reshape/transpose pair) list
    every member, so a mis-trace shows exactly which aten nodes landed in
    the wrong layer.  For declarative ``GraphBuilder`` graphs there is no
    aten graph to report and ``lint`` says so instead of guessing.
    """
    meta = getattr(graph, "meta", None) or {}
    if meta.get("frontend") != "tracer":
        return (f"graph {graph.name!r}: built via the declarative "
                f"GraphBuilder (frontend={meta.get('frontend', 'builder')!r})"
                f" — no aten provenance to report")
    aten_nodes = meta.get("aten_nodes", {})
    lines = [f"graph {graph.name!r}: {len(graph.layers)} layers recovered "
             f"from aten nodes"]
    for layer in graph.toposorted():
        if layer.kind == "input":
            detail = "model input"
        else:
            srcs = aten_nodes.get(layer.name, ())
            detail = ", ".join(srcs) if srcs else \
                "(no recorded aten nodes — synthesized by canonicalization)"
        lines.append(f"  {layer.name:<20} {layer.kind:<10} <- {detail}")
    return "\n".join(lines)
