"""Layer-graph intermediate representation (paper §V-A).

Port of ``src/repro/core/ir.py`` (numpy only, unchanged).

The GCV-Turbo compiler parses a PyTorch model into a computation graph whose
nodes are layers and whose edges are data dependencies. The frontend here is
a small declarative builder with the same layer vocabulary the paper's IR
defines:

  Conv / MP (message passing) / Linear / VIP (vector inner product) /
  DM (data manipulation) / Pool / Norm / Act / + auxiliary (add, concat,
  reshape, softmax, globalpool) — the paper's "Other Layers".

Tensors follow the paper's layout convention (§V-C4): CNN feature maps are
``IFM/OFM`` matrices of shape (channels, h*w) carried as (C, H, W) with the
flattening implicit; GNN node features are (num_nodes, feature) matrices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

LAYER_KINDS = frozenset({
    "input", "conv", "mp", "linear", "vip", "dm", "pool", "norm", "act",
    "add", "mul", "matmul", "concat", "reshape", "softmax", "globalpool",
    "flatten", "knn_graph",
})


@dataclasses.dataclass
class Layer:
    name: str
    kind: str
    inputs: tuple[str, ...]
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    weights: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # filled by shape inference
    out_shape: tuple[int, ...] | None = None

    def __post_init__(self):
        assert self.kind in LAYER_KINDS, self.kind


class Graph:
    """Ordered layer graph (single-static-assignment by layer name)."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.layers: dict[str, Layer] = {}
        self.outputs: list[str] = []
        # Provenance + pass annotations ('frontend': 'builder' | 'tracer',
        # 'fused_layers' after Step 1) — carried, not copied, by passes.
        self.meta: dict[str, Any] = {}

    def add(self, layer: Layer) -> str:
        assert layer.name not in self.layers, f"duplicate layer {layer.name}"
        for inp in layer.inputs:
            assert inp in self.layers, f"{layer.name}: unknown input {inp}"
        self.layers[layer.name] = layer
        return layer.name

    def mark_output(self, *names: str) -> None:
        self.outputs.extend(names)

    def toposorted(self) -> list[Layer]:
        return list(self.layers.values())  # insertion order is topological

    def stats(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for l in self.layers.values():
            counts[l.kind] = counts.get(l.kind, 0) + 1
        return counts


class GraphBuilder:
    """Frontend — the role of the paper's PyTorch input parser."""

    def __init__(self, name: str = "model"):
        self.g = Graph(name)
        self._n = 0
        # Portion tag applied to subsequently-added layers ('cnn'/'gnn'/...);
        # drives the paper's Fig. 2 / Fig. 10 / Table VII breakdowns.
        self.portion = "other"
        orig_add = self.g.add

        def _tagged_add(layer: Layer) -> str:
            default = {"conv": "cnn", "pool": "cnn", "mp": "gnn",
                       "vip": "gnn", "knn_graph": "gnn",
                       "dm": "dm"}.get(layer.kind, self.portion)
            layer.params.setdefault("portion",
                                    self.portion if self.portion != "other"
                                    else default)
            return orig_add(layer)

        self.g.add = _tagged_add  # type: ignore[method-assign]

    def _name(self, prefix: str, name: str | None) -> str:
        if name is not None:
            return name
        self._n += 1
        return f"{prefix}_{self._n}"

    # ---- layer constructors ------------------------------------------------
    def input(self, shape, name=None, dtype="float32"):
        n = self._name("input", name)
        self.g.add(Layer(n, "input", (), {"shape": tuple(shape),
                                          "dtype": dtype},
                         out_shape=tuple(shape)))
        return n

    def conv(self, x, w, b=None, *, stride=1, padding="SAME", groups=1,
             dilation=1, name=None):
        """w: (k1, k2, c_in_per_group, c_out); ``groups`` splits input and
        output channels into that many independent convolutions (XLA's
        ``feature_group_count``), ``dilation`` is atrous kernel dilation.
        Trivial values stay out of the params so existing plans are
        byte-identical."""
        n = self._name("conv", name)
        weights = {"w": np.asarray(w)}
        if b is not None:
            weights["b"] = np.asarray(b)
        params = {"stride": stride, "padding": padding}
        if groups != 1:
            params["groups"] = int(groups)
        d = (dilation, dilation) if isinstance(dilation, int) \
            else tuple(int(v) for v in dilation)
        if d != (1, 1):
            params["dilation"] = d
        self.g.add(Layer(n, "conv", (x,), params, weights))
        return n

    def linear(self, x, w, b=None, name=None):
        """w: (f_in, f_out)."""
        n = self._name("linear", name)
        weights = {"w": np.asarray(w)}
        if b is not None:
            weights["b"] = np.asarray(b)
        self.g.add(Layer(n, "linear", (x,), {}, weights))
        return n

    def mp(self, x, adj=None, *, adj_input=None, adj_coo=None,
           edge_input=None, knn_input=None, reduce="sum", name=None):
        """Message passing: ``rho({e_uv * h_u})``.

        ``adj``: compile-time dense adjacency (small graphs that are model
        structure — b2's label graph, b4's skeleton). ``adj_coo``:
        compile-time (rows, cols, vals, n) COO adjacency for dataset-scale
        graphs (b5, g1-g3) where densifying is infeasible. ``adj_input``:
        runtime dense adjacency tensor name (b1's learned affinity) — forces
        the DDMM mapping. ``edge_input``: runtime per-edge values over static
        COO connectivity (GAT attention weights). ``knn_input``: runtime
        (N, k) neighbor-index tensor name (a ``knn_graph`` layer's output)
        — the whole connectivity is a runtime value, unweighted gather +
        reduce over each row's k neighbors.
        """
        n = self._name("mp", name)
        weights, params = {}, {"reduce": reduce}
        inputs: tuple[str, ...] = (x,)
        if adj is not None:
            weights["adj"] = np.asarray(adj)
        elif adj_coo is not None:
            rows, cols, vals, nv = adj_coo
            weights["coo_rows"] = np.asarray(rows, np.int32)
            weights["coo_cols"] = np.asarray(cols, np.int32)
            weights["coo_vals"] = np.asarray(vals, np.float32)
            params["n"] = int(nv)
            if edge_input is not None:
                params["runtime_edge"] = True
                inputs += (edge_input,)
        elif adj_input is not None:
            params["runtime_adj"] = True
            inputs += (adj_input,)
        elif knn_input is not None:
            params["runtime_knn"] = True
            inputs += (knn_input,)
        else:
            raise ValueError("mp needs adj, adj_coo, adj_input or knn_input")
        self.g.add(Layer(n, "mp", inputs, params, weights))
        return n

    def knn_graph(self, x, *, k, self_loops=False, mask=None, name=None):
        """Dynamic graph construction: ``(N, F)`` points/features -> int32
        ``(N, k)`` nearest-neighbor indices, rebuilt per request (selection
        semantics pinned in ``kernels/knn.py``).  ``mask``: optional
        runtime ``(N,)``/``(N, 1)`` validity input name — zero entries are
        never selected (serving pads variable-size graphs with masked
        nodes).  Feed the result to ``mp(..., knn_input=)``."""
        n = self._name("knn_graph", name)
        params: dict = {"k": int(k)}
        if self_loops:
            params["self_loops"] = True
        inputs: tuple[str, ...] = (x,)
        if mask is not None:
            params["masked"] = True
            inputs += (mask,)
        self.g.add(Layer(n, "knn_graph", inputs, params))
        return n

    def vip(self, x, *, mask=None, edges=None, name=None):
        """Vector inner product layer: e_uv = <h_u, h_v>.

        ``mask``: dense (N, N) sampling matrix (SDDMM). ``edges``: COO
        (rows, cols) — emits per-edge scores of shape (nnz,).
        """
        n = self._name("vip", name)
        weights = {}
        if mask is not None:
            weights["mask"] = np.asarray(mask)
        if edges is not None:
            weights["coo_rows"] = np.asarray(edges[0], np.int32)
            weights["coo_cols"] = np.asarray(edges[1], np.int32)
        self.g.add(Layer(n, "vip", (x,), {}, weights))
        return n

    def dm(self, x, mode, *, name=None, patch=1):
        """Data-manipulation layer (paper §V-C1).

        mode: 'channel_to_node' | 'patch_to_node' | 'node_to_channel'.
        """
        n = self._name("dm", name)
        self.g.add(Layer(n, "dm", (x,), {"mode": mode, "patch": patch}))
        return n

    def pool(self, x, *, window=2, stride=None, kind="max", name=None):
        n = self._name("pool", name)
        self.g.add(Layer(n, "pool", (x,), {"window": window,
                                           "stride": stride or window,
                                           "pool": kind}))
        return n

    def globalpool(self, x, *, kind="avg", name=None):
        n = self._name("globalpool", name)
        self.g.add(Layer(n, "globalpool", (x,), {"pool": kind}))
        return n

    def norm(self, x, *, scale=None, bias=None, mean=None, var=None,
             kind="batch", eps=1e-5, name=None):
        n = self._name("norm", name)
        weights = {}
        for k, v in (("scale", scale), ("bias", bias), ("mean", mean),
                     ("var", var)):
            if v is not None:
                weights[k] = np.asarray(v)
        self.g.add(Layer(n, "norm", (x,), {"norm": kind, "eps": eps},
                         weights))
        return n

    def act(self, x, fn="relu", name=None, *, alpha=None):
        """``alpha``: leaky_relu slope (defaults to the runtime's 0.2)."""
        n = self._name("act", name)
        params = {"fn": fn}
        if alpha is not None:
            params["alpha"] = float(alpha)
        self.g.add(Layer(n, "act", (x,), params))
        return n

    def add(self, x, y, name=None):
        n = self._name("add", name)
        self.g.add(Layer(n, "add", (x, y)))
        return n

    def mul(self, x, y, name=None):
        """Elementwise (broadcasting) product of two runtime tensors —
        e.g. masking padded-node features before a global pool."""
        n = self._name("mul", name)
        self.g.add(Layer(n, "mul", (x, y)))
        return n

    def matmul(self, x, y, name=None):
        """Runtime x runtime matmul (joins two branches, e.g. b2's
        image-feature x label-embedding scores)."""
        n = self._name("matmul", name)
        self.g.add(Layer(n, "matmul", (x, y)))
        return n

    def concat(self, xs, *, axis=0, name=None):
        n = self._name("concat", name)
        self.g.add(Layer(n, "concat", tuple(xs), {"axis": axis}))
        return n

    def reshape(self, x, shape, name=None):
        n = self._name("reshape", name)
        self.g.add(Layer(n, "reshape", (x,), {"shape": tuple(shape)}))
        return n

    def flatten(self, x, name=None):
        n = self._name("flatten", name)
        self.g.add(Layer(n, "flatten", (x,)))
        return n

    def softmax(self, x, *, axis=-1, mask=None, segments=None, name=None):
        """``mask``: dense 0/1 mask (masked softmax). ``segments``:
        (segment_ids, num_segments) for per-neighborhood softmax (GAT)."""
        n = self._name("softmax", name)
        weights = {}
        params: dict = {"axis": axis}
        if mask is not None:
            weights["mask"] = np.asarray(mask)
        if segments is not None:
            weights["segments"] = np.asarray(segments[0], np.int32)
            params["num_segments"] = int(segments[1])
        self.g.add(Layer(n, "softmax", (x,), params, weights))
        return n

    def output(self, *names):
        self.g.mark_output(*names)
        return self.g
