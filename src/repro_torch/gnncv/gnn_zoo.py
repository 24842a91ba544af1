"""GNN model zoo (paper scope 2: g1 GCN, g2 GraphSAGE, g3 GAT) on the
citation/recommendation graphs of Tables IX & XII, as GCV-Turbo graphs.

Port of ``src/repro/gnncv/gnn_zoo.py`` (numpy/stdlib only; imports
rewritten).  Weights are drawn with numpy from ``seed`` in the reference's
order, so the port's plans carry the reference's weights bit for bit.

All models use the 2-layer configurations of the papers' standard setups.
GAT uses the scaled-dot-product edge-attention variant (single head): the
per-edge score is a VIP layer (SDDMM on COO edges), normalized by a
segment softmax, then applied as runtime edge weights in the MP layer —
exactly the SDDMM -> softmax -> SpDMM dataflow of the paper's primitive set.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import GraphBuilder
from repro_torch.gnncv.graphs import DATASETS, GraphSpec, random_coo


def _lin(b, x, rng, fin, fout, act=None, bias=True):
    w = (rng.standard_normal((fin, fout)) *
         np.sqrt(1.0 / fin)).astype(np.float32)
    h = b.linear(x, w, b=np.zeros(fout, np.float32) if bias else None)
    if act:
        h = b.act(h, act)
    return h


def _spec(dataset) -> GraphSpec:
    return DATASETS[dataset] if isinstance(dataset, str) else dataset


def gcn(dataset="cora", *, hidden: int = 16, seed: int = 0):
    """Kipf & Welling 2-layer GCN: A_norm (A_norm X W1)relu W2."""
    spec = _spec(dataset)
    rng = np.random.default_rng(seed)
    coo = random_coo(spec.num_nodes, spec.num_edges, seed=seed)
    b = GraphBuilder(f"gcn_{spec.name}")
    b.portion = "gnn"
    x = b.input((spec.num_nodes, spec.feat_dim), name="features")
    h = _lin(b, x, rng, spec.feat_dim, hidden)
    h = b.mp(h, adj_coo=coo)
    h = b.act(h, "relu")
    h = _lin(b, h, rng, hidden, spec.num_classes)
    h = b.mp(h, adj_coo=coo)
    return b.output(h)


def graphsage(dataset="cora", *, hidden: int = 64, seed: int = 0):
    """2-layer GraphSAGE-mean: h' = relu(W_self h + W_neigh mean_N(h))."""
    spec = _spec(dataset)
    rng = np.random.default_rng(seed)
    rows, cols, _, n = random_coo(spec.num_nodes, spec.num_edges, seed=seed,
                                  sym_norm=False)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, rows, 1.0)
    mean_vals = (1.0 / np.maximum(deg, 1.0))[rows]
    coo = (rows, cols, mean_vals, n)
    b = GraphBuilder(f"sage_{spec.name}")
    b.portion = "gnn"
    x = b.input((spec.num_nodes, spec.feat_dim), name="features")
    h = x
    fin = spec.feat_dim
    for li, fout in enumerate((hidden, spec.num_classes)):
        self_h = _lin(b, h, rng, fin, fout)
        neigh = b.mp(h, adj_coo=coo, name=f"agg{li}")
        neigh_h = _lin(b, neigh, rng, fin, fout, bias=False)
        h = b.add(self_h, neigh_h)
        if li == 0:
            h = b.act(h, "relu")
        fin = fout
    return b.output(h)


def gat(dataset="cora", *, hidden: int = 8, seed: int = 0):
    """2-layer single-head GAT (dot-product attention variant):
    e = leaky_relu(<Wh_u, Wh_v>) on edges -> segment softmax -> weighted MP.
    """
    spec = _spec(dataset)
    rng = np.random.default_rng(seed)
    rows, cols, _, n = random_coo(spec.num_nodes, spec.num_edges, seed=seed,
                                  sym_norm=False)
    b = GraphBuilder(f"gat_{spec.name}")
    b.portion = "gnn"
    x = b.input((spec.num_nodes, spec.feat_dim), name="features")
    h = x
    fin = spec.feat_dim
    for li, fout in enumerate((hidden, spec.num_classes)):
        h = _lin(b, h, rng, fin, fout, bias=False)
        e = b.vip(h, edges=(rows, cols), name=f"scores{li}")
        e = b.act(e, "leaky_relu")
        alpha = b.softmax(e, segments=(rows, n), name=f"alpha{li}")
        h = b.mp(h, adj_coo=(rows, cols, np.ones(rows.size, np.float32), n),
                 edge_input=alpha, name=f"attnmp{li}")
        if li == 0:
            h = b.act(h, "relu")
        fin = fout
    return b.output(h)


GNN_ZOO = {"g1_gcn": gcn, "g2_sage": graphsage, "g3_gat": gat}
