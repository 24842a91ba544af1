"""Synthetic graph generators matching the paper's workload statistics.

Port of ``src/repro/gnncv/graphs.py`` (numpy/stdlib only; imports rewritten).

Latency (the paper's only metric) depends on graph *shape and sparsity*, not
edge identity, so benchmarks use synthetic graphs with the published
|V| / |E| / feature dimensions (paper Table IV + the public dataset stats of
Table IX/XII). All generators are deterministic in ``seed``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    num_nodes: int
    num_edges: int
    feat_dim: int
    num_classes: int


# Citation / recommendation datasets used in Tables IX & XII.
CORA = GraphSpec("cora", 2708, 10556, 1433, 7)
CITESEER = GraphSpec("citeseer", 3327, 9104, 3703, 6)
PUBMED = GraphSpec("pubmed", 19717, 88648, 500, 3)
FLICKR = GraphSpec("flickr", 89250, 899756, 500, 7)
REDDIT = GraphSpec("reddit", 232965, 11606919, 602, 41)
YELP = GraphSpec("yelp", 716847, 6977410, 300, 100)
AMAZON = GraphSpec("amazon2m", 1598960, 132169734, 100, 47)

DATASETS = {g.name: g for g in
            (CORA, CITESEER, PUBMED, FLICKR, REDDIT, YELP, AMAZON)}


def random_coo(n: int, num_edges: int, *, seed: int = 0,
               self_loops: bool = True, sym_norm: bool = True):
    """Random COO graph with GCN D^-1/2 (A+I) D^-1/2 normalization."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, num_edges, dtype=np.int64)
    cols = rng.integers(0, n, num_edges, dtype=np.int64)
    if self_loops:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
    vals = np.ones(rows.size, np.float32)
    if sym_norm:
        deg = np.zeros(n, np.float32)
        np.add.at(deg, rows, 1.0)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
        vals = dinv[rows] * dinv[cols]
    return (rows.astype(np.int32), cols.astype(np.int32), vals, n)


def grid_coo(h: int, w: int, *, neighbors: int = 8, sym_norm: bool = True):
    """H x W pixel grid, 8-neighborhood — b5's 128x128 SAR graph
    (16384 vertices, 131072 edges per paper Table IV)."""
    n = h * w
    offs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
            (1, 1)][:neighbors]
    rows, cols = [], []
    yy, xx = np.mgrid[0:h, 0:w]
    for dy, dx in offs:
        ny, nx = yy + dy, xx + dx
        ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        rows.append((yy * w + xx)[ok].ravel())
        cols.append((ny * w + nx)[ok].ravel())
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.ones(rows.size, np.float32)
    if sym_norm:
        deg = np.zeros(n, np.float32)
        np.add.at(deg, rows, 1.0)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
        vals = dinv[rows] * dinv[cols]
    return (rows.astype(np.int32), cols.astype(np.int32), vals, n)


def knn_indices(points: np.ndarray, k: int, *, self_loops: bool = False,
                mask: np.ndarray | None = None) -> np.ndarray:
    """Numpy reference oracle for k-nearest-neighbor selection.

    Implements the pinned KNN semantics (``repro.kernels.knn`` docstring —
    every realization, including this oracle, must agree):

      * neighbors are the ``k`` *smallest* squared-L2 distances;
      * ties break toward the **lower candidate index** (stable argsort);
      * a point is never its own neighbor unless ``self_loops=True``;
      * candidates with ``mask == 0`` are never selected (their distance
        is +inf); rows with ``mask == 0`` still emit indices — callers
        mask the downstream features, not the index matrix.

    Returns an int32 ``(n, k)`` neighbor-index matrix (ELL layout: row i
    aggregates from ``points[idx[i]]``).
    """
    pts = np.asarray(points, dtype=np.float64)   # exact oracle: fp64 dists
    n = pts.shape[0]
    assert 1 <= k <= n, f"k={k} out of range for {n} points"
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    if not self_loops:
        np.fill_diagonal(d, np.inf)
    if mask is not None:
        m = np.asarray(mask, dtype=np.float64).reshape(-1)
        d = np.where(m[None, :] > 0, d, np.inf)
    return np.argsort(d, axis=1, kind="stable")[:, :k].astype(np.int32)


def knn_coo(n: int, k: int, *, seed: int = 0, points=None,
            self_loops: bool = False):
    """k-NN connectivity (b6 point clouds: 1024 pts, 10k-30k edges).

    With ``points`` (an ``(n, dim)`` array), the graph is the *true*
    geometric KNN of those coordinates via the ``knn_indices`` oracle;
    ``n`` must match ``len(points)``.  Without ``points`` the historic
    behavior is kept: random neighbors with the published edge count
    (latency-only benchmarks never cared about edge identity)."""
    rows = np.repeat(np.arange(n, dtype=np.int32), k)
    if points is not None:
        points = np.asarray(points)
        assert points.shape[0] == n, \
            f"n={n} does not match {points.shape[0]} points"
        cols = knn_indices(points, k, self_loops=self_loops).reshape(-1)
    else:
        rng = np.random.default_rng(seed)
        cols = rng.integers(0, n, n * k).astype(np.int32)
    vals = np.ones(rows.size, np.float32)
    return (rows, cols, vals, n)


def skeleton_adjacency(num_joints: int = 25) -> np.ndarray:
    """NTU RGB+D 25-joint skeleton (b4), symmetric-normalized dense 25x25.

    Bone list follows the NTU convention; paper Table IV: 25 vertices,
    75-125 edges (here: 24 bones x2 + self-loops = 73)."""
    bones = [(0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4), (6, 5),
             (7, 6), (8, 20), (9, 8), (10, 9), (11, 10), (12, 0), (13, 12),
             (14, 13), (15, 14), (16, 0), (17, 16), (18, 17), (19, 18),
             (21, 22), (22, 7), (23, 24), (24, 11)]
    a = np.eye(num_joints, dtype=np.float32)
    for i, j in bones:
        if i < num_joints and j < num_joints:
            a[i, j] = a[j, i] = 1.0
    deg = a.sum(1)
    dinv = 1.0 / np.sqrt(deg)
    return (a * dinv[:, None] * dinv[None, :]).astype(np.float32)


def label_graph(n_labels: int = 80, *, seed: int = 0,
                density: float = 1.0) -> np.ndarray:
    """b2's label co-occurrence graph (ML-GCN): 80 nodes, 6400 edges
    (fully dense per paper Table IV), row-normalized."""
    rng = np.random.default_rng(seed)
    a = rng.random((n_labels, n_labels)).astype(np.float32)
    if density < 1.0:
        a = a * (rng.random((n_labels, n_labels)) < density)
    a = a + np.eye(n_labels, dtype=np.float32)
    return (a / a.sum(1, keepdims=True)).astype(np.float32)
