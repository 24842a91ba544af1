"""The six GNN-based CV tasks (paper scope 3, Table III/IV) as layer graphs.

Port of ``src/repro/gnncv/tasks.py`` (numpy/stdlib only; imports rewritten).

  b1  few-shot image classification   (Omniglot)     CNN + GNN  [3]
  b2  multi-label image classification (MS-COCO)     CNN + GNN  [4]
  b3  image segmentation               (Cityscapes)  CNN + GNN  [5] r50/r101
  b4  skeleton-based action recognition (NTU RGB+D)  CNN + GNN  [6]
  b5  SAR automatic target classification (MSTAR)    CNN + GNN  [31]
  b6  point cloud classification       (ModelNet40)  GNN        [10]

plus ``b6-dyn``, b6 with its KNN graph built per request
(``build_dynamic_task``).

Models are reconstructions from the cited task papers sized to match the
paper's workload statistics (Table IV graph shapes, Table VI model sizes,
Fig. 2 CNN/GNN workload mix). Weights are random — the paper's evaluation is
latency-only. Every builder takes ``scale``-style kwargs so tests run reduced
variants; defaults reproduce the paper's workload shapes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import GraphBuilder
from repro_torch.gnncv.cnn_zoo import (_conv, _fc, _fc_w,
                                       add_resnet_backbone)
from repro_torch.gnncv.graphs import (grid_coo, knn_coo, label_graph,
                                      skeleton_adjacency)


def _lin_w(rng, fin, fout):
    return (rng.standard_normal((fin, fout)) *
            np.sqrt(1.0 / fin)).astype(np.float32)


def _lin(b, x, rng, fin, fout, act=None, bias=True):
    w = _lin_w(rng, fin, fout)
    h = b.linear(x, w, b=np.zeros(fout, np.float32) if bias else None)
    if act:
        h = b.act(h, act)
    return h


# -------------------------------------------------------- b1: few-shot ----
def b1_fewshot(*, n_way: int = 5, n_shot: int = 5, input_hw: int = 28,
               embed_ch: int = 64, gnn_dim: int = 400, gnn_blocks: int = 3,
               seed: int = 0):
    """Garcia & Bruna few-shot GNN: conv-4 embedding per image, then GNN
    blocks that learn a dense affinity (VIP + softmax -> runtime-adjacency
    MP). Nodes = support+query images (26-100); affinity is runtime-valued,
    so Step 4 maps its MP to DDMM (paper: b1 gets only 5.2% from sparsity).
    """
    rng = np.random.default_rng(seed)
    n_nodes = n_way * n_shot + 1
    b = GraphBuilder("b1_fewshot")
    b.portion = "cnn"
    x = b.input((n_nodes, 1, input_hw, input_hw), name="images")
    h = _conv(b, x, rng, 1, embed_ch, 3)
    h = b.pool(h, window=2, stride=2)
    h = _conv(b, h, rng, embed_ch, embed_ch, 3)
    h = b.pool(h, window=2, stride=2)
    h = _conv(b, h, rng, embed_ch, embed_ch, 3)
    h = _conv(b, h, rng, embed_ch, embed_ch, 3)
    h = b.globalpool(h, kind="avg")            # (N, embed_ch)
    b.portion = "gnn"
    h = _lin(b, h, rng, embed_ch, gnn_dim, act="relu")
    for blk in range(gnn_blocks):
        aff = b.vip(h, name=f"affinity{blk}")  # dense runtime (N, N)
        aff = b.softmax(aff, axis=-1, name=f"aff_sm{blk}")
        agg = b.mp(h, adj_input=aff, name=f"gmp{blk}")
        cat = b.concat([h, agg], axis=1)
        h = _lin(b, cat, rng, 2 * gnn_dim, gnn_dim, act="relu")
    logits = _lin(b, h, rng, gnn_dim, n_way)
    return b.output(logits)


# ---------------------------------------------------------- b2: ML-GCN ----
def b2_mlgcn(*, input_hw: int = 224, n_labels: int = 80,
             label_feat: int = 300, width_mult=1.0, seed: int = 0):
    """ML-GCN: ResNet-50 image branch + GCN over the 80-node label graph
    (dense co-occurrence adjacency, Table IV: 6400 edges); scores =
    label embeddings x image feature (runtime matmul)."""
    rng = np.random.default_rng(seed)
    adj = label_graph(n_labels, seed=seed)
    b = GraphBuilder("b2_mlgcn")
    # both inputs declared up front — the layer-sequence convention the
    # tracing frontend produces (jaxpr invars precede all equations), so
    # the golden-parity matrix can compare kind sequences verbatim
    img = b.input((3, input_hw, input_hw), name="image")
    lab = b.input((n_labels, label_feat), name="label_embeddings")
    feat, c, _ = add_resnet_backbone(b, img, depth=50,
                                     width_mult=width_mult, seed=seed)
    imgf = b.globalpool(feat, kind="avg")          # (c,)
    imgv = b.reshape(imgf, (c, 1))
    b.portion = "gnn"
    h = b.mp(lab, adj=adj, name="lgc1_mp")
    h = _lin(b, h, rng, label_feat, max(16, int(1024 * width_mult)),
             act="leaky_relu")
    h = b.mp(h, adj=adj, name="lgc2_mp")
    h = _lin(b, h, rng, max(16, int(1024 * width_mult)), c)
    scores = b.matmul(h, imgv, name="scores")      # (n_labels, 1)
    return b.output(scores)


# --------------------------------------------------------- b3: DualGCN ----
def b3_dualgcn(*, depth: int = 50, input_hw: int = 224, classes: int = 19,
               reduce_ch: int = 512, width_mult=1.0, seed: int = 0):
    """Dual GCN segmentation: ResNet backbone (output stride 16), then two
    GNN reasoning branches — spatial (patch-to-node DM, runtime affinity)
    and channel (channel-to-node DM, runtime affinity) — merged back
    (node-to-channel DM) into the segmentation head. This is the paper's
    showcase of interleaved CNN/GNN dataflow and DM-layer fusion."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder(f"b3_dualgcn_r{depth}")
    img = b.input((3, input_hw, input_hw), name="image")
    feat, c, down = add_resnet_backbone(b, img, depth=depth,
                                        width_mult=width_mult, seed=seed,
                                        out_stride=16)
    rc = max(16, int(reduce_ch * width_mult))
    feat = _conv(b, feat, rng, c, rc, 1)
    hw = -(-input_hw // down)
    n_patch = hw * hw

    # spatial branch: nodes = patches
    sp = b.dm(feat, "patch_to_node", name="dm_sp")        # (n_patch, rc)
    aff = b.vip(sp, name="sp_aff")
    aff = b.softmax(aff, axis=-1, name="sp_aff_sm")
    sp = b.mp(sp, adj_input=aff, name="sp_mp")
    sp = _lin(b, sp, rng, rc, rc, act="relu", bias=False)
    sp = b.dm(sp, "node_to_channel", name="dm_sp_back")   # (rc, hw, hw)

    # channel branch: nodes = channels
    ch = b.dm(feat, "channel_to_node", name="dm_ch")      # (rc, n_patch)
    caff = b.vip(ch, name="ch_aff")
    caff = b.softmax(caff, axis=-1, name="ch_aff_sm")
    ch = b.mp(ch, adj_input=caff, name="ch_mp")
    ch = _lin(b, ch, rng, n_patch, n_patch, act="relu", bias=False)
    ch = b.reshape(ch, (rc, hw, hw), name="dm_ch_back")

    b.portion = "cnn"
    merged = b.add(sp, ch)
    merged = b.add(merged, feat)
    out = _conv(b, merged, rng, rc, classes, 1, bn=False, act=None)
    return b.output(out)


# ---------------------------------------------------------- b4: ST-GCN ----
def b4_stgcn(*, frames: int = 150, joints: int = 25, in_ch: int = 3,
             classes: int = 60, temporal_k: int = 9,
             channels=(64, 64, 64, 128, 128, 128, 256, 256, 256),
             strides=(1, 1, 1, 2, 1, 1, 2, 1, 1), seed: int = 0):
    """ST-GCN: blocks of (spatial graph conv over 25 joints) +
    (temporal conv k x 1), interleaving GNN and CNN layers — the paper's
    Fig. 4 walkthrough example. Feature tensor layout (C, T, V); the MP
    layer contracts V (Table IV: 25 vertices, feature length C*T
    9600-19200)."""
    rng = np.random.default_rng(seed)
    adj = skeleton_adjacency(joints)
    b = GraphBuilder("b4_stgcn")
    x = b.input((in_ch, frames, joints), name="skeleton")
    h, cin = x, in_ch
    for i, (cout, st) in enumerate(zip(channels, strides)):
        b.portion = "gnn"
        # spatial graph conv: 1x1 conv (channel mix) then adjacency MP
        w = (rng.standard_normal((1, 1, cin, cout)) *
             np.sqrt(2.0 / cin)).astype(np.float32)
        y = b.conv(h, w, b=np.zeros(cout, np.float32), name=f"gcn{i}_theta")
        y = b.mp(y, adj=adj, name=f"gcn{i}_mp")
        b.portion = "cnn"
        wt = (rng.standard_normal((temporal_k, 1, cout, cout)) *
              np.sqrt(2.0 / (temporal_k * cout))).astype(np.float32)
        y = b.conv(y, wt, b=np.zeros(cout, np.float32), stride=(st, 1),
                   name=f"tcn{i}")
        y = b.norm(y, scale=np.ones(cout, np.float32),
                   bias=np.zeros(cout, np.float32),
                   mean=np.zeros(cout, np.float32),
                   var=np.ones(cout, np.float32), kind="batch")
        if cin == cout and st == 1:
            y = b.add(y, h)
        h = b.act(y, "relu")
        cin = cout
    h = b.globalpool(h, kind="avg")
    logits = _fc(b, h, rng, cin, classes, act=None)
    return b.output(logits)


# --------------------------------------------------------- b5: SAR-GNN ----
def b5_sar(*, input_hw: int = 128, feat: int = 48, gnn_layers: int = 2,
           classes: int = 10, seed: int = 0):
    """SAR target classification [31]: small CNN front-end lifts the MSTAR
    chip to `feat` channels, every pixel becomes a graph vertex
    (patch-to-node DM), GNN over the 8-neighbor grid graph
    (Table IV: 16384 vertices, 131072 edges, feature length 48)."""
    rng = np.random.default_rng(seed)
    coo = grid_coo(input_hw, input_hw)
    b = GraphBuilder("b5_sar")
    b.portion = "cnn"
    x = b.input((1, input_hw, input_hw), name="sar_chip")
    h = _conv(b, x, rng, 1, feat, 3)
    h = _conv(b, h, rng, feat, feat, 3)
    h = b.dm(h, "patch_to_node", name="dm_pixels")   # (hw*hw, feat)
    b.portion = "gnn"
    for i in range(gnn_layers):
        h = _lin(b, h, rng, feat, feat, bias=False)
        h = b.mp(h, adj_coo=coo, name=f"gmp{i}")
        h = b.act(h, "relu")
    h = b.globalpool(h, kind="avg")                  # (feat,)
    logits = _fc(b, h, rng, feat, classes, act=None)
    return b.output(logits)


# ------------------------------------------------------ b6: point cloud ---
def b6_pointcloud(*, n_points: int = 1024, knn: int = 20, classes: int = 40,
                  dims=(64, 64, 128, 256), feat_out: int = 1024,
                  seed: int = 0):
    """Point-cloud classification (PointNet-style per-point MLPs with
    max-aggregation over a k-NN graph, Point-GNN flavored). GNN-only task;
    Linear-layer weights are dense -> 0% sparsity-mapping gain (paper
    §VII-C). Table IV: 1024 vertices, 10k-30k edges, features 64-1024."""
    rng = np.random.default_rng(seed)
    coo = knn_coo(n_points, knn, seed=seed)
    b = GraphBuilder("b6_pointcloud")
    b.portion = "gnn"
    x = b.input((n_points, 3), name="points")
    h, fin = x, 3
    for d in dims:
        h = _lin(b, h, rng, fin, d, act="relu")
        h = b.mp(h, adj_coo=coo, reduce="max")
        fin = d
    h = _lin(b, h, rng, fin, feat_out, act="relu")
    h = b.globalpool(h, kind="max")                  # (feat_out,)
    logits = _fc(b, h, rng, feat_out, classes, act=None)
    return b.output(logits)


# ------------------------------------------ b6-dyn: dynamic point cloud ---
def b6_pointcloud_dynamic(*, n_points: int = 1024, knn: int = 20,
                          classes: int = 40, dims=(64, 64, 128, 256),
                          feat_out: int = 1024, seed: int = 0):
    """Variable-topology b6: the KNN graph is built per request from the
    runtime point coordinates (``knn_graph``) instead of being baked in as
    a compile-time COO.  A runtime ``(N,)`` validity mask supports
    graph-size bucketing: padded nodes are never selected as neighbors and
    their features are zeroed before the global max pool.

    This builder stands in for the reference's traced
    ``jax_tasks.b6_pointcloud_dynamic_jax``: it replays that function's
    weight draws and names its graph, layers and portions as the
    reference's tracer does, so the compiled plan equals the reference's
    ``build_traced_task("b6-dyn")`` plan op for op (``knn.1`` … the
    classifier ``dot.*``; ``tests/test_torch_dynamic.py``).  The port's own
    tracer builds the same plan up to names from
    ``torch_tasks.b6_pointcloud_dynamic_torch``
    (``tests/test_torch_frontend_parity.py``)."""
    rng = np.random.default_rng(seed)
    ws, fin = [], 3
    for d in dims:
        ws.append(_lin_w(rng, fin, d))
        fin = d
    w_feat = _lin_w(rng, fin, feat_out)
    w_cls = _fc_w(rng, feat_out, classes)
    b = GraphBuilder("b6-dyn_traced")
    pts = b.input((n_points, 3), name="points")
    mask = b.input((n_points,), name="mask")
    idx = b.knn_graph(pts, k=knn, mask=mask, name="knn.1")
    # the tracer numbers every equation; the bias adds (c + 1) fold away
    h, c = pts, 2
    for w in ws:
        h = b.linear(h, w, b=np.zeros(w.shape[1], np.float32),
                     name=f"dot.{c}")
        h = b.act(h, "relu", name=f"ew.{c + 2}")
        h = b.mp(h, knn_input=idx, reduce="max", name=f"mp.{c + 3}")
        c += 4
    h = b.linear(h, w_feat, b=np.zeros(feat_out, np.float32),
                 name=f"dot.{c}")
    h = b.act(h, "relu", name=f"ew.{c + 2}")
    m = b.reshape(mask, (n_points, 1), name=f"bcast.{c + 3}")
    h = b.mul(h, m, name=f"ew.{c + 4}")               # zero padded nodes
    h = b.globalpool(h, kind="max", name=f"reduce.{c + 5}")
    logits = b.linear(h, w_cls, b=np.zeros(classes, np.float32),
                      name=f"dot.{c + 6}")
    return b.output(logits)


TASKS = {
    "b1": b1_fewshot,
    "b2": b2_mlgcn,
    "b3-r50": lambda **kw: b3_dualgcn(depth=50, **kw),
    "b3-r101": lambda **kw: b3_dualgcn(depth=101, **kw),
    "b4": b4_stgcn,
    "b5": b5_sar,
    "b6": b6_pointcloud,
}

# Reduced configs shared by tests, benchmarks and serving demos.  Every
# input keeps a *per-sample* shape (no baked-in batch axis): the batch is a
# runtime concern — ``build_runner(plan, batch=N)`` / the serving engine
# prepend the batch axis, so the same graph serves any batch size.
SMALL_CONFIGS = {
    "b1": dict(input_hw=16, embed_ch=16, gnn_dim=32, gnn_blocks=2),
    "b2": dict(input_hw=32, width_mult=0.125, n_labels=16, label_feat=32),
    "b3-r50": dict(input_hw=32, width_mult=0.125, reduce_ch=64),
    "b3-r101": dict(input_hw=32, width_mult=0.0625, reduce_ch=32),
    "b4": dict(frames=16, channels=(16, 32), strides=(1, 2)),
    "b5": dict(input_hw=16, feat=8),
    "b6": dict(n_points=64, knn=5, dims=(8, 16), feat_out=32),
}


DYNAMIC_TASKS = {"b6-dyn": b6_pointcloud_dynamic}
DYNAMIC_SMALL_CONFIGS = {
    "b6-dyn": dict(n_points=64, knn=5, dims=(8, 16), feat_out=32),
}


def build_dynamic_task(task: str, *, small: bool = False, **overrides):
    """Build a dynamic-graph task (``b6-dyn``), optionally at the reduced
    test scale of the reference's ``TRACED_SMALL_CONFIGS``."""
    kwargs = dict(DYNAMIC_SMALL_CONFIGS[task]) if small else {}
    kwargs.update(overrides)
    return DYNAMIC_TASKS[task](**kwargs)


def build_task(task: str, *, small: bool = False, **overrides):
    """Build one of b1-b6, optionally at the reduced test/serving scale."""
    kwargs = dict(SMALL_CONFIGS[task]) if small else {}
    kwargs.update(overrides)
    return TASKS[task](**kwargs)


def request_inputs(plan, seed: int = 0) -> dict:
    """One serving request's worth of random per-sample inputs for ``plan``
    (shapes from the plan's recorded input metadata — ready to ``submit``
    to ``GNNCVServeEngine`` or to stack into a batched runner call)."""
    from repro_torch.core.executor import random_inputs
    return random_inputs(plan, seed=seed)
