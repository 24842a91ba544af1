"""Paper tasks re-expressed as *plain PyTorch functions* for the tracing
frontend (the paper's "user-defined model" input, §V-A).

Port of ``src/repro/gnncv/jax_tasks.py``.  Each builder returns ``(fn,
example_inputs)`` where ``fn`` is an ordinary torch callable — convs via
``F.conv2d``, linears via ``@``, pooling via ``F.max_pool2d`` — with GNN
aggregation expressed through the ``repro_torch.frontend.nn`` op library.
Weight initialization replays the exact numpy draw sequence of the
declarative builders in ``gnncv.tasks`` (and of the reference's traced
tasks), turned into tensors with ``torch.from_numpy``, so traced graphs
carry bit-identical weights: ``trace -> canonicalize -> compile`` gives the
builder's plan up to layer names.

Three spellings keep the traced graphs on the IR's vocabulary:

  * SAME padding is TF-style and may be asymmetric (a 3x3 stride-2 conv at
    224 pads ``(0, 1)``), which ``F.conv2d``'s symmetric ``padding`` cannot
    say: the tasks pad explicitly with ``F.pad`` and convolve with
    ``padding=0`` (max pools pad with ``-inf``), and the tracer folds the
    pad back into a SAME conv or pool;
  * conv weights are drawn HWIO ``(k, k, c_in, c_out)`` like the builders'
    and permuted to ``F.conv2d``'s OIHW here; the tracer permutes them
    back, so both stay bit-identical;
  * per-sample ``(C, H, W)`` maps are normalized with ``nn.batch_norm``
    (``F.batch_norm`` would read axis 1 as the channels).

b7 (ViG) and b7-dyn exist only here.  ``fn`` runs directly too (on CPU
tensors: its weights are CPU tensors), which the tests hold against the
compiled plans.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.frontend import nn
from repro_torch.frontend.trace import _same_padding
from repro_torch.gnncv.cnn_zoo import _RESNET_BLOCKS, _fc_w
from repro_torch.gnncv.graphs import (grid_coo, knn_coo, label_graph,
                                      skeleton_adjacency)
from repro_torch.gnncv.tasks import SMALL_CONFIGS, _lin_w


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_w(rng, cin, cout, k):
    """Mirrors ``cnn_zoo._conv``'s weight draw (HWIO)."""
    return (rng.standard_normal((k, k, cin, cout)) *
            np.sqrt(2.0 / (k * k * cin))).astype(np.float32)


def _oihw(w: np.ndarray) -> torch.Tensor:
    """HWIO draw -> ``F.conv2d``'s OIHW layout (an exact permutation)."""
    return _t(w.transpose(3, 2, 0, 1))


def _pad_same(x, window, stride, value=0.0):
    """TF-style SAME padding of the last two axes (``before = total //
    2``), which the tracer folds into the consuming conv or pool."""
    (pt, pb), (pl, pr) = _same_padding(x.shape[-2:], window, stride)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=value)
    return x


def _conv2d(x, w, stride=(1, 1), padding="SAME"):
    """``(N, C, H, W)`` conv; ``w`` OIHW."""
    if padding == "SAME":
        x = _pad_same(x, tuple(w.shape[2:]), stride)
    return F.conv2d(x, w, stride=stride)


def _conv2d_single(x, w, stride=(1, 1), padding="SAME"):
    """Per-sample conv on a 3-D ``(C, H, W)`` feature map — the rank-4
    wrap/unwrap is folded away by ``canonicalize.fold_conv_batch1`` so the
    conv layer consumes the 3-D layout exactly like builder convs."""
    return _conv2d(x[None], w, stride, padding)[0]


def _max_pool(x, window, stride):
    return F.max_pool2d(_pad_same(x, (window, window), (stride, stride),
                                  float("-inf")), window, stride)


def _tconv(rng, cin, cout, k, *, stride=1, bn=True, act="relu"):
    """Closure twin of ``cnn_zoo._conv`` — identical RNG draw (one
    ``standard_normal`` for the kernel; bias and norm statistics are
    deterministic), applied to per-sample ``(C, H, W)`` maps."""
    w = _oihw(_conv_w(rng, cin, cout, k))
    zeros = torch.zeros(cout)
    ones = torch.ones(cout)
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)

    def apply(h):
        h = _conv2d_single(h, w, st) + zeros[:, None, None]
        if bn:
            h = nn.batch_norm(h, ones, zeros, zeros, ones)
        if act:
            h = torch.relu(h)
        return h
    return apply


def _resnet_backbone(*, depth: int = 50, width_mult=1.0, seed: int = 0,
                     out_stride: int = 32):
    """Closure twin of ``cnn_zoo.add_resnet_backbone`` — the same blocks,
    strides and *draw order* (shortcut conv before the residual stack, per
    block), so b2/b3 traced weights are bit-identical to the builder's.
    Returns ``(apply_fn, channels, spatial_downscale)``."""
    rng = np.random.default_rng(seed)
    wm = lambda c: max(8, int(c * width_mult))  # noqa: E731
    stem = _tconv(rng, 3, wm(64), 7, stride=2)
    cin, down, blocks = wm(64), 4, []
    for stage, nblocks in enumerate(_RESNET_BLOCKS[depth]):
        cmid = wm(64 * 2 ** stage)
        cout = cmid * 4
        for blk in range(nblocks):
            stride = 2 if (blk == 0 and stage > 0) else 1
            if stage == 3 and out_stride == 16:
                stride = 1
            if stride == 2:
                down *= 2
            sc = (_tconv(rng, cin, cout, 1, stride=stride, act=None)
                  if blk == 0 else None)
            c1 = _tconv(rng, cin, cmid, 1)
            c2 = _tconv(rng, cmid, cmid, 3, stride=stride)
            c3 = _tconv(rng, cmid, cout, 1, act=None)
            blocks.append((sc, c1, c2, c3))
            cin = cout

    def apply(h):
        h = stem(h)
        h = _max_pool(h, 3, 2)
        for sc, c1, c2, c3 in blocks:
            shortcut = sc(h) if sc is not None else h
            y = c3(c2(c1(h)))
            h = torch.relu(y + shortcut)
        return h
    return apply, cin, down


def _example(*shape) -> torch.Tensor:
    return torch.zeros(shape)


# -------------------------------------------------------- b1: few-shot ----
def b1_fewshot_torch(*, n_way: int = 5, n_shot: int = 5, input_hw: int = 28,
                     embed_ch: int = 64, gnn_dim: int = 400,
                     gnn_blocks: int = 3, seed: int = 0):
    """Torch twin of ``tasks.b1_fewshot`` — conv-4 embedding, then GNN
    blocks whose dense affinity is a *traced* value (VIP + softmax feeding
    ``message_passing`` with a runtime adjacency)."""
    rng = np.random.default_rng(seed)
    n_nodes = n_way * n_shot + 1
    convs, cin = [], 1
    for _ in range(4):
        convs.append(_oihw(_conv_w(rng, cin, embed_ch, 3)))
        cin = embed_ch
    ones, zeros = torch.ones(embed_ch), torch.zeros(embed_ch)
    w_embed = _t(_lin_w(rng, embed_ch, gnn_dim))
    w_blocks = [_t(_lin_w(rng, 2 * gnn_dim, gnn_dim))
                for _ in range(gnn_blocks)]
    w_out = _t(_lin_w(rng, gnn_dim, n_way))
    b_gnn, b_out = torch.zeros(gnn_dim), torch.zeros(n_way)

    def embed(h, w):
        h = _conv2d(h, w) + zeros[None, :, None, None]
        h = nn.batch_norm(h, ones, zeros, zeros, ones)
        return torch.relu(h)

    def model(images):
        h = embed(images, convs[0])
        h = _max_pool(h, 2, 2)
        h = embed(h, convs[1])
        h = _max_pool(h, 2, 2)
        h = embed(h, convs[2])
        h = embed(h, convs[3])
        h = h.mean((2, 3))                        # (N, embed_ch)
        h = torch.relu(h @ w_embed + b_gnn)
        for w in w_blocks:
            aff = nn.vip(h)                       # dense runtime (N, N)
            aff = F.softmax(aff, dim=-1)
            agg = nn.message_passing(aff, h)
            cat = torch.cat([h, agg], dim=1)
            h = torch.relu(cat @ w + b_gnn)
        return h @ w_out + b_out

    return model, {"images": _example(n_nodes, 1, input_hw, input_hw)}


# ---------------------------------------------------------- b2: ML-GCN ----
def b2_mlgcn_torch(*, input_hw: int = 224, n_labels: int = 80,
                   label_feat: int = 300, width_mult=1.0, seed: int = 0):
    """Torch twin of ``tasks.b2_mlgcn`` — ResNet-50 image branch plus a
    GCN over the dense label graph with ``leaky_relu`` between the graph
    convolutions."""
    rng = np.random.default_rng(seed)
    adj = _t(label_graph(n_labels, seed=seed))
    backbone, c, _ = _resnet_backbone(depth=50, width_mult=width_mult,
                                      seed=seed)
    gdim = max(16, int(1024 * width_mult))
    w1, b1 = _t(_lin_w(rng, label_feat, gdim)), torch.zeros(gdim)
    w2, b2 = _t(_lin_w(rng, gdim, c)), torch.zeros(c)

    def model(image, label_embeddings):
        feat = backbone(image)
        imgf = feat.mean((1, 2))                  # (c,)
        imgv = imgf.reshape(c, 1)
        h = nn.message_passing(adj, label_embeddings)
        h = F.leaky_relu(h @ w1 + b1, 0.2)
        h = nn.message_passing(adj, h)
        h = h @ w2 + b2
        return h @ imgv                           # (n_labels, 1) scores

    return model, {"image": _example(3, input_hw, input_hw),
                   "label_embeddings": _example(n_labels, label_feat)}


# --------------------------------------------------------- b3: DualGCN ----
def b3_dualgcn_torch(*, depth: int = 50, input_hw: int = 224,
                     classes: int = 19, reduce_ch: int = 512, width_mult=1.0,
                     seed: int = 0):
    """Torch twin of ``tasks.b3_dualgcn`` — ResNet backbone (output
    stride 16), then the two GNN reasoning branches written as raw torch
    layout shuffles: ``reshape(...).T`` (patch-to-node), ``reshape``
    (channel-to-node) and ``.T.reshape(...)`` (node-to-channel) all
    canonicalize into DM layers, so Step-1 DM fusion fires exactly as on
    the builder graph."""
    rng = np.random.default_rng(seed)
    backbone, c, down = _resnet_backbone(
        depth=depth, width_mult=width_mult, seed=seed, out_stride=16)
    rc = max(16, int(reduce_ch * width_mult))
    reduce_conv = _tconv(rng, c, rc, 1)
    hw = -(-input_hw // down)
    w_sp = _t(_lin_w(rng, rc, rc))
    w_ch = _t(_lin_w(rng, hw * hw, hw * hw))
    out_conv = _tconv(rng, rc, classes, 1, bn=False, act=None)

    def model(image):
        feat = backbone(image)
        feat = reduce_conv(feat)                  # (rc, hw, hw)

        sp = feat.reshape(rc, -1).T               # patch-to-node
        aff = F.softmax(nn.vip(sp), dim=-1)
        sp = nn.message_passing(aff, sp)
        sp = torch.relu(sp @ w_sp)
        sp = sp.T.reshape(rc, hw, hw)             # node-to-channel

        ch = feat.reshape(rc, -1)                 # channel-to-node
        caff = F.softmax(nn.vip(ch), dim=-1)
        ch = nn.message_passing(caff, ch)
        ch = torch.relu(ch @ w_ch)
        ch = ch.reshape(rc, hw, hw)

        merged = sp + ch
        merged = merged + feat
        return out_conv(merged)

    return model, {"image": _example(3, input_hw, input_hw)}


# ---------------------------------------------------------- b4: ST-GCN ----
def b4_stgcn_torch(*, frames: int = 150, joints: int = 25, in_ch: int = 3,
                   classes: int = 60, temporal_k: int = 9,
                   channels=(64, 64, 64, 128, 128, 128, 256, 256, 256),
                   strides=(1, 1, 1, 2, 1, 1, 2, 1, 1), seed: int = 0):
    """Torch twin of ``tasks.b4_stgcn`` — spatial graph conv written as
    the *raw* right-side-adjacency matmul ``(x.reshape(C·T, V) @
    A.T).reshape(C, T, V)`` (recovered as the dense MP layer by
    ``match_adj_right_mp``), interleaved with rank-4-wrapped temporal convs
    on the 3-D ``(C, T, V)`` feature tensor."""
    rng = np.random.default_rng(seed)
    adj_t = _t(skeleton_adjacency(joints).T)
    cin, blocks = in_ch, []
    for cout, st in zip(channels, strides):
        w = (rng.standard_normal((1, 1, cin, cout)) *
             np.sqrt(2.0 / cin)).astype(np.float32)
        wt = (rng.standard_normal((temporal_k, 1, cout, cout)) *
              np.sqrt(2.0 / (temporal_k * cout))).astype(np.float32)
        blocks.append((_oihw(w), _oihw(wt), st, cin, cout))
        cin = cout
    w_cls = _t(_fc_w(rng, cin, classes))
    b_cls = torch.zeros(classes)

    def model(skeleton):
        h = skeleton                              # (C, T, V)
        for w, wt, st, ci, co in blocks:
            zeros, ones = torch.zeros(co), torch.ones(co)
            y = _conv2d_single(h, w) + zeros[:, None, None]   # 1x1 theta
            c, t, v = y.shape
            y = (y.reshape(c * t, v) @ adj_t).reshape(c, t, v)  # spatial MP
            y = _conv2d_single(y, wt, (st, 1)) + zeros[:, None, None]
            y = nn.batch_norm(y, ones, zeros, zeros, ones)
            if ci == co and st == 1:
                y = y + h
            h = torch.relu(y)
        h = h.mean((1, 2))                        # (C,)
        return h @ w_cls + b_cls

    return model, {"skeleton": _example(in_ch, frames, joints)}


# --------------------------------------------------------- b5: SAR-GNN ----
def b5_sar_torch(*, input_hw: int = 128, feat: int = 48, gnn_layers: int = 2,
                 classes: int = 10, seed: int = 0):
    """Torch twin of ``tasks.b5_sar`` — small CNN front-end, every pixel
    becomes a vertex (``reshape(...).T`` patch-to-node DM), GNN over the
    8-neighbor grid graph in COO form."""
    rng = np.random.default_rng(seed)
    coo = grid_coo(input_hw, input_hw)
    conv1 = _tconv(rng, 1, feat, 3)
    conv2 = _tconv(rng, feat, feat, 3)
    lins = [_t(_lin_w(rng, feat, feat)) for _ in range(gnn_layers)]
    w_cls = _t(_fc_w(rng, feat, classes))
    b_cls = torch.zeros(classes)

    def model(sar_chip):
        h = conv1(sar_chip)
        h = conv2(h)
        h = h.reshape(feat, -1).T                 # (hw*hw, feat) vertices
        for w in lins:
            h = h @ w
            h = nn.message_passing(coo, h)
            h = torch.relu(h)
        h = h.mean(0)                             # (feat,)
        return h @ w_cls + b_cls

    return model, {"sar_chip": _example(1, input_hw, input_hw)}


# ------------------------------------------------------ b6: point cloud ---
def _pointcloud_weights(rng, dims, feat_out, classes):
    lins, fin = [], 3
    for d in dims:
        lins.append((_t(_lin_w(rng, fin, d)), torch.zeros(d)))
        fin = d
    return (lins, _t(_lin_w(rng, fin, feat_out)), torch.zeros(feat_out),
            _t(_fc_w(rng, feat_out, classes)), torch.zeros(classes))


def b6_pointcloud_torch(*, n_points: int = 1024, knn: int = 20,
                        classes: int = 40, dims=(64, 64, 128, 256),
                        feat_out: int = 1024, seed: int = 0):
    """Torch twin of ``tasks.b6_pointcloud`` — per-point MLPs with COO
    max-aggregation message passing, global max pool, classifier head."""
    rng = np.random.default_rng(seed)
    coo = knn_coo(n_points, knn, seed=seed)
    lins, w_feat, b_feat, w_cls, b_cls = _pointcloud_weights(
        rng, dims, feat_out, classes)

    def model(points):
        h = points
        for w, b in lins:
            h = torch.relu(h @ w + b)
            h = nn.message_passing(coo, h, reduce="max")
        h = torch.relu(h @ w_feat + b_feat)
        h = h.amax(0)                             # (feat_out,)
        return h @ w_cls + b_cls

    return model, {"points": _example(n_points, 3)}


# ------------------------------------------------- b7: ViG (traced-only) --
def _vig_weights(rng, patch, dim, blocks, classes):
    w_embed = _oihw(_conv_w(rng, 3, dim, patch))
    blks = [tuple(_t(w) for w in (_lin_w(rng, dim, dim),
                                  _lin_w(rng, dim, dim),
                                  _lin_w(rng, dim, 2 * dim),
                                  _lin_w(rng, 2 * dim, dim)))
            for _ in range(blocks)]
    return (w_embed, torch.zeros(dim), blks,
            _t(_fc_w(rng, dim, classes)), torch.zeros(classes))


def _vig_blocks(h, idx, blks, w_cls, b_cls):
    """ViG's grapher (linear -> max-aggregation MP -> linear, residual) and
    FFN (2-layer MLP, residual) blocks, global average pool, classifier."""
    for w_in, w_out, w_up, w_down in blks:
        y = h @ w_in                              # grapher
        y = nn.message_passing(idx, y, reduce="max")
        y = torch.relu(y @ w_out)
        h = h + y
        z = torch.relu(h @ w_up)                  # FFN
        h = h + z @ w_down
    h = h.mean(0)                                 # (dim,)
    return h @ w_cls + b_cls


def b7_vig_torch(*, input_hw: int = 224, patch: int = 16, dim: int = 192,
                 blocks: int = 12, classes: int = 1000, seed: int = 0):
    """ViG-style vision GNN (Han et al., "Vision GNN: An Image is Worth
    Graph of Nodes"), defined *only* as a traced model — there is no
    ``GraphBuilder`` program for it.  Patch embedding (strided conv), then
    grapher blocks over the 8-neighbor patch graph alternating with FFN
    blocks, global average pool, classifier head.  Defaults: ViG-Ti's width
    (192) and depth (12) at 224x224 with 16x16 patches, ImageNet's 1000
    classes."""
    assert input_hw % patch == 0, (input_hw, patch)
    rng = np.random.default_rng(seed)
    hp = input_hw // patch
    coo = grid_coo(hp, hp)
    w_embed, b_embed, blks, w_cls, b_cls = _vig_weights(
        rng, patch, dim, blocks, classes)

    def model(image):
        h = _conv2d_single(image, w_embed, (patch, patch), "VALID")
        h = h + b_embed[:, None, None]
        h = h.reshape(dim, -1).T                  # (n_patch, dim) nodes
        return _vig_blocks(h, coo, blks, w_cls, b_cls)

    return model, {"image": _example(3, input_hw, input_hw)}


# ------------------------------------------- b6-dyn: dynamic point cloud --
def b6_pointcloud_dynamic_torch(*, n_points: int = 1024, knn: int = 20,
                                classes: int = 40, dims=(64, 64, 128, 256),
                                feat_out: int = 1024, seed: int = 0):
    """Variable-topology b6 — the KNN graph is *built per request* from the
    runtime point coordinates via ``nn.knn_graph``.  A runtime ``(N,)``
    validity mask supports serving's graph-size bucketing: padded nodes are
    never selected as neighbors and their features are zeroed before the
    global max pool."""
    rng = np.random.default_rng(seed)
    lins, w_feat, b_feat, w_cls, b_cls = _pointcloud_weights(
        rng, dims, feat_out, classes)

    def model(points, mask):
        idx = nn.knn_graph(points, k=knn, mask=mask)   # (N, k) int32
        h = points
        for w, b in lins:
            h = torch.relu(h @ w + b)
            h = nn.message_passing(idx, h, reduce="max")
        h = torch.relu(h @ w_feat + b_feat)
        h = h * mask[:, None]                     # zero padded nodes
        h = h.amax(0)                             # (feat_out,)
        return h @ w_cls + b_cls

    return model, {"points": _example(n_points, 3),
                   "mask": _example(n_points)}


# ------------------------------------------------ b7-dyn: dynamic ViG -----
def b7_vig_dynamic_torch(*, input_hw: int = 224, patch: int = 16,
                         dim: int = 192, blocks: int = 12, knn: int = 9,
                         classes: int = 1000, seed: int = 0,
                         precomputed_graph=None):
    """ViG with *dynamic* graph construction (the actual Vision-GNN
    design): the patch graph is the k-NN graph of the patch embeddings,
    written as the raw pairwise-distance + stable-argsort idiom — no ``nn``
    graph helper.  The canonicalizer recovers a ``knn_graph`` layer from
    the traced ``mul/sum/mm/sort/slice`` nodes, so the fused distance +
    top-k kernel runs without the model mentioning it.

    ``argsort(d, stable=True)[:, 1:k+1]`` excludes the self match (k = 9
    is ViG's default); weights replay ``b7_vig_torch``'s draw sequence
    exactly, so the two variants differ only in connectivity.

    ``precomputed_graph``: an ``(n_patch, k)`` index matrix baked in as the
    connectivity instead of the traced distance computation — the
    offline-graph twin the dynamic path must match bit for bit (max
    aggregation is order-independent)."""
    assert input_hw % patch == 0, (input_hw, patch)
    rng = np.random.default_rng(seed)
    w_embed, b_embed, blks, w_cls, b_cls = _vig_weights(
        rng, patch, dim, blocks, classes)
    fixed = None if precomputed_graph is None else \
        _t(np.asarray(precomputed_graph, np.int32))

    def model(image):
        h = _conv2d_single(image, w_embed, (patch, patch), "VALID")
        h = h + b_embed[:, None, None]
        h = h.reshape(dim, -1).T                  # (n_patch, dim) nodes
        if fixed is not None:
            idx = fixed
        else:
            sq = (h * h).sum(1)                   # raw distance idiom
            d = sq[:, None] + sq[None, :] - 2.0 * (h @ h.T)
            idx = torch.argsort(d, dim=1, stable=True)[:, 1:knn + 1]
        return _vig_blocks(h, idx, blks, w_cls, b_cls)

    return model, {"image": _example(3, input_hw, input_hw)}


TRACED_TASKS = {
    "b1": b1_fewshot_torch,
    "b2": b2_mlgcn_torch,
    "b3-r50": lambda **kw: b3_dualgcn_torch(depth=50, **kw),
    "b3-r101": lambda **kw: b3_dualgcn_torch(depth=101, **kw),
    "b4": b4_stgcn_torch,
    "b5": b5_sar_torch,
    "b6": b6_pointcloud_torch,
    "b6-dyn": b6_pointcloud_dynamic_torch,
    "b7": b7_vig_torch,
    "b7-dyn": b7_vig_dynamic_torch,
}

# Reduced configs: b1-b6 reuse the builder's SMALL_CONFIGS so parity tests
# compare like for like; the others are the reference's.
TRACED_SMALL_CONFIGS = {
    **SMALL_CONFIGS,
    "b6-dyn": dict(n_points=64, knn=5, dims=(8, 16), feat_out=32),
    "b7": dict(input_hw=32, patch=8, dim=16, blocks=2, classes=10),
    "b7-dyn": dict(input_hw=32, patch=8, dim=16, blocks=2, knn=4,
                   classes=10),
}


def build_traced_task(task: str, *, small: bool = False, **overrides):
    """Trace one of the re-expressed tasks into a layer ``Graph`` — the
    frontend counterpart of ``tasks.build_task``."""
    from repro_torch.frontend import to_graph
    kwargs = dict(TRACED_SMALL_CONFIGS[task]) if small else {}
    kwargs.update(overrides)
    fn, example = TRACED_TASKS[task](**kwargs)
    return to_graph(fn, example, name=f"{task}_traced")
