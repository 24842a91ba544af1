"""b2, ML-GCN (Chen et al., CVPR 2019), as a user of ``gcv.compile``
writes it: a plain torch function over weights it closes over, with the
label graph's aggregation through ``repro_torch.frontend.nn``.

The weights, the label statistics and the requests are drawn from the
seed on the card, each kind in one call of a ``torch.Generator``; the
model function takes host copies (``gcv.compile`` traces on the host).
The correlation matrix is derived from the drawn statistics as the paper
does (eqs. 7-8, then the authors' normalisation); the reference
(``bench/reference/b2-mlgcn.py``) gets the same statistics and derives it
again.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def blocks(cfg):
    """``(prefix, c_in, c_mid, c_out, stride)`` of each bottleneck, in
    order (stride on the 3x3 conv, as torchvision's ResNets)."""
    out, cin = [], cfg["stem_channels"]
    for stage, n in enumerate(cfg["resnet_blocks"]):
        cmid = cfg["stem_channels"] * 2 ** stage
        cout = cmid * cfg["bottleneck_expansion"]
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            out.append((f"s{stage}b{b}", cin, cmid, cout, stride))
            cin = cout
    return out


def convs(cfg):
    """``(name, c_in, c_out, k)`` of every conv, each followed by a batch
    norm of its own."""
    c0, k0 = cfg["stem_channels"], cfg["stem_kernel"]
    out = [("stem", cfg["image"][0], c0, k0)]
    for p, cin, cmid, cout, _ in blocks(cfg):
        if cin != cout or p.endswith("b0"):
            out.append((f"{p}.sc", cin, cout, 1))
        out += [(f"{p}.c1", cin, cmid, 1), (f"{p}.c2", cmid, cmid, 3),
                (f"{p}.c3", cmid, cout, 1)]
    return out


def layout(cfg):
    """Every weight leaf: ``(name, shape, law, scale, shift)``; ``law`` is
    ``"normal"`` (value = shift + scale * N(0, 1)) or ``"uniform"`` (value
    = shift + scale * U[0, 1))."""
    leaves = []
    for name, cin, cout, k in convs(cfg):
        leaves.append((f"{name}.w", (cout, cin, k, k), "normal",
                       math.sqrt(2.0 / (k * k * cin)), 0.0))
        leaves += [(f"{name}.gamma", (cout,), "uniform", 1.0, 0.5),
                   (f"{name}.beta", (cout,), "normal", 0.1, 0.0),
                   (f"{name}.mean", (cout,), "normal", 0.1, 0.0),
                   (f"{name}.var", (cout,), "uniform", 1.0, 0.5)]
    d_in = cfg["label_dim"]
    for i, d in enumerate(cfg["gcn_dims"]):
        leaves.append((f"gcn{i}.w", (d_in, d), "normal",
                       math.sqrt(1.0 / d_in), 0.0))
        if cfg["gcn_bias"]:
            leaves.append((f"gcn{i}.b", (d,), "normal", 0.1, 0.0))
        d_in = d
    n = cfg["n_labels"]
    leaves += [("label_embeddings", (n, cfg["label_dim"]), "normal", 1.0,
                0.0),
               # the statistics the correlation matrix is derived from
               ("label_counts", (n,), "uniform", 44500.0, 500.0),
               ("pair_draws", (n, n), "uniform", 1.0, 0.0)]
    return leaves


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stream of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % 2**63)
    return gen


def draw(leaves, seed: int, device) -> dict[str, torch.Tensor]:
    """The leaves from ``seed``: one normal and one uniform draw of a
    ``torch.Generator`` on ``device``, cut into views and scaled."""
    gen = generator(seed, 0, device)
    sizes = {law: sum(math.prod(s) for _, s, lw, _, _ in leaves if lw == law)
             for law in ("normal", "uniform")}
    flat = {"normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, law, scale, shift in leaves:
        n = math.prod(shape)
        v = flat[law][at[law]:at[law] + n].view(shape)
        at[law] += n
        out[name] = v.mul_(scale).add_(shift)
    return out


def make_weights(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    return draw(layout(cfg), seed, device)


def make_requests(cfg, seed: int, n: int, device,
                  weights: dict) -> list[dict]:
    """``n`` distinct images, N(0, 1) per pixel, in one draw; every request
    carries the run's one label-embedding table (drawn with the weights)."""
    images = torch.randn((n, *cfg["image"]),
                         generator=generator(seed, 1, device),
                         device=device).cpu().numpy()
    emb = weights["label_embeddings"].numpy()
    return [{"image": images[i], "label_embeddings": emb} for i in range(n)]


def _same(x, k: int, stride: int, value: float = 0.0):
    """TF-style SAME padding of the last two axes (the extra row and
    column after), spelled with ``F.pad`` so the tracer folds it into the
    conv or pool that follows."""
    h, w = x.shape[-2:]
    pads = []
    for size in (w, h):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def label_graph(cfg, counts: np.ndarray, draws: np.ndarray) -> np.ndarray:
    """ML-GCN's normalised correlation matrix from label statistics: label
    counts ``N_i = floor(counts)``, pair counts ``M_ij = floor(min(N_i,
    N_j) u^3)`` over the symmetric upper triangle ``u`` of ``draws``;
    ``A = [M_ij / N_i >= tau]`` (eq. 7), ``A' = p A / rowsum(A) + (1 - p)
    I`` (eq. 8), then ``D^-1/2 A'^T D^-1/2`` with ``D`` the row sums of
    ``A'`` (the authors' ``gen_adj``)."""
    n_i = np.floor(counts.astype(np.float64))
    u = np.triu(draws.astype(np.float64), 1)
    u = u + u.T
    m = np.floor(np.minimum(n_i[:, None], n_i[None, :]) * u * u * u)
    a = (m / n_i[:, None] >= float(cfg["correlation_threshold"]))
    a = a.astype(np.float64)
    p = float(cfg["reweight_p"])
    a = p * a / np.maximum(a.sum(1, keepdims=True), 1.0) \
        + (1.0 - p) * np.eye(len(n_i))
    d = 1.0 / np.sqrt(a.sum(1))
    return (d[:, None] * a.T * d[None, :]).astype(np.float32)


def make_model(cfg, w: dict):
    """``(fn, example)``: ``fn(image, label_embeddings)`` -> ``(n_labels,
    1)`` scores; ``example()`` the example inputs of one request."""
    from repro_torch.frontend import nn
    eps = float(cfg["bn_eps"])
    slope = float(cfg["leaky_slope"])
    adj = torch.from_numpy(label_graph(cfg, w["label_counts"].numpy(),
                                       w["pair_draws"].numpy()))
    pool = {"max": lambda h: h.amax((1, 2)),
            "avg": lambda h: h.mean((1, 2))}[cfg["image_pooling"]]
    structure = blocks(cfg)
    c_feat = structure[-1][3]

    def conv_bn(h, name, stride, relu):
        wt = w[f"{name}.w"]
        h = F.conv2d(_same(h[None], wt.shape[-1], stride), wt,
                     stride=stride)[0]
        h = nn.batch_norm(h, w[f"{name}.gamma"], w[f"{name}.beta"],
                          w[f"{name}.mean"], w[f"{name}.var"], eps=eps)
        return torch.relu(h) if relu else h

    def gcn_linear(g, i):
        g = g @ w[f"gcn{i}.w"]
        return g + w[f"gcn{i}.b"] if f"gcn{i}.b" in w else g

    def model(image, label_embeddings):
        h = conv_bn(image, "stem", 2, True)
        h = F.max_pool2d(_same(h, 3, 2, float("-inf")), 3, 2)
        for p, cin, cmid, cout, stride in structure:
            sc = conv_bn(h, f"{p}.sc", stride, False) \
                if f"{p}.sc.w" in w else h
            y = conv_bn(h, f"{p}.c1", 1, True)
            y = conv_bn(y, f"{p}.c2", stride, True)
            y = conv_bn(y, f"{p}.c3", 1, False)
            h = torch.relu(y + sc)
        img = pool(h).reshape(c_feat, 1)
        g = nn.message_passing(adj, label_embeddings)
        g = F.leaky_relu(gcn_linear(g, 0), slope)
        g = nn.message_passing(adj, g)
        g = gcn_linear(g, 1)
        return g @ img

    def example():
        return {"image": torch.zeros(cfg["image"]),
                "label_embeddings": torch.zeros(cfg["n_labels"],
                                                cfg["label_dim"])}
    return model, example
