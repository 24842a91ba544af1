"""Plain PyTorch reference of b2, ML-GCN (Chen et al., CVPR 2019): a
ResNet (torchvision's layout: the stride on the 3x3 conv of each stage's
first bottleneck, a 1x1 projection on its shortcut) whose globally
max-pooled (or averaged, as the configuration says) features score the
label vectors, those the output of a 2-layer GCN over the normalised
correlation matrix, which is derived here from the label statistics
(eqs. 7-8 of the paper, the authors' normalisation).

It follows the configuration's own spelling of padding: TF-style SAME
(the extra row and column after), which the port's tracer requires of a
strided conv.  fp32 with TF32 off in every product; batch norm in eval
mode with the drawn statistics.  It takes the weight tensors and requests
the harness drew and derives everything else itself.  Imports nothing of
the program.

``tf32=True`` is the control of ``correct``: every conv's and product's
operands rounded to TF32 (10 mantissa bits, to nearest even), the sums in
fp32, which is what the tensor cores' TF32 mode computes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The one number compared, and its limit (readings and reasons: PERF.md).
CHECK = {"name": "scores_rel_err", "limit": 2.5e-4}
BLOCK = 32                 # images a reference block


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    r = i + 0x0FFF + ((i >> 13) & 1)
    return (r & ~0x1FFF).view(torch.float32)


def _same(x, k: int, stride: int, value: float = 0.0):
    h, w = x.shape[-2:]
    pads = []
    for size in (w, h):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _structure(cfg):
    out = []
    for stage, n in enumerate(cfg["resnet_blocks"]):
        for b in range(n):
            out.append((f"s{stage}b{b}", 2 if (b == 0 and stage > 0) else 1))
    return out


def correlation(cfg, counts: torch.Tensor, draws: torch.Tensor):
    """The normalised correlation matrix, fp32, from the label statistics:
    ``N_i = floor(counts)``; pair counts ``M_ij = floor(min(N_i, N_j)
    u_ij^3)`` with ``u`` the upper triangle of ``draws`` made symmetric;
    ``A_ij = 1`` where ``P(L_j | L_i) = M_ij / N_i >= tau`` (eq. 7);
    ``A'_ij = p A_ij / sum_j A_ij`` off the diagonal and ``1 - p`` on it
    (eq. 8); then ``D^-1/2 A'^T D^-1/2`` with ``D_ii = sum_j A'_ij``."""
    n_i = counts.double().floor()
    u = draws.double().triu(1)
    u = u + u.T
    m = (torch.minimum(n_i[:, None], n_i[None, :]) * u * u * u).floor()
    a = (m / n_i[:, None] >= float(cfg["correlation_threshold"])).double()
    p = float(cfg["reweight_p"])
    eye = torch.eye(len(n_i), dtype=torch.float64, device=counts.device)
    a = p * a / a.sum(1, keepdim=True).clamp(min=1.0) + (1.0 - p) * eye
    d = a.sum(1).rsqrt()
    return (d[:, None] * a.T * d[None, :]).float()


def scores(cfg, w: dict, image, emb, *, tf32: bool = False):
    """``(B, n_labels, 1)`` scores of images ``(B, 3, H, W)`` against label
    embeddings ``(B, n_labels, label_dim)``."""
    rnd = to_tf32 if tf32 else (lambda t: t)
    eps = float(cfg["bn_eps"])

    def conv_bn(h, name, stride, relu):
        wt = w[f"{name}.w"]
        h = F.conv2d(rnd(_same(h, wt.shape[-1], stride)), rnd(wt),
                     stride=stride)
        h = F.batch_norm(h, w[f"{name}.mean"], w[f"{name}.var"],
                         w[f"{name}.gamma"], w[f"{name}.beta"], False, 0.0,
                         eps)
        return torch.relu(h) if relu else h

    adj = correlation(cfg, w["label_counts"], w["pair_draws"])
    h = conv_bn(image, "stem", 2, True)
    h = F.max_pool2d(_same(h, 3, 2, float("-inf")), 3, 2)
    for p, stride in _structure(cfg):
        sc = conv_bn(h, f"{p}.sc", stride, False) if f"{p}.sc.w" in w else h
        y = conv_bn(h, f"{p}.c1", 1, True)
        y = conv_bn(y, f"{p}.c2", stride, True)
        y = conv_bn(y, f"{p}.c3", 1, False)
        h = torch.relu(y + sc)
    if cfg["image_pooling"] == "max":
        img = h.amax((2, 3))[:, :, None]                      # (B, C, 1)
    else:
        img = h.mean((2, 3))[:, :, None]

    def linear(g, i):
        g = torch.matmul(rnd(g), rnd(w[f"gcn{i}.w"]))
        return g + w[f"gcn{i}.b"] if f"gcn{i}.b" in w else g
    g = torch.matmul(rnd(adj), rnd(emb))
    g = F.leaky_relu(linear(g, 0), float(cfg["leaky_slope"]))
    g = torch.matmul(rnd(adj), rnd(g))
    g = linear(g, 1)
    return torch.matmul(rnd(g), rnd(img))


def forward(cfg, w: dict, requests: list, *, device,
            tf32: bool = False) -> list:
    """Each request's ``(scores,)``, ``scores`` of shape ``(n_labels, 1)``,
    computed ``BLOCK`` requests at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    with torch.no_grad():
        for lo in range(0, len(requests), BLOCK):
            reqs = requests[lo:lo + BLOCK]
            x = torch.from_numpy(np.stack([r["image"] for r in reqs]))
            emb = torch.from_numpy(np.stack([r["label_embeddings"]
                                             for r in reqs]))
            s = scores(cfg, w, x.to(device), emb.to(device), tf32=tf32)
            out += [(v,) for v in s.cpu().numpy()]
    return out


_FLOPS: dict = {}


def flops(cfg, w: dict, request) -> int:
    """The reference's FLOPs for one request: ``FlopCounterMode`` over its
    forward on meta tensors (every b2 request has the same size)."""
    if not _FLOPS:
        from torch.utils.flop_counter import FlopCounterMode
        meta = {k: torch.empty(v.shape, device="meta") for k, v in w.items()}
        x = torch.empty((1, *np.shape(request["image"])), device="meta")
        emb = torch.empty((1, *np.shape(request["label_embeddings"])),
                          device="meta")
        with FlopCounterMode(display=False) as fc:
            scores(cfg, meta, x, emb)
        _FLOPS["b2"] = int(fc.get_total_flops())
    return _FLOPS["b2"]
