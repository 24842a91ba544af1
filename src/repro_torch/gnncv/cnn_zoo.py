"""CNN model zoo (paper scope 1: c1 AlexNet, c2/c3 ResNet-50/101,

Port of ``src/repro/gnncv/cnn_zoo.py`` (numpy/stdlib only; imports rewritten).
c4/c5 VGG-16/19) as GCV-Turbo layer graphs.

Weights are random (the paper evaluates latency/throughput only — compute is
data-independent). Builders expose ``input_hw`` / ``width_mult`` so tests can
instantiate reduced variants; benchmarks use the full published configs.
``add_*_backbone`` variants append the feature extractor to an existing
builder — used by the GNN-CV tasks (b2/b3 use ResNet backbones).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import GraphBuilder


def _rng(seed):
    return np.random.default_rng(seed)


def _conv(b, x, rng, cin, cout, k, *, stride=1, padding="SAME", bn=True,
          act="relu"):
    w = (rng.standard_normal((k, k, cin, cout)) *
         np.sqrt(2.0 / (k * k * cin))).astype(np.float32)
    h = b.conv(x, w, b=np.zeros(cout, np.float32), stride=stride,
               padding=padding)
    if bn:
        h = b.norm(h, scale=np.ones(cout, np.float32),
                   bias=np.zeros(cout, np.float32),
                   mean=np.zeros(cout, np.float32),
                   var=np.ones(cout, np.float32), kind="batch")
    if act:
        h = b.act(h, act)
    return h


def _fc_w(rng, fin, fout):
    return (rng.standard_normal((fin, fout)) *
            np.sqrt(2.0 / fin)).astype(np.float32)


def _fc(b, x, rng, fin, fout, act="relu"):
    w = _fc_w(rng, fin, fout)
    h = b.linear(x, w, b=np.zeros(fout, np.float32))
    if act:
        h = b.act(h, act)
    return h


# ---------------------------------------------------------------- AlexNet --
def alexnet(*, input_hw: int = 224, classes: int = 1000, width_mult=1.0,
            seed: int = 0):
    rng = _rng(seed)
    wm = lambda c: max(8, int(c * width_mult))  # noqa: E731
    b = GraphBuilder("alexnet")
    b.portion = "cnn"
    x = b.input((3, input_hw, input_hw), name="image")
    h = _conv(b, x, rng, 3, wm(96), 11, stride=4, bn=False)
    hw = -(-input_hw // 4)
    h = b.pool(h, window=3, stride=2)
    hw = -(-hw // 2)
    h = _conv(b, h, rng, wm(96), wm(256), 5, bn=False)
    h = b.pool(h, window=3, stride=2)
    hw = -(-hw // 2)
    h = _conv(b, h, rng, wm(256), wm(384), 3, bn=False)
    h = _conv(b, h, rng, wm(384), wm(384), 3, bn=False)
    h = _conv(b, h, rng, wm(384), wm(256), 3, bn=False)
    h = b.pool(h, window=3, stride=2)
    hw = -(-hw // 2)
    h = b.flatten(h)
    flat = wm(256) * hw * hw
    h = _fc(b, h, rng, flat, wm(4096))
    h = _fc(b, h, rng, wm(4096), wm(4096))
    h = _fc(b, h, rng, wm(4096), classes, act=None)
    return b.output(h)


# -------------------------------------------------------------------- VGG --
_VGG_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def vgg(depth: int = 16, *, input_hw: int = 224, classes: int = 1000,
        width_mult=1.0, seed: int = 0):
    rng = _rng(seed)
    wm = lambda c: max(8, int(c * width_mult))  # noqa: E731
    b = GraphBuilder(f"vgg{depth}")
    b.portion = "cnn"
    x = b.input((3, input_hw, input_hw), name="image")
    h, cin, hw = x, 3, input_hw
    for v in _VGG_CFG[depth]:
        if v == "M":
            h = b.pool(h, window=2, stride=2)
            hw = -(-hw // 2)
        else:
            h = _conv(b, h, rng, cin, wm(v), 3, bn=False)
            cin = wm(v)
    h = b.flatten(h)
    h = _fc(b, h, rng, cin * hw * hw, wm(4096))
    h = _fc(b, h, rng, wm(4096), wm(4096))
    h = _fc(b, h, rng, wm(4096), classes, act=None)
    return b.output(h)


# ----------------------------------------------------------------- ResNet --
_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def add_resnet_backbone(b: GraphBuilder, x: str, *, depth: int = 50,
                        width_mult=1.0, seed: int = 0,
                        out_stride: int = 32) -> tuple[str, int, int]:
    """Appends a ResNet-depth backbone. Returns (feature_name, channels,
    spatial_downscale). ``out_stride=16`` keeps stage-4 stride 1 (b3's
    dilated-segmentation variant, spatial map retained)."""
    rng = _rng(seed)
    wm = lambda c: max(8, int(c * width_mult))  # noqa: E731
    b.portion = "cnn"
    h = _conv(b, x, rng, 3, wm(64), 7, stride=2)
    h = b.pool(h, window=3, stride=2)
    cin = wm(64)
    down = 4
    for stage, nblocks in enumerate(_RESNET_BLOCKS[depth]):
        cmid = wm(64 * 2 ** stage)
        cout = cmid * 4
        for blk in range(nblocks):
            stride = 2 if (blk == 0 and stage > 0) else 1
            if stage == 3 and out_stride == 16:
                stride = 1
            if stride == 2:
                down *= 2
            # projection shortcut on first block of each stage
            if blk == 0:
                sc = _conv(b, h, rng, cin, cout, 1, stride=stride, act=None)
            else:
                sc = h
            y = _conv(b, h, rng, cin, cmid, 1)
            y = _conv(b, y, rng, cmid, cmid, 3, stride=stride)
            y = _conv(b, y, rng, cmid, cout, 1, act=None)
            y = b.add(y, sc)
            h = b.act(y, "relu")
            cin = cout
    return h, cin, down


def resnet(depth: int = 50, *, input_hw: int = 224, classes: int = 1000,
           width_mult=1.0, seed: int = 0):
    b = GraphBuilder(f"resnet{depth}")
    x = b.input((3, input_hw, input_hw), name="image")
    h, c, _ = add_resnet_backbone(b, x, depth=depth, width_mult=width_mult,
                                  seed=seed)
    h = b.globalpool(h, kind="avg")
    rng = _rng(seed + 1)
    h = _fc(b, h, rng, c, classes, act=None)
    return b.output(h)


CNN_ZOO = {
    "c1_alexnet": lambda **kw: alexnet(**kw),
    "c2_resnet50": lambda **kw: resnet(50, **kw),
    "c3_resnet101": lambda **kw: resnet(101, **kw),
    "c4_vgg16": lambda **kw: vgg(16, **kw),
    "c5_vgg19": lambda **kw: vgg(19, **kw),
}
