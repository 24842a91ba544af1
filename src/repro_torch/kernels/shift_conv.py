"""Shift-add convolution — the paper's Fig. 7 Conv-layer mapping.

Port of ``src/repro/kernels/shift_conv.py`` (``shift_conv2d``).  A 2-D
correlation of one ``(c_in, H, W)`` image, or of a ``(B, c_in, H, W)``
batch, with ``(k1, k2, c_in/groups, c_out)`` weights as k1·k2 shifted GEMMs
accumulated in fp32; the kernel (``csrc/shift_conv.cu``) runs them as one
implicit GEMM on the tensor cores in 3xTF32 (each fp32 operand split into
two TF32 parts, three products: fp32-level accuracy), a whole batch in one
launch (the reference vmaps its per-image kernel, ``kernels/ops.py:conv2d``).
SAME padding uses the reference's arithmetic (TF split, ``before = total //
2``), but in the kernel as bounds masks rather than a padded copy, and only
the strided outputs are computed.

``launch_plan`` chooses the kernel's pixel tile and its split-K factor from
the per-image problem alone, never from the batch, so each image of a batch
comes out as the 3-D call on that image gives it, bit for bit.

On a CPU tensor the wrapper runs the plain version (``ref.conv2d_ref``); on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref

# csrc/shift_conv.cu's block tiles: 64 or 32 output channels by 64 or 32
# pixels, K in steps of 32.
BK = 32
# The H100's SMs.  Split K until a call's blocks fill two waves of them.  A
# shallow K (at most SHALLOW tiles) is not split (a split costs more than
# the blocks it adds) but takes narrow tiles until one wave is full.  A
# sweep over every tile and split of the b1-b5 layers on the H100
# (``chip_smoke.py --conv-sweep``) put this rule within 10% of the best
# choice per layer on b2, b3 and b4 (PERF.md).
SMS = 132
SHALLOW = 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: the block tile ``bm x bn`` (output channels x
    pixels), the K tiles of depth ``BK`` and the split-K factor (a divisor
    of ``k_tiles``; block s sums its share of them, a second kernel adds
    the ``split`` partials in order), whether the conv is a 1x1 stride-1
    "dense" one (X read as a plain matrix), and the grid
    ``(m_tiles·n_tiles·split, batch·groups)``."""
    bm: int
    bn: int
    k_tiles: int
    split: int
    dense: bool
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(x_shape, w_shape, *, stride=1, padding: str = "SAME",
                groups: int = 1, dilation=(1, 1)) -> LaunchPlan:
    """The kernel's plan for ``shift_conv2d(x, w, ...)`` with x of
    ``x_shape`` (3-D or 4-D) and w of ``w_shape``.  Tile and split follow
    from the per-image problem alone; the batch sets only ``grid[1]``.
    Narrow planes (at most 256 pixels: ResNet's 14x14 and 7x7) and shallow
    K take 32-pixel tiles; at most 32 output channels, or a shallow K whose
    tiles fall short of a wave, take 32-channel tiles.  The split is the
    least divisor of the K tiles that brings the blocks to two waves of
    ``SMS`` (one wave where K is shallow); where none does, every block
    takes one K tile."""
    k1, k2, cin_g, cout = w_shape
    H, W = x_shape[-2:]
    batch = x_shape[0] if len(x_shape) == 4 else 1
    ho, wo, *_ = ref.conv_geometry(H, W, k1, k2, stride=stride,
                                   padding=padding, dilation=dilation)
    og, npix = cout // groups, ho * wo
    k_tiles = _cdiv(k1 * k2 * cin_g, BK)
    shallow = k_tiles <= SHALLOW
    bn = 32 if npix <= 256 or shallow else 64
    bm = 32 if og <= 32 or (
        shallow and _cdiv(og, 64) * _cdiv(npix, bn) < SMS) else 64
    tiles = _cdiv(og, bm) * _cdiv(npix, bn)
    target = SMS if shallow else 2 * SMS
    split = next((s for s in range(1, k_tiles + 1)
                  if k_tiles % s == 0 and tiles * s >= target), k_tiles)
    dense = (k1, k2) == (1, 1) and ref.pair(stride) == (1, 1)
    return LaunchPlan(bm, bn, k_tiles, split, dense,
                      (tiles * split, batch * groups))


@functools.lru_cache(maxsize=4096)
def _launch(x_shape, w_shape, stride, padding, groups, dilation):
    """Everything one call signature needs, validated once: the shape of
    the buffer of ``split`` output slabs and the launcher's int parameters
    (a request repeats its shapes, so the wrapper's host time is a
    lookup)."""
    k1, k2, _, cout = w_shape
    c_in, H, W = x_shape[-3:]
    batch = x_shape[0] if len(x_shape) == 4 else 1
    ho, wo, pad_t, _, pad_l, _ = ref.conv_geometry(
        H, W, k1, k2, stride=stride, padding=padding, dilation=dilation)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"shift_conv2d: empty output {ho}x{wo}")
    if batch * groups > 65535:                   # the grid's y extent
        raise ValueError(f"shift_conv2d: batch {batch} x groups {groups} "
                         f"exceeds one launch's 65535")
    plan = launch_plan(x_shape, w_shape, stride=stride, padding=padding,
                       groups=groups, dilation=dilation)
    params = (ctypes.c_int * 20)(
        batch, c_in, H, W, k1, k2, cout, groups, ho, wo, *stride,
        *dilation, pad_t, pad_l, plan.bm, plan.bn, plan.split,
        int(plan.dense))
    return (plan.split, *x_shape[:-3], cout, ho, wo), params


def shift_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                 padding: str = "SAME", groups: int = 1,
                 dilation=(1, 1)) -> torch.Tensor:
    """x: ``(c_in, H, W)`` or ``(B, c_in, H, W)``, w: ``(k1, k2, c_in //
    groups, c_out)`` -> ``(c_out, H_out, W_out)`` or ``(B, c_out, H_out,
    W_out)``.  ``stride``/``dilation`` may be an int or a pair; ``padding``
    is ``"SAME"`` or ``"VALID"``.  Each image of a batch comes out as the
    3-D call on that image gives it, bit for bit."""
    if x.ndim not in (3, 4) or w.ndim != 4:
        raise ValueError(f"shift_conv2d: x {tuple(x.shape)} must be "
                         f"([B,] c_in, H, W), w {tuple(w.shape)} "
                         f"(k1, k2, ci, co)")
    _, _, cin_g, cout = w.shape
    c_in = x.shape[-3]
    if c_in != cin_g * groups or cout % groups != 0:
        raise ValueError(f"shift_conv2d: groups={groups} must divide "
                         f"c_in={c_in} (w expects {cin_g} per group) and "
                         f"c_out={cout}")
    if x.device.type == "cpu":
        return ref.conv2d_ref(x, w, stride=stride, padding=padding,
                              groups=groups, dilation=dilation)
    if not (x.is_cuda and x.dtype == w.dtype == torch.float32
            and w.device == x.device and x.is_contiguous()
            and w.is_contiguous()):
        _build.require_cuda("shift_conv2d", x, w,
                            dtypes=(torch.float32, torch.float32))
    buf_shape, params = _launch(tuple(x.shape), tuple(w.shape),
                                ref.pair(stride), padding, groups,
                                ref.pair(dilation))
    # split-K partials go to slabs 0..split-1 of one buffer and are summed
    # into slab 0, which is the output: one allocation a call
    buf = x.new_empty(buf_shape)
    err = _build.library().repro_shift_conv2d(
        x.data_ptr(), w.data_ptr(), buf.data_ptr(), params,
        _build.stream_of(x, "shift_conv2d"))
    _build.check(err, "shift_conv2d")
    _build.counted(shift_conv2d)
    return buf.select(0, 0)


shift_conv2d.launches = shift_conv2d.captured = 0
