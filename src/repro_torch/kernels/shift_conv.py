"""Shift-add convolution — the paper's Fig. 7 Conv-layer mapping.

Port of ``src/repro/kernels/shift_conv.py`` (``shift_conv2d``).  A 2-D
correlation of one ``(c_in, H, W)`` image, or of a ``(B, c_in, H, W)``
batch, with ``(k1, k2, c_in/groups, c_out)`` weights as k1·k2 shifted GEMMs
accumulated in fp32; the kernel (``csrc/shift_conv.cu``) runs them as one
implicit GEMM, a whole batch in one launch (the reference vmaps its
per-image kernel, ``kernels/ops.py:conv2d``).  SAME padding uses
the reference's arithmetic (TF split, ``before = total // 2``), but in the
kernel as bounds masks rather than a padded copy, and only the strided
outputs are computed.

On a CPU tensor the wrapper runs the plain version (``ref.conv2d_ref``); on
a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


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
    k1, k2, cin_g, cout = w.shape
    c_in, H, W = x.shape[-3:]
    lead = tuple(x.shape[:-3])
    batch = lead[0] if lead else 1
    if c_in != cin_g * groups or cout % groups != 0:
        raise ValueError(f"shift_conv2d: groups={groups} must divide "
                         f"c_in={c_in} (w expects {cin_g} per group) and "
                         f"c_out={cout}")
    if x.device.type == "cpu":
        return ref.conv2d_ref(x, w, stride=stride, padding=padding,
                              groups=groups, dilation=dilation)
    sh, sw = ref.pair(stride)
    dh, dw = ref.pair(dilation)
    ho, wo, pad_t, _, pad_l, _ = ref.conv_geometry(
        H, W, k1, k2, stride=stride, padding=padding, dilation=dilation)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"shift_conv2d: empty output {ho}x{wo}")
    if batch * groups > 65535:                   # the grid's z extent
        raise ValueError(f"shift_conv2d: batch {batch} x groups {groups} "
                         f"exceeds one launch's 65535")
    _build.require_cuda("shift_conv2d", x, w,
                        dtypes=(torch.float32, torch.float32))
    out = torch.empty((*lead, cout, ho, wo), device=x.device,
                      dtype=torch.float32)
    lib = _build.library()
    err = lib.repro_shift_conv2d(
        _build.ptr(x), _build.ptr(w), _build.ptr(out), batch, c_in, H, W,
        k1, k2, cout, groups, ho, wo, sh, sw, dh, dw, pad_t, pad_l,
        _build.stream_of(x))
    _build.check(err, "shift_conv2d")
    shift_conv2d.launches += 1
    return out


shift_conv2d.launches = 0
