"""SDDMM — sampled dense-dense matrix multiplication (the paper's third
primitive): ``mask ⊙ (x @ y)`` for a 0/1 sampling matrix ``mask``.

Port of ``src/repro/kernels/sddmm.py`` (``sddmm``, ``elementwise=True``);
the kernel is ``csrc/sddmm.cu``.  Output tiles of ``BLOCK x BLOCK`` whose
mask is all zero do no products and come out as exact zeros, as the Pallas
kernel's dead blocks do; live tiles are multiplied by the mask element by
element, so the result does not depend on the tile size.  The reference's
``elementwise=False`` (live blocks kept whole, a result that depends on the
TPU's 128x128 blocks) has no caller on any runtime path and is not ported.

The kernel and its plain version (``ref.sddmm_ref``) differ only on
non-finite inputs: in a dead tile the plain version gives ``NaN·0 = NaN``
where the kernel gives 0, as the Pallas kernel does.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Output tile edge of csrc/sddmm.cu (``repro_sddmm_block``): the grain at
# which dead tiles are skipped.
BLOCK = 32


def live_tiles(mask: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Bool ``(ceil(M/block), ceil(N/block))``: the output tiles the kernel
    computes (those where ``mask`` has a nonzero)."""
    m, n = mask.shape
    pad = torch.zeros((-(-m // block) * block, -(-n // block) * block),
                      dtype=torch.bool, device=mask.device)
    pad[:m, :n] = mask != 0
    return pad.reshape(pad.shape[0] // block, block,
                       pad.shape[1] // block, block).any(3).any(1)


def sddmm(x: torch.Tensor, y: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """``mask ⊙ (x @ y)`` in fp32.

    x: ``(M, K)`` contiguous, y: ``(K, N)`` with any strides (the VIP passes
    ``x.T``, a view), mask: ``(M, N)`` contiguous; all float32.
    """
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"sddmm: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    M, K = x.shape
    N = y.shape[1]
    if tuple(mask.shape) != (M, N):
        raise ValueError(f"sddmm: mask {tuple(mask.shape)} != ({M}, {N})")
    if x.device.type == "cpu":
        return ref.sddmm_ref(x, y, mask)
    f32 = torch.float32
    _build.require_cuda("sddmm", x, mask, dtypes=(f32, f32))
    if y.device != x.device or y.dtype != f32:
        raise TypeError(f"sddmm: y must be float32 on {x.device}, got "
                        f"{y.dtype} on {y.device}")
    out = torch.empty((M, N), device=x.device, dtype=f32)
    lib = _build.library()
    err = lib.repro_sddmm(_build.ptr(x), _build.ptr(y), _build.ptr(mask),
                          _build.ptr(out), M, K, N, y.stride(0), y.stride(1),
                          _build.stream_of(x))
    _build.check(err, "sddmm")
    sddmm.launches += 1
    return out


sddmm.launches = 0
