"""SDDMM — sampled dense-dense matrix multiplication (the paper's third
primitive): ``mask ⊙ (x @ y)`` for a 0/1 sampling matrix ``mask``.

Port of ``src/repro/kernels/sddmm.py`` (``sddmm``, ``elementwise=True``);
the kernel is ``csrc/sddmm.cu``: DDMM's 3xTF32 tile core on 32x32 output
tiles, K split into up to ``MAX_SPLIT`` chunks summed in order inside one
thread-block cluster (``launch_plan``).  Output tiles of ``BLOCK x BLOCK``
whose mask is all zero do no products and come out as exact zeros, as the
Pallas kernel's dead blocks do; live tiles are multiplied by the mask
element by element, so the result does not depend on the tile size.  The
reference's ``elementwise=False`` (live blocks kept whole, a result that
depends on the TPU's 128x128 blocks) has no caller on any runtime path and
is not ported.

The kernel and its plain version (``ref.sddmm_ref``) differ only on
non-finite inputs: in a dead tile the plain version gives ``NaN·0 = NaN``
where the kernel gives 0, as the Pallas kernel does.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref
# DDMM's tile core (csrc/tf32x3_tile.cuh): K in stages of BK, at most
# MAX_SPLIT chunks (a portable cluster) of at least MIN_CHUNK stages
from repro_torch.kernels.ddmm import BK, MAX_SPLIT, MIN_CHUNK, y_layout

# Output tile edge of csrc/sddmm.cu (``repro_sddmm_block``): the grain at
# which dead tiles are skipped.
BLOCK = 32


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one ``(M, K) @ (K, N)`` call runs: ``k_tiles`` stages of depth
    ``BK``, ``kt_per`` per chunk, ``split`` chunks (one cluster per
    ``BLOCK x BLOCK`` output tile) and the grid ``(n_tiles·split,
    m_tiles)``."""
    k_tiles: int
    kt_per: int
    split: int
    grid: tuple[int, int]
    bm: int = BLOCK
    bn: int = BLOCK

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def launch_plan(m: int, k: int, n: int) -> LaunchPlan:
    """The kernel's plan for ``mask ⊙ ((m, k) @ (k, n))``.

    The split follows ``k`` alone: how many tiles are live depends on the
    mask, which the host does not read, so the tile count is no guide.  K
    falls into as many chunks of ``kt_per >= MIN_CHUNK`` stages as it
    holds, at most ``MAX_SPLIT``; the masked VIP's K = 512 gives 8 chunks
    of 2 stages."""
    k_tiles = max(1, -(-k // BK))
    kt_per = max(min(MIN_CHUNK, k_tiles), -(-k_tiles // MAX_SPLIT))
    split = -(-k_tiles // kt_per)
    return LaunchPlan(k_tiles, kt_per, split,
                      (-(-n // BLOCK) * split, -(-m // BLOCK)))


@functools.lru_cache(maxsize=1024)
def _plan(k: int) -> tuple[int, int]:
    plan = launch_plan(1, k, 1)
    return plan.kt_per, plan.split


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

    x: ``(M, K)`` contiguous, y: ``(K, N)`` row-major or a transposed view
    of a contiguous ``(N, K)`` matrix (the VIP passes ``x.T``), read in
    place; y with other strides is copied to row-major first.  mask:
    ``(M, N)`` contiguous; all float32.
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
    layout = y_layout(y)
    if layout is None:
        y = y.contiguous()
        layout = y_layout(y)
    out = torch.empty((M, N), device=x.device, dtype=f32)
    kt_per, split = _plan(K)
    err = _build.library().repro_sddmm(
        _build.ptr(x), _build.ptr(y), _build.ptr(mask), _build.ptr(out), M,
        K, N, layout[1], int(layout[0]), kt_per, split,
        _build.stream_of(x, "sddmm"))
    _build.check(err, "sddmm")
    _build.counted(sddmm)
    return out


sddmm.launches = sddmm.captured = 0
