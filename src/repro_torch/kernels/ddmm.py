"""DDMM — dense-dense matrix multiplication with a fused epilogue.

Port of ``src/repro/kernels/ddmm.py`` (``ddmm``).  ``act(x @ y + bias) +
residual`` in fp32; the kernel is ``csrc/ddmm.cu``: fp32-accurate products
on the tensor cores (3xTF32), split-K summed in order inside one
thread-block cluster, and a SIMT route for N <= 8.  y may be a transposed
view (a VIP's ``x @ xᵀ``); the kernel reads it through its strides.

``launch_plan`` takes the K chunks (their depth, count and route) from K
and N only, never from M, so a batch of samples stacked along M comes out
as the per-sample products give it, bit for bit.

On a CPU tensor the wrapper runs the plain version (``ref.ddmm_ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, ref

ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
# csrc/ddmm.cu: K in stages of 32; at most 8 chunks (a portable cluster);
# the SIMT route for N <= 8, one warp per row, 4 rows a block.
BK = 32
MAX_SPLIT = 8
NARROW_N = 8
NARROW_ROWS = 4
# The H100's SMs.  A chunk holds at least MIN_CHUNK stages; columns take
# 32-wide tiles up to WIDE_N (more tiles where M is small), 64 above.
SMS = 132
MIN_CHUNK = 2
WIDE_N = 512


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one ``(M, K) @ (K, N)`` call runs: the route (``"mma"``, the
    3xTF32 tile kernel, or ``"narrow"``, one warp per row for N <= 8), the
    block tile ``bm x bn`` (``bm`` rows a block on the narrow route), the
    K stages of depth ``BK``, ``kt_per`` stages per chunk and ``split``
    chunks (one cluster per output tile), and the grid
    ``(n_tiles·split, m_tiles)``."""
    route: str
    bm: int
    bn: int
    k_tiles: int
    kt_per: int
    split: int
    grid: tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(m: int, k: int, n: int) -> LaunchPlan:
    """The kernel's plan for ``(m, k) @ (k, n)``.

    The rule that batching cannot change: route, ``bn``, ``kt_per`` and
    ``split`` follow from ``k`` and ``n`` alone.  Each output element is
    then the same in-order sum of the same K chunks whatever ``m``; only
    the tile height ``bm`` (16, 32 or 64 rows, the least that holds ``m``,
    up to 64) and the grid's second extent follow ``m``, and which block
    computes a chunk does not change its bits.  So ``(4·m, k) @ (k, n)``
    equals four stacked ``(m, k) @ (k, n)`` products bit for bit.

    N <= 8 takes the narrow route.  Otherwise the columns take 32-wide
    tiles up to ``WIDE_N`` and 64-wide above, and K splits into chunks of
    ``kt_per >= MIN_CHUNK`` stages, as many as bring one row of tiles to a
    wave of ``SMS`` blocks, at most ``MAX_SPLIT``: every output tile gets
    at least half of ``min(MAX_SPLIT, ceil(SMS / n_tiles), k_tiles //
    MIN_CHUNK)`` blocks."""
    k_tiles = max(1, _cdiv(k, BK))
    if n <= NARROW_N:
        return LaunchPlan("narrow", NARROW_ROWS, n, k_tiles, k_tiles, 1,
                          (_cdiv(m, NARROW_ROWS), 1))
    bn = 32 if n <= WIDE_N else 64
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    n_tiles = _cdiv(n, bn)
    want = min(MAX_SPLIT, _cdiv(SMS, n_tiles))
    kt_per = max(min(MIN_CHUNK, k_tiles), _cdiv(k_tiles, want))
    split = _cdiv(k_tiles, kt_per)
    return LaunchPlan("mma", bm, bn, k_tiles, kt_per, split,
                      (n_tiles * split, _cdiv(m, bm)))


def y_layout(y: torch.Tensor) -> tuple[bool, int] | None:
    """How the kernel reads ``y`` (K, N): ``(False, ld)`` for rows ``ld``
    apart with unit column stride, ``(True, ld)`` for a transposed view
    (element (k, n) at ``n·ld + k``), None for any other strides."""
    k, n = y.shape
    sk, sn = y.stride()
    if (sn == 1 or n == 1) and (k == 1 or sk >= n):
        return False, sk if k > 1 else n
    if (sk == 1 or k == 1) and (n == 1 or sn >= k):
        return True, sn if n > 1 else k
    return None


@functools.lru_cache(maxsize=4096)
def _params(m: int, k: int, n: int, ld: int, y_t: bool, act: int):
    """The launcher's int parameters for one call signature (a request
    repeats its shapes, so the wrapper's host time is a lookup)."""
    plan = launch_plan(m, k, n)
    return (ctypes.c_int * 11)(
        m, k, n, ld, int(y_t), act, int(plan.route == "narrow"), plan.bm,
        plan.bn, plan.kt_per, plan.split)


def ddmm(x: torch.Tensor, y: torch.Tensor, *, bias=None, residual=None,
         act: str | None = None) -> torch.Tensor:
    """``act(x @ y + bias) + residual``.

    x: ``(M, K)`` contiguous, y: ``(K, N)`` row-major or a transposed view
    of a contiguous ``(N, K)`` matrix, bias: ``(N,)``, residual: ``(M,
    N)``, all float32.  ``act`` is one of None, relu (NaN stays NaN), gelu
    (tanh form), silu, tanh.
    """
    if act not in ACT_CODES:
        raise ValueError(f"ddmm: unknown act {act!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"ddmm: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    M, K = x.shape
    N = y.shape[1]
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"ddmm: bias {tuple(bias.shape)} != ({N},)")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"ddmm: residual {tuple(residual.shape)} != "
                         f"({M}, {N})")
    if x.device.type == "cpu":
        return ref.ddmm_ref(x, y, bias=bias, residual=residual, act=act)
    f32 = torch.float32
    layout = y_layout(y)
    # the common case in one test; the full checks only to name a fault
    if not (x.is_cuda and x.dtype == y.dtype == f32 and y.device == x.device
            and layout is not None and x.is_contiguous()
            and (bias is None or (bias.device == x.device
                                  and bias.dtype == f32
                                  and bias.is_contiguous()))
            and (residual is None or (residual.device == x.device
                                      and residual.dtype == f32
                                      and residual.is_contiguous()))):
        _build.require_cuda("ddmm", x, bias, residual,
                            dtypes=(f32, f32, f32))
        if y.device != x.device:
            raise ValueError(f"ddmm: every operand must be on one CUDA "
                             f"device, got {y.device} and {x.device}")
        if y.dtype != f32:
            raise TypeError(f"ddmm: expected {f32}, got {y.dtype}")
        raise ValueError(f"ddmm: y must be contiguous or a transposed view "
                         f"of a contiguous matrix, got strides {y.stride()}")
    out = torch.empty((M, N), device=x.device, dtype=f32)
    err = _build.library().repro_ddmm(
        x.data_ptr(), y.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        _params(M, K, N, layout[1], layout[0], ACT_CODES[act]),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    if err:
        _build.check(err, "ddmm")
    ddmm.launches += 1
    return out


ddmm.launches = 0
