"""SpDMM — ELL sparse x dense matrix multiplication.

Port of ``src/repro/kernels/spdmm.py`` (``spdmm``).  ``Z[i, :] =
Σ_l val[i, l] · Y[idx[i, l], :]`` with fp32 accumulation; padding slots
carry ``val == 0``; an out-of-range ``idx`` is skipped.  The kernels are in
``csrc/spdmm.cu``.  The offline ``dense_to_ell`` conversion lives in the
compiler (``core/passes/select.py``).

Two entries: ``spdmm(idx, val, y)`` keeps the JAX signature (``y`` is
``(S2, N)``); ``spdmm_rows(idx, val, x2)`` computes the same function in
the layout the runtime has, ``x2 = yᵀ`` of shape ``(R, S2)`` in and
``Zᵀ`` of shape ``(R, S1)`` out, with no transposing copy either way (b4's
``(C·T, V)`` view of its activation).

On a CPU tensor each wrapper runs its plain version (``ref.spdmm_ref``,
``ref.spdmm_rows_ref``); on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# csrc/spdmm.cu's rows kernel: a block stages ``rows`` rows of x2 (a
# multiple of 4, at most ROWS) and the ELL pairs in at most SMEM bytes of
# shared memory.  ROWS = 32 gives b4's (9600-19200, 25) views 300-600
# blocks of 128 threads: several per SM.
ROWS = 32
SMEM = 48 * 1024


def rows_per_block(s1: int, ell_l: int, s2: int) -> int:
    """x2 rows per block of the rows kernel: ``ROWS``, or fewer (a multiple
    of 4) where rows of ``s2`` floats and the ELL pairs would outgrow
    ``SMEM``; 0 if not even 4 rows fit."""
    fit = (SMEM - 8 * s1 * ell_l) // (4 * max(s2, 1))
    return min(ROWS, fit // 4 * 4)


def spdmm(idx: torch.Tensor, val: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """ELL sparse ``(S1, L)`` @ dense ``(S2, N)`` -> ``(S1, N)``.

    ``idx`` is int32, ``val`` and ``y`` float32."""
    if idx.ndim != 2 or idx.shape != val.shape or y.ndim != 2:
        raise ValueError(f"spdmm: bad shapes idx {tuple(idx.shape)}, val "
                         f"{tuple(val.shape)}, y {tuple(y.shape)}")
    if y.device.type == "cpu":
        return ref.spdmm_ref(idx, val, y)
    _build.require_cuda("spdmm", y, idx, val,
                        dtypes=(torch.float32, torch.int32, torch.float32))
    S1, L = idx.shape
    S2, N = y.shape
    out = torch.empty((S1, N), device=y.device, dtype=torch.float32)
    lib = _build.library()
    err = lib.repro_ell_spdmm(_build.ptr(idx), _build.ptr(val),
                              _build.ptr(y), _build.ptr(out), S1, L, S2, N,
                              _build.stream_of(y))
    _build.check(err, "spdmm")
    spdmm.launches += 1
    return out


spdmm.launches = 0


def spdmm_rows(idx: torch.Tensor, val: torch.Tensor,
               x2: torch.Tensor) -> torch.Tensor:
    """``out[r, i] = Σ_l val[i, l] · x2[r, idx[i, l]]``, summed over l in
    order: ELL ``(S1, L)`` against ``x2`` of shape ``(R, S2)``, row-major,
    -> ``(R, S1)``.  It is ``spdmm(idx, val, x2ᵀ)ᵀ``.

    ``idx`` is int32, ``val`` and ``x2`` float32."""
    if idx.ndim != 2 or idx.shape != val.shape or x2.ndim != 2:
        raise ValueError(f"spdmm_rows: bad shapes idx {tuple(idx.shape)}, "
                         f"val {tuple(val.shape)}, x2 {tuple(x2.shape)}")
    if x2.device.type == "cpu":
        return ref.spdmm_rows_ref(idx, val, x2)
    _build.require_cuda("spdmm_rows", x2, idx, val,
                        dtypes=(torch.float32, torch.int32, torch.float32))
    S1, L = idx.shape
    R, S2 = x2.shape
    rows = rows_per_block(S1, L, S2)
    if rows < 4:
        raise ValueError(f"spdmm_rows: x2 rows of {S2} floats and {S1}x{L} "
                         f"ELL pairs outgrow one block's shared memory")
    out = torch.empty((R, S1), device=x2.device, dtype=torch.float32)
    err = _build.library().repro_ell_spdmm_rows(
        idx.data_ptr(), val.data_ptr(), x2.data_ptr(), out.data_ptr(), R, S1,
        L, S2, rows, _build.stream_of(x2))
    _build.check(err, "spdmm_rows")
    spdmm_rows.launches += 1
    return out


spdmm_rows.launches = 0
