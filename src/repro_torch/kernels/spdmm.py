"""SpDMM — ELL sparse x dense matrix multiplication.

Port of ``src/repro/kernels/spdmm.py`` (``spdmm``).  ``Z[i, :] =
Σ_l val[i, l] · Y[idx[i, l], :]`` with fp32 accumulation; padding slots
carry ``val == 0``.  The kernel is ``csrc/spdmm.cu``.  The offline
``dense_to_ell`` conversion lives in the compiler
(``core/passes/select.py``).

On a CPU tensor the wrapper runs the plain version (``ref.spdmm_ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


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
