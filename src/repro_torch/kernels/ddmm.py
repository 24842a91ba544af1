"""DDMM — dense-dense matrix multiplication with a fused epilogue.

Port of ``src/repro/kernels/ddmm.py`` (``ddmm``).  ``act(x @ y + bias) +
residual`` with fp32 accumulation; the kernel is ``csrc/ddmm.cu``.

On a CPU tensor the wrapper runs the plain version (``ref.ddmm_ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}


def ddmm(x: torch.Tensor, y: torch.Tensor, *, bias=None, residual=None,
         act: str | None = None) -> torch.Tensor:
    """``act(x @ y + bias) + residual``.

    x: ``(M, K)``, y: ``(K, N)``, bias: ``(N,)``, residual: ``(M, N)``, all
    float32.  ``act`` is one of None, relu, gelu (tanh form), silu, tanh.
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
    _build.require_cuda("ddmm", x, y, bias, residual,
                        dtypes=(f32, f32, f32, f32))
    out = torch.empty((M, N), device=x.device, dtype=f32)
    lib = _build.library()
    err = lib.repro_ddmm(_build.ptr(x), _build.ptr(y), _build.ptr(bias),
                         _build.ptr(residual), _build.ptr(out), M, K, N,
                         ACT_CODES[act], _build.stream_of(x))
    _build.check(err, "ddmm")
    ddmm.launches += 1
    return out


ddmm.launches = 0
