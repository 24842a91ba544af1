"""Flash attention — the fused SDDMM + softmax + SpDMM of the paper's
primitive vocabulary on the LM serving path: causal (or not) GQA attention
with an online softmax, so the ``(Sq, Sk)`` score matrix never reaches
device memory.

Port of ``src/repro/kernels/flash_attention.py`` (``flash_attention``);
the kernel is ``csrc/flash_attention.cu``.  Query i sees keys
``j <= i + (Sk - Sq)`` when ``causal`` (the decode / prefill-continuation
convention), key tiles above the diagonal are skipped, the running max,
sum and accumulator stay in fp32, and a row with no live key returns 0.
The plain version is ``ref.attention_ref``.  The reference's ``bq``/``bk``
tile sizes and ``interpret`` flag have no counterpart: the CUDA kernels'
tiles are fixed and do not change the result beyond rounding.  bf16 runs on
the tensor cores (64 queries x 64 keys, bf16 MMAs with fp32 accumulation,
p in three bf16 parts, fp32-level, k and v staged by 16-byte copies);
fp32 runs on the SIMT kernel (64 queries x 32 keys).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

# Largest head dim csrc/flash_attention.cu takes (``repro_flash_max_d``).
MAX_D = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: ``(B, Hq, Sq, D)``; k, v: ``(B, Hkv, Sk, D)``; ``Hq % Hkv == 0``.

    Any batch, head and sequence strides (a permuted ``(B, S, H, D)``
    activation is read in place); the head dim must be contiguous on the
    card, and in bf16 every base and stride must be 16-byte aligned (D a
    multiple of 8), for the kernel's 16-byte copies.  Returns q's dtype,
    laid out like q.  ``scale`` defaults to ``1/sqrt(D)``.
    """
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not fit "
                         f"k/v{tuple(k.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    if D > MAX_D:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_D}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{list(DTYPES)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: every operand must be on "
                             f"one CUDA device, got {name} on {t.device} "
                             f"and q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if any(t.numel() >= 2**31 for t in (q, k, v)):
        raise ValueError("flash_attention: operand too large for int32 "
                         "indexing")
    out = torch.empty_like(q)               # q's layout: strides preserved
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if D % 8 or t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1):
                raise ValueError(
                    f"flash_attention: bf16 {name} must be 16-byte aligned "
                    f"(base, and the strides of batch, head and sequence; "
                    f"D % 8 == 0) for the kernel's 16-byte copies, got D={D}, "
                    f"strides {t.stride()}, base {t.data_ptr() % 16} bytes "
                    f"past a 16-byte boundary")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _build.library().repro_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, D, int(causal),
        ctypes.c_float(scale), *strides, _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
