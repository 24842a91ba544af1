"""Flash attention — the fused SDDMM + softmax + SpDMM of the paper's
primitive vocabulary on the LM serving path: causal (or not) GQA attention
with an online softmax, so the ``(Sq, Sk)`` score matrix never reaches
device memory.

Port of ``src/repro/kernels/flash_attention.py`` (``flash_attention``);
the kernel is ``csrc/flash_attention.cu``.  v's head dim may differ from
q's and k's (MLA: q·k over 192, v of 128; ``MAX_D``).  Query i sees keys
``j <= i + (Sk - Sq)`` when ``causal`` (the decode / prefill-continuation
convention), key tiles above the diagonal are skipped, the running max,
sum and accumulator stay in fp32, and a row with no live key returns 0.
The plain version is ``ref.attention_ref``.  The reference's ``bq``/``bk``
tile sizes and ``interpret`` flag have no counterpart: the CUDA kernels'
tiles are fixed and do not change the result beyond rounding.  bf16 runs on
the tensor cores (64 queries x 64 keys, bf16 MMAs with fp32 accumulation,
p in three bf16 parts, fp32-level, k and v staged by 16-byte copies);
fp32 runs on the SIMT kernel (64 queries x 32 keys).

Training (``flash_attention_fwd(return_lse=True)``, ``flash_attention_bwd``,
``FlashAttentionFn``): the forward also writes each row's log-sum-exp
(fp32 ``(B, Hq, Sq)``), and the backward kernel ``csrc/flash_attention_bwd.cu``
recomputes the scores from q, k and it to give dq, dk and dv: the port of
the reference's ``models/attention.py:_flash_bwd``, the backward of
``flash_attention_xla``.  Its plain version is ``ref.attention_bwd_ref``.
bf16 runs FlashAttention-2's deterministic backward on the tensor cores
(one kernel per 32-key tile for dk and dv, one per 64-query tile for dq,
p and ds in two bf16 parts, tiles staged by 16-byte copies, no atomics);
fp32 runs the SIMT kernels.  The backward takes the forward's head-dim
pairs (``MAX_D_BWD``), MLA's (192, 128) among them.  In bf16 both
directions need every operand 16-byte aligned and raise otherwise.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each kernel's launch is a custom op
(``torch.ops.repro_torch.flash_fwd`` / ``flash_bwd``), whose fake
implementation returns what the kernel writes (shapes, dtypes and
layouts: ``_out_like``'s output, the fp32 LSE, dq, dk and dv like q, k
and v) and whose FLOP formula is the kernel table's operation count
(``flash_fwd_flops``, ``flash_bwd_flops``), so fake and ``meta`` tensors
(the dry run's, ``launch/dryrun.py``) pass through the card's path, and
``FlopCounterMode`` counts the kernels.  A meta tensor goes to the custom
op like a CUDA one; no launch is counted.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref

# The (q·k head dim, v head dim) limits of csrc/flash_attention.cu's
# instantiations (``repro_flash_takes``): a call is taken where both fit
# one pair.  (192, 128) is MLA's nope 128 + rope 64 with v's 128.
MAX_D = ((128, 128), (192, 128))
# The (q·k head dim, v head dim) limits of csrc/flash_attention_bwd.cu's
# instantiations (``repro_flash_bwd_takes``): the forward's pairs.
MAX_D_BWD = ((128, 128), (192, 128))
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def takes(d: int, dv: int, pairs=MAX_D) -> bool:
    """Whether the forward kernel (or, with ``pairs=MAX_D_BWD``, the
    backward) takes q·k's head dim ``d`` with v's ``dv``."""
    return d >= 1 and dv >= 1 and any(d <= a and dv <= b for a, b in pairs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q: ``(B, Hq, Sq, D)``; k: ``(B, Hkv, Sk, D)``; v: ``(B, Hkv, Sk,
    DV)``; ``Hq % Hkv == 0``; on the card ``(D, DV)`` within one pair of
    ``MAX_D``.

    Any batch, head and sequence strides (a permuted ``(B, S, H, D)``
    activation is read in place); the head dim must be contiguous on the
    card, and in bf16 every base and stride must be 16-byte aligned (D and
    DV multiples of 8), for the kernel's 16-byte copies.  Returns ``(B, Hq,
    Sq, DV)`` in q's dtype, laid out like q.  ``scale`` defaults to
    ``1/sqrt(D)``.
    """
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)


def _check_heads(name: str, q, k, v):
    """-> ``(B, Hq, Hkv, Sq, Sk, D, DV)``: k and v share batch, heads and
    length, q and k the head dim D; v's DV is its own."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: q{tuple(q.shape)} does not fit "
                         f"k{tuple(k.shape)}")
    return B, Hq, Hkv, Sq, Sk, D, v.shape[3]


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty ``(B, Hq, Sq, dv)`` laid out as q: its first three axes in
    q's stride order, the head dim contiguous."""
    order = sorted(range(3), key=q.stride, reverse=True)
    out = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype,
                      device=q.device)
    return out.permute(*(order.index(i) for i in range(3)), 3)


def _check_card(name: str, q, *others) -> None:
    """What both kernels take: one CUDA device, one supported dtype, the
    head dim contiguous, int32-indexable sizes."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {list(DTYPES)}")
    for oname, t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device, got {oname} on {t.device} and q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {oname} is {t.dtype}, q is {q.dtype}")
    tensors = (q, *(t for _, t in others))
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in tensors):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError(f"{name}: operand too large for int32 indexing")


def _misaligned(t: torch.Tensor) -> bool:
    """Whether a bf16 operand fails the kernels' 16-byte copies: its head
    dim off a multiple of 8, its base or a batch, head or sequence stride
    (of an axis longer than 1) off a 16-byte boundary."""
    return t.dtype == torch.bfloat16 and bool(
        t.shape[3] % 8 or t.data_ptr() % 16 or any(
            st % 8 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def _check_aligned(name: str, *operands) -> None:
    """Raise on the first bf16 operand ``_misaligned`` finds: the kernels
    take no other, and nothing routes it elsewhere."""
    for oname, t in operands:
        if _misaligned(t):
            raise ValueError(
                f"{name}: bf16 {oname} must be 16-byte aligned (base, and "
                f"the strides of batch, head and sequence; D % 8 == 0) for "
                f"the kernel's 16-byte copies, got D={t.shape[3]}, strides "
                f"{t.stride()}, base {t.data_ptr() % 16} bytes past a "
                f"16-byte boundary")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        return_lse: bool = False):
    """``flash_attention``; with ``return_lse`` also each row's
    log-sum-exp of the scaled scores, fp32 ``(B, Hq, Sq)`` contiguous
    (``-inf`` for a row with no live key): ``(out, lse)``.  One launch,
    counted in ``flash_attention.launches``."""
    B, Hq, Hkv, Sq, Sk, D, DV = _check_heads("flash_attention", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        if return_lse:
            return ref.attention_lse_ref(q, k, v, causal=causal, scale=scale)
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    if not takes(D, DV):
        raise ValueError(f"flash_attention: head dims (q·k {D}, v {DV}) "
                         f"fit none of the kernel's {MAX_D}")
    _check_card("flash_attention", q, ("k", k), ("v", v))
    _check_aligned("flash_attention", ("q", q), ("k", k), ("v", v))
    out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, scale,
                                               return_lse)
    return (out, lse) if return_lse else out


def _lse_like(q: torch.Tensor, with_lse: bool) -> torch.Tensor:
    """The forward's fp32 LSE ``(B, Hq, Sq)``, contiguous, or an empty
    ``(0,)`` where the call writes none."""
    shape = q.shape[:3] if with_lse else (0,)
    return torch.empty(shape, dtype=torch.float32, device=q.device)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float,
               with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch (``flash_attention_fwd`` checks the
    operands first): ``(out, lse)``, ``lse`` empty without ``with_lse``."""
    B, Hq, Hkv, Sq, Sk, D, DV = _check_heads("flash_attention", q, k, v)
    out = _out_like(q, DV)
    _check_aligned("flash_attention", ("out", out))
    lse = _lse_like(q, with_lse)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = _build.library().repro_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse if with_lse else None), DTYPES[q.dtype], B, Hq, Hkv,
        Sq, Sk, D, DV, int(causal), ctypes.c_float(scale), *strides,
        _build.stream_of(q, "flash_attention"))
    _build.check(err, "flash_attention")
    _build.counted(flash_attention)
    return out, lse


@_flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, with_lse):
    """What the kernel writes, shapes and layouts only."""
    return _out_like(q, v.shape[3]), _lse_like(q, with_lse)


flash_attention.launches = flash_attention.captured = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        scale: float | None = None):
    """dq, dk, dv of ``flash_attention(q, k, v)`` given its ``out``, the
    ``lse`` of ``flash_attention_fwd(return_lse=True)`` and the incoming
    gradient ``dout`` (shaped like q).  Each comes out in its input's dtype
    and layout.  q, k, v, out and dout may have any batch, head and
    sequence strides; on the card their head dim must be contiguous, and
    in bf16 every base and stride must be 16-byte aligned (D a multiple of
    8), as in the forward (fp32 takes any alignment, stride 0 included).
    One call launches three kernels (delta, dk/dv, dq) and counts one
    launch in ``flash_attention_bwd.launches``.  v's head dim DV may differ
    from D (``out``, ``dout`` and dv then have DV); on the card ``(D, DV)``
    must fit one pair of ``MAX_D_BWD`` (MLA's (192, 128) included), else
    ``ValueError``."""
    B, Hq, Hkv, Sq, Sk, D, DV = _check_heads("flash_attention_bwd", q, k, v)
    if out.shape != (B, Hq, Sq, DV) or dout.shape != out.shape:
        raise ValueError(f"flash_attention_bwd: out{tuple(out.shape)} and "
                         f"dout{tuple(dout.shape)} must be "
                         f"{(B, Hq, Sq, DV)}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 "
                         f"{(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                     scale=scale)
    if not takes(D, DV, MAX_D_BWD):
        raise ValueError(f"flash_attention_bwd: head dims (q·k {D}, v {DV}) "
                         f"fit none of the kernel's {MAX_D_BWD}")
    _check_card("flash_attention_bwd", q, ("k", k), ("v", v), ("out", out),
                ("dout", dout))
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous, on "
                         "q's device")
    _check_aligned("flash_attention_bwd", ("q", q), ("k", k), ("v", v),
                   ("out", out), ("dout", dout))
    return torch.ops.repro_torch.flash_bwd(q, k, v, out, lse, dout, causal,
                                           scale)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               causal: bool, scale: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' launch (``flash_attention_bwd`` checks the
    operands first): ``(dq, dk, dv)``."""
    B, Hq, Hkv, Sq, Sk, D, DV = _check_heads("flash_attention_bwd", q, k, v)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _check_aligned("flash_attention_bwd", ("dq", dq), ("dk", dk), ("dv", dv))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in t.stride()[:3]))
    err = _build.library().repro_flash_attention_bwd(
        *(_build.ptr(t) for t in (q, k, v, out, dout, lse, dq, dk, dv,
                                  delta)),
        DTYPES[q.dtype], B, Hq, Hkv, Sq, Sk, D, DV, int(causal),
        ctypes.c_float(scale), strides,
        _build.stream_of(q, "flash_attention_bwd"))
    _build.check(err, "flash_attention_bwd")
    _build.counted(flash_attention_bwd)
    return dq, dk, dv


@_flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, out, lse, dout, causal, scale):
    """What the kernels write, shapes and layouts only (their ``delta``
    scratch is freed within the call)."""
    return tuple(torch.empty_like(t) for t in (q, k, v))


flash_attention_bwd.launches = flash_attention_bwd.captured = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the port's counterpart of the
    reference's ``flash_attention_xla`` (``models/attention.py:183``, a
    ``jax.custom_vjp``).  The forward runs ``flash_attention_fwd`` and
    saves q, k, v, out and the LSE; the backward runs
    ``flash_attention_bwd`` (the kernel on CUDA tensors, the plain version
    on CPU tensors).  q ``(B, Hq, Sq, D)``, k ``(B, Hkv, Sk, D)`` and v
    ``(B, Hkv, Sk, DV)`` in any strides, as the forward takes them.  A ``dout`` whose head dim is
    not contiguous (an expanded gradient, e.g. of ``out.sum()``), or, in
    bf16 on the card, is not 16-byte aligned, is copied to a fresh
    contiguous tensor before the kernel reads it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                scale: float | None = None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if (dout.stride(3) != 1 and dout.shape[3] > 1) or (
                dout.device.type != "cpu" and _misaligned(dout)):
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def live_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: every pair, or under the
    diagonal when causal (query i sees keys ``j <= i + sk - sq``)."""
    if not causal:
        return sq * sk
    off = sk - sq
    if off >= 0:                  # row i sees i + off + 1 keys
        return sq * (2 * off + sq + 1) // 2
    return sk * (sk + 1) // 2     # rows before -off see none


def flash_fwd_flops(q_shape, k_shape, v_shape, causal: bool) -> int:
    """The forward's operations: 2·(D + DV) a live (query, key) pair and
    q head, the count of the kernel table's bound (``chip_smoke.py``'s
    ``flash_case``)."""
    B, Hq, Sq, D = q_shape
    return 2 * (D + v_shape[3]) * B * Hq * live_pairs(Sq, k_shape[2], causal)


def flash_bwd_flops(q_shape, k_shape, v_shape, causal: bool) -> int:
    """The backward's operations: five products a live pair and q head,
    q·kᵀ, dq and dk of 2·D operations, dO·vᵀ and dv of 2·DV (the count
    of ``flash_bwd_case``'s bound, not what the kernel issues)."""
    B, Hq, Sq, D = q_shape
    return 2 * (3 * D + 2 * v_shape[3]) * B * Hq * live_pairs(
        Sq, k_shape[2], causal)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_formula(q_shape, k_shape, v_shape, causal, *args,
                       **kwargs) -> int:
    return flash_fwd_flops(q_shape, k_shape, v_shape, causal)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_formula(q_shape, k_shape, v_shape, o_shape, lse_shape,
                       dout_shape, causal, *args, **kwargs) -> int:
    return flash_bwd_flops(q_shape, k_shape, v_shape, causal)
