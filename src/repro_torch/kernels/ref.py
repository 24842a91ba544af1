"""Plain-PyTorch versions of the port's kernels — port of
``src/repro/kernels/ref.py`` (``ddmm_ref``, ``spdmm_ref``, ``sddmm_ref``,
``conv2d_ref``, ``attention_ref``), plus ``spdmm_rows_ref``, the ELL
product in the runtime's ``(R, S2)`` layout, and the training path's two
attention twins: ``attention_lse_ref`` (the forward with its log-sum-exp)
and ``attention_bwd_ref`` (the math of the reference's
``models/attention.py:_flash_bwd``).

Each ``*_ref`` computes what its hand-written CUDA kernel computes, in the
reference's layouts, with ordinary torch ops:

  * conv activations ``(c_in, H, W)`` or ``(B, c_in, H, W)``, conv weights
    ``(k1, k2, c_in / groups, c_out)``;
  * ELL ``(S1, L)`` index/value arrays with ``val == 0`` in padding slots;
  * KNN points ``(N, F)``, int32 ``(N, k)`` neighbor indices;
  * attention ``(B, Hq, Sq, D)`` queries against ``(B, Hkv, Sk, D)`` keys
    and values.

They serve three roles: the CPU path of every kernel wrapper, the ``torch_*``
realizations of the Step-4b lattice, and the yardstick ``chip_smoke.py``
holds each kernel against on the card.  ``conv2d_ref`` is written as the
explicit shift-GEMM (one strided slice per tap, one matmul per group) so it
repeats the kernel's arithmetic rather than calling a library convolution.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# jax.nn.gelu defaults to the tanh approximation; the port keeps it.
ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv_geometry(h: int, w: int, k1: int, k2: int, *, stride, padding: str,
                  dilation) -> tuple[int, int, int, int, int, int]:
    """-> ``(ho, wo, pad_top, pad_bottom, pad_left, pad_right)``.

    SAME follows the reference's arithmetic (``shift_conv.py``): total pad
    ``max((ceil(H/s) - 1)·s + ke - H, 0)`` with ``ke`` the dilated kernel
    extent, split TF-style (``before = total // 2``)."""
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    ke1, ke2 = (k1 - 1) * dh + 1, (k2 - 1) * dw + 1
    if padding == "SAME":
        ho, wo = -(-h // sh), -(-w // sw)
        ph = max((ho - 1) * sh + ke1 - h, 0)
        pw = max((wo - 1) * sw + ke2 - w, 0)
        return ho, wo, ph // 2, ph - ph // 2, pw // 2, pw - pw // 2
    if padding == "VALID":
        return (h - ke1) // sh + 1, (w - ke2) // sw + 1, 0, 0, 0, 0
    raise ValueError(padding)


def ddmm_ref(x, y, *, bias=None, residual=None, act=None):
    """``act(x @ y + bias) + residual``; x ``(M, K)``, y ``(K, N)``."""
    out = x @ y
    if bias is not None:
        out = out + bias
    out = ACTS[act](out)
    if residual is not None:
        out = out + residual
    return out


def spdmm_ref(idx, val, y):
    """ELL sparse @ dense: ``Z[i] = Σ_l val[i, l] · y[idx[i, l]]``; a slot
    whose ``idx`` is out of range adds nothing."""
    ok = (idx >= 0) & (idx < y.shape[0])
    rows = y[torch.where(ok, idx, 0).long()]             # (S1, L, N)
    return torch.where(ok[..., None], rows * val[..., None], 0.0).sum(1)


def spdmm_rows_ref(idx, val, x2):
    """The same product in the runtime's layout: ``out[r, i] = Σ_l
    val[i, l] · x2[r, idx[i, l]]``, x2 ``(R, S2)`` -> ``(R, S1)``
    (= ``spdmm_ref(idx, val, x2ᵀ)ᵀ``); out-of-range slots add nothing."""
    ok = (idx >= 0) & (idx < x2.shape[1])
    cols = x2[:, torch.where(ok, idx, 0).long()]         # (R, S1, L)
    return torch.where(ok, cols * val, 0.0).sum(-1)


def sddmm_ref(x, y, mask):
    """``mask ⊙ (x @ y)`` in fp32; x ``(M, K)``, y ``(K, N)``, mask
    ``(M, N)``."""
    return (x.float() @ y.float()) * mask.float()


def conv2d_ref(x, w, *, stride=1, padding="SAME", groups=1,
               dilation=(1, 1)):
    """x: ``(c_in, H, W)`` or ``(B, c_in, H, W)``, w: ``(k1, k2,
    c_in_per_group, c_out)`` -> ``(c_out, H', W')`` or ``(B, c_out, H',
    W')``.  ``groups`` splits channels into independent convolutions
    (group-major output channels), ``dilation`` spaces the taps."""
    k1, k2, cin, cout = w.shape
    h, wd = x.shape[-2:]
    lead = x.shape[:-3]
    sh, sw = pair(stride)
    dh, dw = pair(dilation)
    ho, wo, pt, pb, pl, pr = conv_geometry(h, wd, k1, k2, stride=stride,
                                           padding=padding,
                                           dilation=dilation)
    xp = F.pad(x, (pl, pr, pt, pb))
    og = cout // groups
    outs = []
    for g in range(groups):
        xg = xp[..., g * cin:(g + 1) * cin, :, :]
        taps = [xg[..., dy * dh:dy * dh + (ho - 1) * sh + 1:sh,
                   dx * dw:dx * dw + (wo - 1) * sw + 1:sw]
                for dy in range(k1) for dx in range(k2)]  # (.., cin, ho, wo)
        patches = torch.stack(taps, -4).reshape(*lead, k1 * k2 * cin,
                                                ho * wo)
        wm = w[..., g * og:(g + 1) * og].reshape(k1 * k2 * cin, og)
        outs.append((wm.T @ patches).reshape(*lead, og, ho, wo))
    return outs[0] if groups == 1 else torch.cat(outs, -3)


def knn_ref(x, k, mask=None, self_loops=False):
    """``(N, F)`` points -> int32 ``(N, k)`` nearest-neighbor indices.

    The pinned semantics of ``src/repro/kernels/knn.py``: the ``k``
    smallest squared-L2 distances, ascending, ties toward the lower index;
    no self match unless ``self_loops``; candidates with ``mask <= 0`` are
    never chosen while others remain (their distance is +inf, like the
    self match's), and masked rows still emit indices.  Distances are the
    reference's expansion ``(|x_i|² − 2·x_i·x_j) + |x_j|²``, each sum taken
    over F in index order by separate fp32 multiplies and adds, so the CUDA
    kernel (``csrc/knn.cu``) can repeat the arithmetic bit for bit.  bf16
    points are upcast to fp32."""
    n, f = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"knn: k={k} out of range for {n} points")
    x = x.float()
    sq = torch.zeros(n, dtype=torch.float32, device=x.device)
    dot = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    for c in range(f):
        col = x[:, c]
        sq = sq + col * col
        dot = dot + col[:, None] * col[None, :]
    d = (sq[:, None] - 2.0 * dot) + sq[None, :]
    if not self_loops:
        d.fill_diagonal_(float("inf"))
    if mask is not None:
        d = torch.where(mask.reshape(1, n) > 0, d, float("inf"))
    # a stable sort, not topk: topk leaves the order of ties unspecified
    return torch.sort(d, dim=1, stable=True).indices[:, :k].to(torch.int32)


def attention_ref(q, k, v, *, causal=True, scale=None):
    """Softmax attention: q ``(B, Hq, Sq, D)``, k ``(B, Hkv, Sk, D)``, v
    ``(B, Hkv, Sk, DV)`` (DV may differ from D: MLA), GQA
    by head repetition (kv head ``h // (Hq / Hkv)``); query i sees keys
    ``j <= i + (Sk - Sq)`` when ``causal``.  Scores, softmax and the value
    sum in fp32; the output in q's dtype.

    A row with no live key (``Sq > Sk``, its first ``Sq - Sk`` rows) gives
    0, as the Pallas kernel's ``l == 0`` guard does
    (``src/repro/kernels/flash_attention.py``); the reference's own
    ``attention_ref`` gives NaN there."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.where(torch.isneginf(m), 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return (out / torch.where(l == 0, 1.0, l)).to(q.dtype)


def _live(sq: int, sk: int, causal: bool, device) -> torch.Tensor | None:
    """``(Sq, Sk)`` mask of the pairs attention computes, None without a
    mask: query i sees keys ``j <= i + (Sk - Sq)``."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= qpos


def attention_lse_ref(q, k, v, *, causal=True, scale=None):
    """``attention_ref`` and each row's log-sum-exp of the scaled scores,
    fp32 ``(B, Hq, Sq)``: the reference's ``lse = m + log(max(l, 1e-30))``
    (``models/attention.py:268``), ``-inf`` for a row with no live key
    (the reference's ``-1e30`` mask value makes it about ``-1e30``)."""
    d, group = q.shape[-1], q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(group, 1)) * scale
    live = _live(q.shape[2], k.shape[2], causal, q.device)
    if live is not None:
        s = s.masked_fill(~live, float("-inf"))
    return (attention_ref(q, k, v, causal=causal, scale=scale),
            torch.logsumexp(s, -1))


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, scale=None):
    """dq, dk, dv of ``attention_ref`` from the forward's ``out`` and
    ``lse`` and the incoming ``dout``, in the layouts of ``attention_ref``:
    the math of the reference's ``_flash_bwd``, in fp32 over the full
    ``(Sq, Sk)`` matrices: ``D = rowsum(dO·O)``, ``p = exp(s - lse)`` on the
    live pairs (0 elsewhere, so a row with no live key adds nothing),
    ``ds = p·(dp - D)·scale``, ``dq = ds k``, ``dk = dsᵀ q`` and
    ``dv = pᵀ dO``, dk and dv summed over each kv head's ``Hq / Hkv`` query
    heads; each cast to its input's dtype.  v's head dim may differ from
    q's (``out`` and ``dout`` then have v's)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf, gf = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    live = _live(sq, sk, causal, q.device)
    if live is not None:
        p = torch.where(live, p, 0.0)
    delta = (gf * out.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    fold = (b, hkv, group, sk)
    return (dq.to(q.dtype), dk.reshape(*fold, d).sum(2).to(k.dtype),
            dv.reshape(*fold, v.shape[-1]).sum(2).to(v.dtype))
