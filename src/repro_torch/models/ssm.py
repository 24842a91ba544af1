"""State-space and recurrent blocks: Mamba2 (SSD), mLSTM and sLSTM.

Port of ``src/repro/models/ssm.py``, function by function.  Every
recurrence keeps the reference's three realizations:

  *_seq      token-level loop: the oracle, and the decode step's maths;
  *_chunked  chunk-parallel matrix form: the prefill and training path;
  *_step     one-token state update.

Each ``lax.scan`` is a Python loop here: over chunks in the chunked forms,
over tokens in ``*_seq`` and in sLSTM.  Carries and the recurrences run
in fp32 (float64 in a float64 model: ``acc``, ``layers.wide``); block
inputs and outputs stay in the model dtype.  None of these recurrences
has a Pallas kernel in the reference (they run in XLA there), so they run
as plain PyTorch here.

Under a mesh context (``layers.shard_axes``, ``transformer.lm_forward``'s
and its siblings' ``mesh=``) every leaf is read through ``layers.weight``
and each rank runs its batch rows.  Where SSD's or mLSTM's heads divide
over the model axis (``layers.head_part``; the reference pins them there with
``wsc``) each model rank runs its share of them: Mamba2 reads ``in_proj``'s
columns of its heads section by section (z, x, the B and C of their
groups, dt), with the conv's channels, ``A_log``, ``dt_bias`` and ``D``
alike; its gated norm over all of ``d_in`` adds the squares' sums over the
model axis (``layers.rms_norm_split``).  mLSTM runs its up projection's
``h_in`` half and the conv whole (every head's q and k read every
channel) and the rest on its heads: ``z``, q, k, v, the gates, the
per-head norm and the skip.  The output projection's partial sums are
added over the model axis (``psum_model``).  Where the heads do not
divide, and always for sLSTM (its recurrent ``r`` is replicated by the
rule table), a block runs whole on every model rank.  States and conv
tails are the rank's rows and heads (mLSTM's conv tail whole).

One difference from the reference: ``ssd_chunked`` masks the pairs above
each chunk's diagonal before its exp, where the reference masks after it
(``jnp.where(tri, exp(diff), 0)``).  The forward is the same; at a
published chunk (zamba2's 128 tokens) the exp overflows there, and the
reference's grads of ``dt`` and ``A`` come out NaN where the port's are
finite.

``init_*`` draw from an explicit ``torch.Generator`` on its device, in the
reference's scales.  Five leaves stay fp32 whatever the model dtype, as in
the reference: ``A_log``, ``dt_bias`` and ``D`` of Mamba2, ``if_bias`` of
mLSTM and ``bias`` of sLSTM.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dot, head_part, init_linear,
                                       normal, psum_model, rms_norm,
                                       rms_norm_by, rms_norm_split, weight,
                                       wide)

NEG = -1e30  # finite -inf stand-in (avoids inf-inf NaNs in grads)
F32 = torch.float32


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def acc(dtype: torch.dtype) -> torch.dtype:
    """The carries' dtype for a model in ``dtype``: fp32, or float64 for a
    float64 model (``layers.wide``)."""
    return torch.float64 if dtype == torch.float64 else F32


def _zeros(shape, like):
    return torch.zeros(shape, dtype=acc(like.dtype), device=like.device)


# ====================================================================== SSD =
def ssd_seq(x, dt, A, B, C, D, *, state=None):
    """Token-level SSD.  x ``(b, S, H, P)``; dt ``(b, S, H)`` > 0; A
    ``(H,)`` < 0; B, C ``(b, S, G, N)``; D ``(H,)``; state ``(b, H, N, P)``
    or None.  Returns ``(y (b, S, H, P), final state)``."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf = wide(x)
    a = torch.exp(wide(dt) * wide(A))                      # (b, S, H)
    Bx = torch.repeat_interleave(wide(B), rep, dim=2)        # (b, S, H, N)
    Cx = torch.repeat_interleave(wide(C), rep, dim=2)
    dx = wide(dt)[..., None] * xf                            # (b, S, H, P)
    s = _zeros((b, H, N, P), x) if state is None else wide(state)
    ys = []
    for t in range(S):
        s = a[:, t, :, None, None] * s \
            + Bx[:, t, ..., None] * dx[:, t, ..., None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cx[:, t], s))
    y = torch.stack(ys, 1) if ys else xf[:, :0]
    y = y + wide(D)[:, None] * xf
    return y.to(x.dtype), s


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, state=None):
    """Chunk-parallel SSD (Mamba2's Alg. 1): an intra-chunk masked product
    pair and an inter-chunk product against the carried state; the loop
    runs over chunks only."""
    b, S0, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S0)
    if S0 % Q:                       # pad with dt=0 tokens (a=1, no-ops)
        pad = Q - S0 % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // Q
    xf = wide(x).reshape(b, nc, Q, H, P)
    dtf = wide(dt).reshape(b, nc, Q, H)
    la = dtf * wide(A)                                # log a  (b,nc,Q,H)
    Bx = torch.repeat_interleave(wide(B), rep, dim=2).reshape(b, nc, Q, H,
                                                                N)
    Cx = torch.repeat_interleave(wide(C), rep, dim=2).reshape(b, nc, Q, H,
                                                                N)
    dx = dtf[..., None] * xf                            # (b,nc,Q,H,P)
    cum = torch.cumsum(la, dim=2)                       # inclusive A_cum
    total = cum[:, :, -1]                               # (b,nc,H)
    # L[i,j] = exp(cum_i - cum_j) for i>=j (within a chunk); the pairs
    # above the diagonal are masked before the exp, whose argument there
    # (a sum of -log a, up to about 200 over a 128-token chunk) overflows:
    # masked after it, the exp's inf times the mask's zero grad is NaN
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], NEG))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cx, Bx) * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, dx)
    # per-chunk local final state: sum_j exp(total - cum_j) B_j dx_j^T
    w = torch.exp(total[:, :, None] - cum)              # (b,nc,Q,H)
    s_loc = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, Bx, dx)
    s = _zeros((b, H, N, P), x) if state is None else wide(state)
    s_in = []
    for c in range(nc):                                 # emit incoming state
        s_in.append(s)
        s = torch.exp(total[:, c])[:, :, None, None] * s + s_loc[:, c]
    s_in = torch.stack(s_in, 1)                         # (b,nc,H,N,P)
    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Cx, s_in,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, S, H, P) \
        + wide(D)[:, None] * wide(x)
    return y[:, :S0].to(x.dtype), s


def ssd_step(x, dt, A, B, C, D, state):
    """One-token decode.  x ``(b, H, P)``; dt ``(b, H)``; B, C ``(b, G,
    N)``; state ``(b, H, N, P)``.  Returns ``(y, new_state)``."""
    H, G = x.shape[1], B.shape[1]
    rep = H // G
    xf = wide(x)
    a = torch.exp(wide(dt) * wide(A))
    Bx = torch.repeat_interleave(wide(B), rep, dim=1)
    Cx = torch.repeat_interleave(wide(C), rep, dim=1)
    dx = wide(dt)[..., None] * xf
    s = a[:, :, None, None] * wide(state) + Bx[..., None] * dx[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Cx, s) + wide(D)[:, None] * xf
    return y.to(x.dtype), s


# ============================================================= Mamba2 block =
def _mamba2_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gN = s.n_groups * s.d_state
    return s, d_in, gN, d_in // s.head_dim, d_in + 2 * gN


def init_mamba2(gen, cfg, dtype):
    s, d_in, gN, nheads, conv_ch = _mamba2_dims(cfg)
    d = cfg.d_model
    dev = gen.device
    in_proj = init_linear(gen, d, 2 * d_in + 2 * gN + nheads, dtype)
    conv_w = normal(gen, (s.conv_width, conv_ch), dtype,
                    1.0 / math.sqrt(s.conv_width))
    u = torch.rand((nheads,), generator=gen, dtype=F32, device=dev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * u)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, nheads + 1, dtype=F32,
                                        device=dev)),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),     # inv-softplus
        "D": torch.ones((nheads,), dtype=F32, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": init_linear(gen, d_in, d, dtype),
    }


def _causal_conv(x, w, b, *, tail=None):
    """Depthwise causal conv.  x ``(b, S, C)``; w ``(K, C)``.  ``tail``
    ``(b, K-1, C)`` is the carried left context (decode); returns ``(y,
    new_tail)``."""
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], 1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * wide(w[i]) for i in range(K))
    new_tail = xp[:, -(K - 1):] if K > 1 else tail
    return (y + wide(b)).to(x.dtype), new_tail


def _mamba2_part(cfg, device):
    """This rank's part of a Mamba2 block: ``(heads, groups, in_proj's
    columns, the conv's channels)``; the columns None where the block runs
    whole.  ``in_proj``'s columns are z ``[0, d_in)``, x ``[d_in,
    2·d_in)``, B and C ``gN`` each, dt ``nheads``; the conv's are x, B,
    C."""
    s, d_in, gN, nheads, _ = _mamba2_dims(cfg)
    lo, hi = head_part(nheads, groups=s.n_groups)
    if (lo, hi) == (0, nheads):
        return (lo, hi), (0, s.n_groups), None, None
    P, N = s.head_dim, s.d_state
    rep = nheads // s.n_groups
    g0, g1 = lo // rep, (hi - 1) // rep + 1
    xs = torch.arange(lo * P, hi * P, device=device)
    bs = torch.arange(g0 * N, g1 * N, device=device)
    dts = torch.arange(lo, hi, device=device)
    cols = torch.cat([xs, d_in + xs, 2 * d_in + bs, 2 * d_in + gN + bs,
                      2 * d_in + 2 * gN + dts])
    chans = torch.cat([xs, d_in + bs, d_in + gN + bs])
    return (lo, hi), (g0, g1), cols, chans


def mamba2_forward(params, x, cfg, *, state=None, impl="chunked"):
    """x ``(b, S, d)``.  state: None or ``{"conv": (b, K-1, conv_ch),
    "ssm": (b, H, N, P)}`` (this rank's heads and their channels under a
    mesh context: module docstring).  Returns ``(out, new_state)``."""
    s, d_in, gN, nheads, _ = _mamba2_dims(cfg)
    (lo, hi), (g0, g1), cols, chans = _mamba2_part(cfg, x.device)
    h_loc, g_loc = hi - lo, g1 - g0
    di, gn = h_loc * s.head_dim, g_loc * s.d_state
    heads = None if cols is None else slice(lo, hi)
    proj = dot(x, weight(params["in_proj"], -1, cols)).to(x.dtype)
    z, xBC, dtr = torch.split(proj, [di, di + 2 * gn, h_loc], -1)
    conv_tail = None if state is None else state["conv"]
    xBC, new_tail = _causal_conv(xBC, weight(params["conv_w"], -1, chans),
                                 weight(params["conv_b"], 0, chans),
                                 tail=conv_tail)
    xBC = F.silu(wide(xBC)).to(x.dtype)
    xs, B, C = torch.split(xBC, [di, gn, gn], -1)
    b, S = x.shape[:2]
    xs = xs.reshape(b, S, h_loc, s.head_dim)
    B = B.reshape(b, S, g_loc, s.d_state)
    C = C.reshape(b, S, g_loc, s.d_state)
    dt = softplus(wide(dtr) + weight(params["dt_bias"], 0, heads))
    A = -torch.exp(weight(params["A_log"], 0, heads))
    D = weight(params["D"], 0, heads)
    ssm0 = None if state is None else state["ssm"]
    if impl == "chunked":
        y, ssm1 = ssd_chunked(xs, dt, A, B, C, D, state=ssm0, chunk=s.chunk)
    else:
        y, ssm1 = ssd_seq(xs, dt, A, B, C, D, state=ssm0)
    y = y.reshape(b, S, di)
    y = (wide(y) * F.silu(wide(z))).to(x.dtype)
    if heads is None:
        y = rms_norm(y, params["norm"], cfg.norm_eps)
        return (dot(y, weight(params["out_proj"])).to(x.dtype),
                {"conv": new_tail, "ssm": ssm1})
    cut = slice(lo * s.head_dim, hi * s.head_dim)
    y = rms_norm_split(y, weight(params["norm"], 0, cut), d_in, cfg.norm_eps)
    out = psum_model(dot(y, weight(params["out_proj"], 0, cut)))
    return out.to(x.dtype), {"conv": new_tail, "ssm": ssm1}


def mamba2_init_state(cfg, batch, dtype, *, device="cuda"):
    """A Mamba2 block's initial state (this rank's heads and channels
    under a mesh context)."""
    s, _, _, nheads, _ = _mamba2_dims(cfg)
    (lo, hi), (g0, g1), _, _ = _mamba2_part(cfg, "cpu")
    conv_ch = (hi - lo) * s.head_dim + 2 * (g1 - g0) * s.d_state
    return {"conv": torch.zeros((batch, s.conv_width - 1, conv_ch),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, hi - lo, s.d_state, s.head_dim),
                               dtype=acc(dtype), device=device)}


# ==================================================================== mLSTM =
def mlstm_seq(q, k, v, li, lf, *, state=None):
    """Stabilized token-level mLSTM.  q, k, v ``(b, S, H, P)``; li, lf
    ``(b, S, H)`` log-gates; state ``(C (b, H, P, P), n (b, H, P), m (b,
    H))``.  Returns ``(h, state)``."""
    b, S, H, P = q.shape
    qf = wide(q) / math.sqrt(P)
    kf, vf = wide(k), wide(v)
    lif, lff = wide(li), wide(lf)
    if state is None:
        state = (_zeros((b, H, P, P), q), _zeros((b, H, P), q),
                 torch.full((b, H), NEG, dtype=acc(q.dtype),
                            device=q.device))
    Cm, n, m = state
    hs = []
    for t in range(S):
        q_t, k_t, v_t, li_t, lf_t = (qf[:, t], kf[:, t], vf[:, t],
                                     lif[:, t], lff[:, t])
        m_new = torch.maximum(lf_t + m, li_t)
        fp = torch.exp(lf_t + m - m_new)
        ip = torch.exp(li_t - m_new)
        Cm = fp[..., None, None] * Cm \
            + ip[..., None, None] * k_t[..., :, None] * v_t[..., None, :]
        n = fp[..., None] * n + ip[..., None] * k_t
        num = torch.einsum("bhp,bhpv->bhv", q_t, Cm)
        den = torch.maximum(torch.einsum("bhp,bhp->bh", q_t, n).abs(),
                            torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    h = torch.stack(hs, 1) if hs else qf
    return h.to(q.dtype), (Cm, n, m)


def mlstm_chunked(q, k, v, li, lf, *, chunk: int, state=None):
    """Chunkwise-parallel stabilized mLSTM: intra-chunk a masked product
    pair, inter-chunk a product against the carried ``(C, n)``; the loop
    runs over chunks only."""
    b, S0, H, P = q.shape
    Q = min(chunk, S0)
    if S0 % Q:                       # pad: li=NEG (no input), lf=0 (no decay)
        pad = Q - S0 % Q
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    S = q.shape[1]
    nc = S // Q
    qf = (wide(q) / math.sqrt(P)).reshape(b, nc, Q, H, P)
    kf = wide(k).reshape(b, nc, Q, H, P)
    vf = wide(v).reshape(b, nc, Q, H, P)
    lif = wide(li).reshape(b, nc, Q, H)
    lff = wide(lf).reshape(b, nc, Q, H)
    bcum = torch.cumsum(lff, dim=2)                     # inclusive
    btot = bcum[:, :, -1]                               # (b,nc,H)
    # intra weights: D[i,j] = b_i - b_j + li_j  (j<=i)
    dmat = bcum[:, :, :, None, :] - bcum[:, :, None, :, :] \
        + lif[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=q.device))[None, None, :, :, None]
    dmat = torch.where(tri, dmat, torch.full((), NEG, dtype=dmat.dtype,
                                             device=q.device))
    m_intra = dmat.amax(3)                              # (b,nc,Q,H)
    # chunk-local state weights: b_tot - b_j + li_j
    wloc = btot[:, :, None] - bcum + lif                # (b,nc,Q,H)
    m_loc = wloc.amax(2)                                # (b,nc,H)

    if state is None:
        Cm = _zeros((b, H, P, P), q)
        n = _zeros((b, H, P), q)
        m = torch.full((b, H), NEG, dtype=acc(q.dtype), device=q.device)
    else:
        Cm, n, m = (wide(s) for s in state)
    C_in, n_in, m_in = [], [], []
    for c in range(nc):
        C_in.append(Cm)
        n_in.append(n)
        m_in.append(m)
        m_next = torch.maximum(btot[:, c] + m, m_loc[:, c])
        w = torch.exp(wloc[:, c] - m_next[:, None])     # (b,Q,H)
        dec = torch.exp(btot[:, c] + m - m_next)
        Cm = dec[..., None, None] * Cm + torch.einsum(
            "bqh,bqhp,bqhv->bhpv", w, kf[:, c], vf[:, c])
        n = dec[..., None] * n + torch.einsum("bqh,bqhp->bhp", w, kf[:, c])
        m = m_next
    C_in = torch.stack(C_in, 1)                         # (b,nc,H,P,P)
    n_in = torch.stack(n_in, 1)
    m_in = torch.stack(m_in, 1)                         # (b,nc,H)

    m_inter = bcum + m_in[:, :, None]                   # (b,nc,Q,H)
    m_new = torch.maximum(m_intra, m_inter)
    w_intra = torch.exp(dmat - m_new[:, :, :, None])    # (b,nc,Q,Q,H)
    qk = torch.einsum("bcqhp,bckhp->bcqkh", qf, kf)
    scores = qk * w_intra
    num = torch.einsum("bcqkh,bckhv->bcqhv", scores, vf)
    den_intra = scores.sum(3)
    w_inter = torch.exp(m_inter - m_new)                # (b,nc,Q,H)
    num = num + w_inter[..., None] * torch.einsum(
        "bcqhp,bchpv->bcqhv", qf, C_in)
    den = den_intra + w_inter * torch.einsum("bcqhp,bchp->bcqh", qf, n_in)
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, S, H, P)
    return h[:, :S0].to(q.dtype), (Cm, n, m)


def mlstm_step(q, k, v, li, lf, state):
    """One-token decode.  q, k, v ``(b, H, P)``; li, lf ``(b, H)``."""
    h, state = mlstm_seq(q[:, None], k[:, None], v[:, None],
                         li[:, None], lf[:, None], state=state)
    return h[:, 0], state


def init_mlstm(gen, cfg, dtype):
    xc = cfg.xlstm
    d = cfg.d_model
    d_in = int(xc.proj_factor * d)
    H = cfg.n_heads
    dev = gen.device
    return {
        "up": init_linear(gen, d, 2 * d_in, dtype),
        "conv_w": normal(gen, (xc.conv_width, d_in), dtype,
                         1.0 / math.sqrt(xc.conv_width)),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "wq": init_linear(gen, d_in, d_in, dtype),
        "wk": init_linear(gen, d_in, d_in, dtype),
        "wv": init_linear(gen, d_in, d_in, dtype),
        "wif": init_linear(gen, d_in, 2 * H, dtype),
        "if_bias": torch.cat([
            torch.zeros((H,), dtype=F32, device=dev),
            torch.linspace(3.0, 6.0, H, dtype=F32, device=dev)]),
        "skip": torch.ones((d_in,), dtype=dtype, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "down": init_linear(gen, d_in, d, dtype),
    }


def mlstm_block(params, x, cfg, *, state=None, impl="chunked"):
    """Post-up-projection mLSTM block.  state: ``{"conv", "C", "n",
    "m"}`` or None (this rank's heads under a mesh context: module
    docstring)."""
    xc = cfg.xlstm
    b, S, d = x.shape
    d_in = int(xc.proj_factor * d)
    H = cfg.n_heads
    P = d_in // H
    lo, hi = head_part(H)
    whole = (lo, hi) == (0, H)
    hs = None if whole else slice(lo * P, hi * P)
    up_cols = gate_cols = None
    if not whole:
        dev = x.device
        heads = torch.arange(lo, hi, device=dev)
        up_cols = torch.cat([torch.arange(d_in, device=dev),
                             d_in + torch.arange(lo * P, hi * P, device=dev)])
        gate_cols = torch.cat([heads, H + heads])
    up = dot(x, weight(params["up"], -1, up_cols)).to(x.dtype)
    h_in, z = torch.split(up, [d_in, up.shape[-1] - d_in], -1)
    conv_tail = None if state is None else state["conv"]
    hc, new_tail = _causal_conv(h_in, weight(params["conv_w"]),
                                weight(params["conv_b"]), tail=conv_tail)
    hc = F.silu(wide(hc)).to(x.dtype)
    h_loc = hi - lo
    q = dot(hc, weight(params["wq"], -1, hs)).to(x.dtype).reshape(
        b, S, h_loc, P)
    k = dot(hc, weight(params["wk"], -1, hs)).to(x.dtype).reshape(
        b, S, h_loc, P)
    v = dot(h_in, weight(params["wv"], -1, hs)).to(x.dtype).reshape(
        b, S, h_loc, P)
    gates = (dot(hc, weight(params["wif"], -1, gate_cols))
             + weight(params["if_bias"], 0, gate_cols))
    li, lfr = torch.chunk(gates, 2, -1)                 # (b, S, H) each
    lf = F.logsigmoid(lfr)
    st0 = None if state is None else (state["C"], state["n"], state["m"])
    if impl == "chunked":
        hout, (C1, n1, m1) = mlstm_chunked(q, k, v, li, lf, state=st0,
                                           chunk=xc.chunk)
    else:
        hout, (C1, n1, m1) = mlstm_seq(q, k, v, li, lf, state=st0)
    norm = weight(params["norm"], 0, hs)
    hout = rms_norm_by(hout, norm.reshape(h_loc, P).to(x.dtype),
                       cfg.norm_eps).reshape(b, S, h_loc * P)
    if not whole:
        hc = hc[..., hs]
    hout = hout + wide(weight(params["skip"], 0, hs)) * hc
    hout = wide(hout) * F.silu(wide(z))
    out = dot(hout.to(x.dtype), weight(params["down"], 0, hs))
    if not whole:
        out = psum_model(out)
    return out.to(x.dtype), {"conv": new_tail, "C": C1, "n": n1, "m": m1}


def mlstm_init_state(cfg, batch, dtype, *, device="cuda"):
    """An mLSTM block's initial state (this rank's heads under a mesh
    context; the conv tail whole)."""
    xc = cfg.xlstm
    d_in = int(xc.proj_factor * cfg.d_model)
    H = cfg.n_heads
    P = d_in // H
    lo, hi = head_part(H)
    h = hi - lo
    return {"conv": torch.zeros((batch, xc.conv_width - 1, d_in),
                                dtype=dtype, device=device),
            "C": torch.zeros((batch, h, P, P), dtype=acc(dtype),
                             device=device),
            "n": torch.zeros((batch, h, P), dtype=acc(dtype), device=device),
            "m": torch.full((batch, h), NEG, dtype=acc(dtype),
                            device=device)}


# ==================================================================== sLSTM =
def init_slstm(gen, cfg, dtype):
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    dev = gen.device
    return {
        "w": init_linear(gen, d, 4 * d, dtype),         # z, i, f, o
        "r": normal(gen, (H, hd, 4 * hd), dtype,
                    1.0 / math.sqrt(hd)),               # block-diagonal
        "bias": torch.cat([
            torch.zeros((2 * d,), dtype=F32, device=dev),
            torch.linspace(3.0, 6.0, d, dtype=F32, device=dev),  # forget
            torch.zeros((d,), dtype=F32, device=dev)]),
        "norm": torch.ones((d,), dtype=dtype, device=dev),
        "out": init_linear(gen, d, d, dtype),
    }


def slstm_block(params, x, cfg, *, state=None):
    """Sequential sLSTM (a loop over tokens: inherently recurrent), whole
    on every model rank under a mesh context.  state: ``{"c", "n", "m",
    "h"}``, each ``(b, H, hd)``, or None."""
    b, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    wx = dot(x, weight(params["w"])) + weight(params["bias"])   # fp32
    if state is None:
        z = _zeros((b, H, hd), x)
        state = {"c": z, "n": z, "h": z,
                 "m": torch.full((b, H, hd), NEG, dtype=acc(x.dtype),
                                 device=x.device)}
    rw = wide(weight(params["r"]))
    # wx is ordered as (z, i, f, o) blocks of d; regroup per head
    wxh = wide(wx).reshape(b, S, 4, H, hd).transpose(2, 3) \
        .reshape(b, S, H, 4 * hd)
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hdk->bhk", h, rw)       # (b, H, 4hd)
        zt, it, ft, ot = torch.chunk(wxh[:, t] + rec, 4, -1)
        zt = torch.tanh(zt)
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hs = (torch.stack(hs, 1) if hs else wxh[..., :hd]).reshape(b, S, d)
    hs = rms_norm(hs.to(x.dtype), params["norm"], cfg.norm_eps)
    out = dot(hs, weight(params["out"])).to(x.dtype)
    return out, {"c": c, "n": n, "m": m, "h": h}


def slstm_init_state(cfg, batch, dtype, *, device="cuda"):
    H = cfg.n_heads
    hd = cfg.d_model // H

    def zeros():
        return torch.zeros((batch, H, hd), dtype=acc(dtype), device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, H, hd), NEG, dtype=acc(dtype),
                            device=device),
            "h": zeros()}
