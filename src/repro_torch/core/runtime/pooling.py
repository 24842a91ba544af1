"""Pooling-family handlers.  Port of ``src/repro/core/runtime/pooling.py``:
windowed ``pool2d``, ``globalpool`` and the ELL max-aggregation ``maxagg``
of dense-adjacency ``mp(reduce="max")``.

``pool2d`` and ``globalpool`` have one plain-torch realization (Step 4b
records them as ``torch_ew``); ``maxagg`` runs from its compile-time ELL
arrays (``torch_ell_spdmm``, the gather family, with no kernel: the
reference has no Pallas member either).  Windows and strides may be
scalars or ``(kh, kw)`` pairs.  Batched, ``pool2d`` takes the batch as one
more leading axis (each output reduces its own window in a fixed order);
``globalpool``, a reduction whose order may follow the number of outputs,
and ``maxagg`` loop per sample.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.registry import register_batched, register_op
from repro_torch.core.runtime.residency import ell_pair
from repro_torch.kernels import ref


@register_batched("pool2d")
@register_op("pool2d")
def run_pool2d(op: MatOp, env, params=None):
    """Max or average pooling over the last two axes, any leading axes.

    SAME padding as ``lax.reduce_window`` pads it: the TF split
    (``before = total // 2``), so a 3x3/2 pool on 112x112 pads (0, 1) —
    ``F.max_pool2d(padding=1)`` would pad (1, 1).  The pad is explicit:
    ``-inf`` for max; zeros for average, which divides by ``k1·k2``
    counting the padded zeros, as the reference does."""
    x = env[op.inputs[0]]
    k1, k2 = ref.pair(op.attrs["window"])
    s1, s2 = ref.pair(op.attrs["stride"])
    h, w = x.shape[-2:]
    _, _, pt, pb, pl, pr = ref.conv_geometry(
        h, w, k1, k2, stride=(s1, s2), padding="SAME", dilation=(1, 1))
    is_max = op.attrs["pool"] == "max"
    xp = F.pad(x.reshape(-1, h, w), (pl, pr, pt, pb),
               value=float("-inf") if is_max else 0.0)
    pool = F.max_pool2d if is_max else F.avg_pool2d
    out = pool(xp, (k1, k2), (s1, s2))
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


@register_op("globalpool")
def run_globalpool(op: MatOp, env, params=None):
    x = env[op.inputs[0]]
    # Rank recorded at lowering time (a batched runner would hide the batch
    # axis from handlers; the reduced axes stay those of one sample).
    rank = op.attrs.get("in_rank", x.ndim)
    axes = {4: (2, 3), 3: (1, 2), 2: (0,)}[rank]
    return x.amax(axes) if op.attrs["pool"] == "max" else x.mean(axes)


@register_op("maxagg")
def run_maxagg(op: MatOp, env, params=None):
    """``out[i] = max over the valid slots l (val[i, l] != 0) of
    x[idx[i, l]]``; a row with no valid slot, or whose max is -inf, keeps
    ``x[i]``.  NaN propagates (``amax``)."""
    x = env[op.inputs[0]]
    idx, val = ell_pair(op, params)
    gathered = x[idx.long()]                          # (N, L, F)
    valid = (val != 0)[..., None]
    agg = torch.where(valid, gathered, float("-inf")).amax(1)
    return torch.where(torch.isneginf(agg), x, agg)
