"""The shared fused epilogue (bias + activation + residual) and the ``ew``
kind.  Port of ``src/repro/core/runtime/elementwise.py``.

``apply_epilogue`` is the one place bias + fused activation + fused
residual semantics live; the matmul and conv handlers call it so the fusion
pass's annotations mean the same thing for every producing op.  Standalone
``ew`` ops (softmax, norms, unfused activations and adds) are not ported
yet: b4's plan has none, because Step 1 folds them all into producers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.runtime.registry import not_ported, register_op
from repro_torch.core.runtime.residency import opt_weight

# Default leaky_relu slope, used when a layer carries no explicit ``alpha``
# attr (the declarative builder's historical behaviour).
LEAKY_SLOPE = 0.2

# jax.nn.gelu defaults to the tanh approximation; the port keeps it.
ACTIVATIONS = {"relu": torch.relu,
               "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "silu": F.silu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
               "leaky_relu": lambda x: F.leaky_relu(x, LEAKY_SLOPE)}


def apply_act(fn: str, x, alpha=None):
    """One activation, honouring a per-layer leaky slope when present."""
    if fn == "leaky_relu":
        return F.leaky_relu(x, LEAKY_SLOPE if alpha is None else alpha)
    return ACTIVATIONS[fn](x)


def apply_epilogue(out, op, env, params=None):
    """Fused bias / activation / residual tail shared by mm + conv, in the
    reference's order: bias -> act (unless ``post_res``) -> +residual ->
    act (if ``post_res``)."""
    b = opt_weight(op, "b", params)
    if b is not None:
        if out.ndim >= 3:                      # conv OFM (..., C, H, W)
            out = out + b[:, None, None]
        else:
            out = out + b
    act = op.attrs.get("fused_act")
    alpha = op.attrs.get("fused_act_alpha")
    post = op.attrs.get("act_pos") == "post_res"
    if act and not post:
        out = apply_act(act, out, alpha)
    res = op.attrs.get("fused_residual")
    if res:
        out = out + env[res]
    if act and post:
        out = apply_act(act, out, alpha)
    return out


register_op("ew")(not_ported("standalone elementwise ops (softmax, norm, "
                             "unfused act/add/mul)",
                             "ROADMAP queue 1 item 2"))
