"""Pooling-family handlers.  Port of ``src/repro/core/runtime/pooling.py``:
``globalpool`` only so far; windowed ``pool2d`` and the ELL ``maxagg``
come with the slices that run them.
"""
from __future__ import annotations

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.registry import not_ported, register_op


@register_op("globalpool")
def run_globalpool(op: MatOp, env, params=None):
    x = env[op.inputs[0]]
    # Rank recorded at lowering time (a batched runner would hide the batch
    # axis from handlers; the reduced axes stay those of one sample).
    rank = op.attrs.get("in_rank", x.ndim)
    axes = {4: (2, 3), 3: (1, 2), 2: (0,)}[rank]
    return x.amax(axes) if op.attrs["pool"] == "max" else x.mean(axes)


register_op("pool2d")(not_ported("windowed pool2d",
                                 "ROADMAP queue 1 item 2: b1"))
register_op("maxagg")(not_ported("ELL max-aggregation",
                                 "ROADMAP queue 1 item 2"))
