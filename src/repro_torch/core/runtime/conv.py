"""Convolution handler — the Fig. 7 shift-add conv as one fused MatOp.

Port of the per-sample path of ``src/repro/core/runtime/conv.py``: a
``cuda_ddmm`` conv runs the shift-conv kernel (``kernels/shift_conv.py``),
a ``torch_dense`` conv its plain version.  Bias, fused activation and fused
residual ride the shared epilogue either way.
"""
from __future__ import annotations

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.elementwise import apply_epilogue
from repro_torch.core.runtime.registry import op_kernel, register_op
from repro_torch.core.runtime.residency import weight
from repro_torch.kernels import ref
from repro_torch.kernels.shift_conv import shift_conv2d


@register_op("conv")
def run_conv(op: MatOp, env, params=None):
    kern = op_kernel(op)
    x = env[op.inputs[0]]
    if x.ndim != 3:
        raise NotImplementedError(
            f"op {op.name!r}: batched conv input {tuple(x.shape)} is not "
            f"ported yet (ROADMAP queue 1 item 4)")
    conv = shift_conv2d if kern == "cuda_ddmm" else ref.conv2d_ref
    out = conv(x.contiguous(), weight(op, "w", params),
               stride=op.attrs["stride"], padding=op.attrs["padding"],
               groups=op.attrs.get("groups", 1),
               dilation=tuple(op.attrs.get("dilation", (1, 1))))
    return apply_epilogue(out, op, env, params)
