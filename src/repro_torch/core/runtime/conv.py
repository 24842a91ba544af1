"""Convolution handler — the Fig. 7 shift-add conv as one fused MatOp.

Port of the per-sample path of ``src/repro/core/runtime/conv.py``: a
``cuda_ddmm`` conv runs the shift-conv kernel (``kernels/shift_conv.py``),
a ``torch_dense`` conv its plain version.  The input is ``(c_in, H, W)`` or
a ``(B, c_in, H, W)`` stack of images (b1's support and query set), which
the kernel takes in one launch.  Bias, fused activation and fused
residual ride the shared epilogue either way.

Batched, a ``cuda_ddmm`` conv takes the whole batch: every leading axis
flattens into one image stack for one launch, and ``shift_conv.launch_plan``
follows the per-image problem, so each image comes out as its per-sample
call gives it.  The plain version loops per sample (its library may pick
another algorithm at another batch size).
"""
from __future__ import annotations

from repro_torch.core.plan import MatOp
from repro_torch.core.runtime.elementwise import apply_epilogue
from repro_torch.core.runtime.registry import (op_kernel, register_batched,
                                               register_op)
from repro_torch.core.runtime.residency import weight
from repro_torch.kernels import ref
from repro_torch.kernels.shift_conv import shift_conv2d


@register_batched("conv", when=lambda op, env: op_kernel(op) == "cuda_ddmm")
@register_op("conv")
def run_conv(op: MatOp, env, params=None):
    kern = op_kernel(op)
    x = env[op.inputs[0]]
    conv = shift_conv2d if kern == "cuda_ddmm" else ref.conv2d_ref
    out = conv((x if x.ndim <= 4 else x.flatten(0, -4)).contiguous(),
               weight(op, "w", params),
               stride=op.attrs["stride"], padding=op.attrs["padding"],
               groups=op.attrs.get("groups", 1),
               dilation=tuple(op.attrs.get("dilation", (1, 1))))
    out = out.reshape(*x.shape[:-3], *out.shape[-3:])
    return apply_epilogue(out, op, env, params)
