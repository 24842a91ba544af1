"""Public kernel entry points + the Step-4 sparsity-aware dispatch.

Port of ``src/repro/kernels/ops.py``: plain functions on tensors over the
port's wrappers, the seam a caller outside the compiler (the LM framework,
a user's own model) takes to the paper's primitive vocabulary.  The
compiler's runtime calls the wrappers directly; nothing here is on its
path.

Every entry point runs the hand-written kernel (through its wrapper, which
takes the plain version on a CPU tensor and launches the kernel or raises
on a CUDA tensor) or, with ``use_kernel=False``, the plain version in
``kernels/ref.py`` (the reference's ``use_pallas=False``) on any device.

Sparsity-aware dispatch (paper §V-C5): ``matmul_auto`` picks DDMM vs SpDMM
from *static* sparsity metadata, the same decision GCV-Turbo's Step 4
makes.  The price is the compiler's own H100 one
(``core.perf_model.select_primitive(target="h100")``: the ELL SpDMM
kernel against the DDMM kernel by device time), so the port keeps one
Step-4 price, not two; the reference's TPU gather penalty is not carried
over.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.ddmm import ddmm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.knn import knn
from repro_torch.kernels.sddmm import sddmm
from repro_torch.kernels.shift_conv import shift_conv2d
from repro_torch.kernels.spdmm import spdmm


def matmul(x, y, bias=None, residual=None, *, act=None, use_kernel=True):
    """Dense matmul with fused epilogue; >2-D x is flattened on the left."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    res2 = (residual.reshape(-1, residual.shape[-1]).contiguous()
            if residual is not None else None)
    fn = ddmm if use_kernel else ref.ddmm_ref
    out = fn(x2, y, bias=bias, residual=res2, act=act)
    return out.reshape(*lead, y.shape[-1])


def sparse_matmul(idx, val, y, *, use_kernel=True):
    """ELL ``(idx, val)`` ``(S1, L)`` @ dense ``y (S2, N)``."""
    return (spdmm if use_kernel else ref.spdmm_ref)(idx, val, y)


def sampled_matmul(x, y, mask, *, use_kernel=True):
    """``mask ⊙ (x @ y)`` (the reference's ``elementwise=True``)."""
    return (sddmm if use_kernel else ref.sddmm_ref)(x, y, mask)


def conv2d(x, w, *, stride=1, padding="SAME", groups=1, dilation=(1, 1),
           use_kernel=True):
    """Conv of x ``(B, c_in, H, W)`` or ``(c_in, H, W)``; the shift-conv
    kernel takes the batch axis itself."""
    fn = shift_conv2d if use_kernel else ref.conv2d_ref
    return fn(x, w, stride=stride, padding=padding, groups=groups,
              dilation=tuple(dilation))


def knn_graph(x, mask=None, *, k, self_loops=False, use_kernel=True):
    """Per-input KNN neighbor indices: (N, F) points -> int32 (N, k), under
    the pinned selection semantics of ``ref.knn_ref``."""
    if use_kernel:
        return knn(x, k, mask=mask, self_loops=self_loops)
    return ref.knn_ref(x, k, mask=mask, self_loops=self_loops)


def attention(q, k, v, *, causal=True, use_kernel=True):
    fn = flash_attention if use_kernel else ref.attention_ref
    return fn(q, k, v, causal=causal)


def choose_primitive(s1: int, s2: int, s3: int, nnz_padded: int) -> str:
    """Step-4 decision on static metadata for ``X (s1, s2) @ Y (s2, s3)``
    with X in ELL (``nnz_padded`` stored slots) on the left, as
    ``matmul_auto`` runs it: 'DDMM' or 'SpDMM'."""
    # imported here: repro_torch.core imports this package
    from repro_torch.core.perf_model import select_primitive
    return select_primitive(s1, s2, s3, nnz_padded, target="h100",
                            columns=True)


def matmul_auto(x_dense, y, *, ell=None, use_kernel=True):
    """Sparsity-aware matmul: dispatch to SpDMM when the (compile-time) ELL
    metadata says the ELL kernel beats DDMM, else DDMM.  Returns ``(out,
    primitive)``.

    ``ell``: optional (idx, val) precomputed at compile time (the paper's
    offline three-tuple conversion). The decision is static — latency
    stays deterministic, per the paper's autonomous-driving argument.
    """
    s1, s2 = x_dense.shape
    s3 = y.shape[-1]
    if ell is not None:
        idx, val = ell
        prim = choose_primitive(s1, s2, s3, idx.shape[0] * idx.shape[1])
        if prim == "SpDMM":
            return sparse_matmul(idx, val, y, use_kernel=use_kernel), prim
    return matmul(x_dense, y, use_kernel=use_kernel), "DDMM"


__all__ = [
    "matmul", "sparse_matmul", "sampled_matmul", "conv2d", "attention",
    "knn_graph", "matmul_auto", "choose_primitive", "ddmm", "spdmm",
    "sddmm", "shift_conv2d", "flash_attention", "knn",
]
