"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain twins.

Port of ``src/repro/kernels``.  One module per TPU kernel of the reference:

  shift_conv.py  shift_conv2d  <- kernels/shift_conv.py (Pallas)
  ddmm.py        ddmm          <- kernels/ddmm.py (Pallas)
  spdmm.py       spdmm, spdmm_rows <- kernels/spdmm.py (Pallas)
  knn.py         knn           <- kernels/knn.py (Pallas)
  sddmm.py       sddmm         <- kernels/sddmm.py (Pallas)
  flash_attention.py  flash_attention  <- kernels/flash_attention.py (Pallas);
                 flash_attention_bwd, FlashAttentionFn <- the XLA backward
                 of models/attention.py:flash_attention_xla (_flash_bwd)
  ref.py         plain-PyTorch versions of all seven
  ops.py         the public entry points over the wrappers (``use_kernel=
                 False``: the plain version) and the Step-4 dispatch
                 ``matmul_auto`` (port of kernels/ops.py)
  _build.py      nvcc build of csrc/*.cu into one ctypes-loaded library
  csrc/          the CUDA sources

Each wrapper runs its plain version for CPU tensors, launches its kernel
for CUDA tensors (or raises), and counts its launches in ``<fn>.launches``,
those recorded into a CUDA graph also in ``<fn>.captured``.
"""
from repro_torch.kernels.ddmm import ddmm                  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    FlashAttentionFn, flash_attention, flash_attention_bwd)
from repro_torch.kernels.knn import knn                    # noqa: F401
from repro_torch.kernels.sddmm import sddmm                # noqa: F401
from repro_torch.kernels.shift_conv import shift_conv2d    # noqa: F401
from repro_torch.kernels.spdmm import spdmm, spdmm_rows    # noqa: F401
from repro_torch.kernels import ops, ref                   # noqa: F401
