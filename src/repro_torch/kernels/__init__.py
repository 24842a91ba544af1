"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain twins.

Port of ``src/repro/kernels``.  One module per TPU kernel of the reference:

  shift_conv.py  shift_conv2d  <- kernels/shift_conv.py (Pallas)
  ddmm.py        ddmm          <- kernels/ddmm.py (Pallas)
  spdmm.py       spdmm, spdmm_rows <- kernels/spdmm.py (Pallas)
  knn.py         knn           <- kernels/knn.py (Pallas)
  sddmm.py       sddmm         <- kernels/sddmm.py (Pallas)
  flash_attention.py  flash_attention  <- kernels/flash_attention.py (Pallas)
  ref.py         plain-PyTorch versions of all six
  _build.py      nvcc build of csrc/*.cu into one ctypes-loaded library
  csrc/          the CUDA sources

Each wrapper runs its plain version for CPU tensors, launches its kernel
for CUDA tensors (or raises), and counts its launches in ``<fn>.launches``.
"""
from repro_torch.kernels.ddmm import ddmm                  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.knn import knn                    # noqa: F401
from repro_torch.kernels.sddmm import sddmm                # noqa: F401
from repro_torch.kernels.shift_conv import shift_conv2d    # noqa: F401
from repro_torch.kernels.spdmm import spdmm, spdmm_rows    # noqa: F401
