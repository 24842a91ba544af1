"""KNN — fused pairwise distance + k-nearest selection.

Port of ``src/repro/kernels/knn.py`` (``knn``).  ``(N, F)`` points ->
int32 ``(N, k)`` neighbor indices under the pinned semantics documented on
``ref.knn_ref``: ascending squared-L2 distance, ties toward the lower
index, no self match unless ``self_loops``, ``mask <= 0`` candidates never
chosen while others remain; any ``1 <= k <= N``, as in the reference.  The
kernel is ``csrc/knn.cu``: a warp-list route for ``k <= WARP_MAX_K`` and a
sort route (one block per row, a bitonic sort of the row's keys) above it.
It never stores the ``(N, N)`` distances and agrees with the plain version
bit for bit.

On a CPU tensor the wrapper runs the plain version (``ref.knn_ref``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# The largest k of the kernel's warp-list route (``WARP_K`` in csrc/knn.cu;
# b6-dyn uses 20, b7-dyn 9); every larger k takes the sort route.
WARP_MAX_K = 64


def knn(x: torch.Tensor, k: int, *, mask: torch.Tensor | None = None,
        self_loops: bool = False) -> torch.Tensor:
    """``(N, F)`` float32 (or bf16, upcast) points -> int32 ``(N, k)``.

    ``mask``: optional ``(N,)`` / ``(N, 1)`` validity, zero entries never
    selected."""
    if x.ndim != 2:
        raise ValueError(f"knn: expects (N, F) points, got {tuple(x.shape)}")
    n, f = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"knn: k={k} out of range for {n} points")
    if mask is not None:
        if mask.numel() != n:
            raise ValueError(f"knn: mask {tuple(mask.shape)} for {n} points")
        mask = mask.reshape(n).to(torch.float32)
    if x.device.type == "cpu":
        return ref.knn_ref(x, k, mask=mask, self_loops=self_loops)
    if x.dtype == torch.bfloat16:
        x = x.float()
    _build.require_cuda("knn", x, mask,
                        dtypes=(torch.float32, torch.float32))
    out = torch.empty((n, k), device=x.device, dtype=torch.int32)
    lib = _build.library()
    nbytes = lib.repro_knn_scratch_bytes(n, k)      # 0 on the warp route
    scratch = (torch.empty(nbytes, device=x.device, dtype=torch.uint8)
               if nbytes else None)
    err = lib.repro_knn(_build.ptr(x), _build.ptr(mask), _build.ptr(out),
                        _build.ptr(scratch), n, f, k, int(self_loops),
                        _build.stream_of(x, "knn"))
    _build.check(err, "knn")
    _build.counted(knn)
    return out


knn.launches = knn.captured = 0
