"""The plan runtime: registry-dispatched op handlers (the APU's data path).

Port of ``src/repro/core/runtime/__init__.py``.  Importing this package
registers every handler module; ``validate_registry`` then proves the
runtime vocabulary and the lowering vocabulary (``plan.MATOP_KINDS``)
agree, so a kind that lowers but has no handler fails at import time.

    registry.py     @register_op decorator, run_op, not_ported
    residency.py    device-resident weights (collected once per runner)
    matmul.py       mm (every side but left_runtime); sddmm not yet
    conv.py         Fig. 7 shift-add convolution
    elementwise.py  ew + the shared fused epilogue + segment reductions
    pooling.py      globalpool
    shape.py        DM transpose/identity, reshape, concat
    graph_build.py  knn_graph
"""
from repro_torch.core.plan import MATOP_KINDS
from repro_torch.core.runtime.registry import (OpHandler,  # noqa: F401
                                               get_handler, register_op,
                                               registered_kinds, run_op,
                                               validate_registry)
from repro_torch.core.runtime import (conv, elementwise,  # noqa: F401
                                      graph_build, matmul, pooling, shape)

validate_registry(MATOP_KINDS)

__all__ = ["OpHandler", "register_op", "get_handler", "registered_kinds",
           "run_op", "validate_registry"]
