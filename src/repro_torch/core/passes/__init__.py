"""The compilation passes: the paper's five (§V-B) plus Step-6 liveness.

Port of ``src/repro/core/passes/__init__.py``."""
from repro_torch.core.passes.fusion import fuse_layers          # noqa: F401
from repro_torch.core.passes.lower import lower_to_matops       # noqa: F401
from repro_torch.core.passes.tiling import assign_tiles         # noqa: F401
from repro_torch.core.passes.select import (dense_to_ell,       # noqa: F401
                                            kernel_report, select_kernels,
                                            select_primitives)
from repro_torch.core.passes.schedule import schedule_plan      # noqa: F401
from repro_torch.core.passes.liveness import annotate_liveness  # noqa: F401
