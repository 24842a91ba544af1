"""Device-resident weight planning — minimal port of
``src/repro/core/runtime/residency.py``.

GCV-Turbo keeps model parameters resident in on-chip buffers so execution
is pure data movement (§VII-D2).  ``collect_params`` walks an
``ExecutionPlan`` once at runner-build time and uploads every live
compile-time array (weights, ELL structures) to the device as a tensor,
exactly once; handlers read them through ``weight`` / ``opt_weight`` /
``ell_pair``.  ELL ``idx`` stays int32.  Identity/content dedup and hot
``swap`` are not ported yet (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import ELL_KERNELS, ExecutionPlan, MatOp

# Slot names for the two halves of an op's ELL structure (``op.ell`` is a
# positional (idx, val) pair, unlike the keyed ``op.weights``).
ELL_IDX, ELL_VAL = "ell_idx", "ell_val"


def op_param_slots(op: MatOp):
    """Yield ``(slot, host_array)`` for the op's *live* compile-time
    arrays: an ELL-family kernel executes from (idx, val), so the dense
    'adj'/'w' it was built from is dead; any other kernel executes from the
    dense operand, so the ELL halves are dead instead."""
    ell_live = op.ell is not None and op.kernel in ELL_KERNELS
    dead = {"adj", "w"} if ell_live else set()
    for name, value in op.weights.items():
        if value is not None and name not in dead:
            yield name, value
    if ell_live:
        yield ELL_IDX, op.ell[0]
        yield ELL_VAL, op.ell[1]


@dataclasses.dataclass
class ResidentParams:
    """A plan's compile-time arrays, resident on ``device``, keyed by
    ``(op.name, slot)``."""

    arrays: dict[tuple[str, str], torch.Tensor]
    device: torch.device

    def has(self, op: MatOp, slot: str) -> bool:
        return (op.name, slot) in self.arrays

    def get(self, op: MatOp, slot: str) -> torch.Tensor:
        return self.arrays[(op.name, slot)]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.arrays.values())


def _to_tensor(value, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(value), device=device)


def collect_params(plan: ExecutionPlan, device) -> ResidentParams:
    """One pass over the plan: upload every live compile-time array once."""
    device = torch.device(device)
    with obs.span("residency.upload", cat="runtime", plan=plan.name,
                  device=str(device)) as sp:
        arrays = {(op.name, slot): _to_tensor(value, device)
                  for op in plan.ops for slot, value in op_param_slots(op)}
        res = ResidentParams(arrays, device)
        sp.set(bytes=res.nbytes(), slots=len(arrays))
        return res


# ---------------------------------------------------------- handler seam --
def weight(op: MatOp, key: str, params: ResidentParams | None):
    """A required compile-time array: resident when params are bound, else
    staged per call on the CPU (direct ``run_op`` use)."""
    if params is not None:
        return params.get(op, key)
    return _to_tensor(op.weights[key])


def opt_weight(op: MatOp, key: str, params: ResidentParams | None):
    """An optional compile-time array, or None if the op doesn't carry it."""
    if op.weights.get(key) is None:
        return None
    return weight(op, key, params)


def ell_pair(op: MatOp, params: ResidentParams | None):
    """The op's (idx, val) ELL structure."""
    if params is not None:
        return params.get(op, ELL_IDX), params.get(op, ELL_VAL)
    return tuple(_to_tensor(a) for a in op.ell)
