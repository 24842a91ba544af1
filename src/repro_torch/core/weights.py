"""Weight carrier: write externally supplied parameters into a plan.

``load_weights(plan, arrays)`` takes ``{op_name: {slot: ndarray}}`` with
slots ``w``, ``b``, ``adj`` (dense operands in ``op.weights``) and
``ell_idx`` / ``ell_val`` (the compile-time ELL pair in ``op.ell``) — for
instance the JAX reference's compiled parameters exported as numpy — and
replaces the plan's arrays in place, so both packages can run on identical
parameters.  Shapes and dtypes must match what the plan already holds.
It has no counterpart file in the reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.runtime.residency import ELL_IDX, ELL_VAL


def _checked(name: str, slot: str, old, new) -> np.ndarray:
    new = np.asarray(new)
    if old is None or new.shape != old.shape or new.dtype != old.dtype:
        raise ValueError(
            f"load_weights: {name}/{slot} is "
            f"{None if old is None else (old.shape, old.dtype)}, "
            f"got {(new.shape, new.dtype)}")
    return np.array(new)


def load_weights(plan: ExecutionPlan, arrays: dict) -> ExecutionPlan:
    """Replace ``plan``'s compile-time arrays with ``arrays``; returns the
    plan.  Unknown op names or slots raise."""
    ops = {op.name: op for op in plan.ops}
    for name, slots in arrays.items():
        if name not in ops:
            raise KeyError(f"load_weights: no op {name!r} in {plan.name!r}")
        op = ops[name]
        for slot, value in slots.items():
            if slot in (ELL_IDX, ELL_VAL):
                pos = 0 if slot == ELL_IDX else 1
                old = op.ell[pos] if op.ell is not None else None
                pair = list(op.ell)
                pair[pos] = _checked(name, slot, old, value)
                op.ell = tuple(pair)
            else:
                op.weights[slot] = _checked(name, slot,
                                            op.weights.get(slot), value)
    return plan
