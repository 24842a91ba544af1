"""Step 6 — liveness analysis over the flat op program.

Port of ``src/repro/core/passes/liveness.py``
(numpy/stdlib only; imports rewritten).

The paper's APU keeps operands in managed on-chip buffers and recycles them
as the instruction sequence advances; the seed executor instead kept *every*
intermediate alive in its environment for the whole run.  This pass computes,
for each op, the set of environment entries whose last consumer it is
(``MatOp.frees``), so the runtime can drop dead values mid-plan and
``ExecutionPlan.peak_live_bytes()`` can report the working-set reduction.

An env entry is *used* by an op through ``op.inputs`` and through the fused
residual annotation (``attrs['fused_residual']`` names an env entry the
epilogue reads).  Plan outputs are never freed.  An op whose value has no
consumer and is not an output is dead on arrival and freed immediately.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.core.plan import ExecutionPlan, MatOp


def op_uses(op: MatOp) -> tuple[str, ...]:
    """Every environment name this op reads."""
    uses = tuple(op.inputs)
    res = op.attrs.get("fused_residual")
    if res:
        uses += (res,)
    return uses


def annotate_liveness(plan: ExecutionPlan) -> ExecutionPlan:
    with obs.span("pass.liveness", cat="compile", plan=plan.name,
                  ops=len(plan.ops)):
        return _annotate_liveness(plan)


def _annotate_liveness(plan: ExecutionPlan) -> ExecutionPlan:
    last_use: dict[str, int] = {}
    for i, op in enumerate(plan.ops):
        for name in op_uses(op):
            last_use[name] = i
    keep = set(plan.outputs)
    for i, op in enumerate(plan.ops):
        dead = {n for n in op_uses(op)
                if last_use.get(n) == i and n not in keep}
        if op.name not in last_use and op.name not in keep:
            dead.add(op.name)                    # value nobody consumes
        op.frees = tuple(sorted(dead))
    plan.meta["liveness"] = True
    return plan
