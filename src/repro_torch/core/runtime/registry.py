"""Op registry — the single dispatch surface of the plan runtime.

Port of ``src/repro/core/runtime/registry.py``.  Each op kind lives in one
handler module under ``repro_torch/core/runtime/`` and announces itself with

    @register_op("mm")
    def run_mm(op, env, params=None): ...

``run_op`` is the only entry point the executor needs.  Every kind in
``plan.MATOP_KINDS`` must have a handler (``validate_registry``); kinds the
port does not execute yet are registered with ``not_ported``, which raises
``NotImplementedError`` naming the ROADMAP item that brings them — a plan
that reaches one fails loudly instead of being approximated.

Realization dispatch: handlers branch on ``op_kernel(op)`` — the
compile-time Step-4b choice recorded on the op.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Protocol

from repro_torch.core.plan import KERNELS, MatOp
from repro_torch.core.runtime.residency import ResidentParams


def op_kernel(op: MatOp) -> str:
    """The op's concrete realization (its Step-4b ``op.kernel`` binding)."""
    kern = op.kernel
    if kern is None:
        raise ValueError(f"{op.name}: no kernel bound (plans reach the "
                         f"runtime through compile_graph's Step 4b)")
    assert kern in KERNELS, f"{op.name}: unknown kernel {kern!r}"
    return kern


class OpHandler(Protocol):
    """A per-kind executor: consumes ``env`` entries named by ``op.inputs``
    (plus any env names in ``op.attrs`` such as ``fused_residual``) and
    returns the op's output tensor.  Compile-time arrays come from the
    device-resident ``params`` when bound (see ``runtime/residency.py``)."""

    def __call__(self, op: MatOp, env: Mapping,
                 params: Optional[ResidentParams] = None): ...


_HANDLERS: dict[str, OpHandler] = {}


def register_op(*kinds: str) -> Callable[[OpHandler], OpHandler]:
    """Decorator registering a handler for ``kinds``."""

    def deco(fn: OpHandler) -> OpHandler:
        for kind in kinds:
            assert kind not in _HANDLERS, \
                f"duplicate handler for op kind {kind!r}"
            _HANDLERS[kind] = fn
        return fn

    return deco


def not_ported(what: str, roadmap: str) -> OpHandler:
    """A handler for a kind the port does not execute yet."""

    def handler(op: MatOp, env: Mapping, params=None):
        raise NotImplementedError(
            f"op {op.name!r}: {what} is not ported yet ({roadmap})")

    return handler


def get_handler(kind: str) -> OpHandler:
    try:
        return _HANDLERS[kind]
    except KeyError:
        raise NotImplementedError(
            f"no registered handler for op kind {kind!r}; "
            f"known: {sorted(_HANDLERS)}") from None


def registered_kinds() -> frozenset[str]:
    return frozenset(_HANDLERS)


def run_op(op: MatOp, env: Mapping, params: ResidentParams | None = None):
    """Execute one MatOp against ``env`` — the runtime's only dispatch."""
    return get_handler(op.kind)(op, env, params)


def validate_registry(expected_kinds: frozenset[str]) -> None:
    """Assert the registry and the lowering vocabulary agree exactly."""
    missing = expected_kinds - registered_kinds()
    extra = registered_kinds() - expected_kinds
    assert not missing, f"op kinds without handlers: {sorted(missing)}"
    assert not extra, f"handlers for unknown op kinds: {sorted(extra)}"
