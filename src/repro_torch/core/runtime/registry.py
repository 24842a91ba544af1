"""Op registry — the single dispatch surface of the plan runtime.

Port of ``src/repro/core/runtime/registry.py``.  Each op kind lives in one
handler module under ``repro_torch/core/runtime/`` and announces itself with

    @register_op("mm")
    def run_mm(op, env, params=None): ...

``run_op`` is the only entry point the executor needs.  Every kind in
``plan.MATOP_KINDS`` must have a handler (``validate_registry``).

Realization dispatch: handlers branch on ``op_kernel(op)`` — the
compile-time Step-4b choice recorded on the op.

Batched dispatch: under ``batched_execution()`` every env value carries a
leading batch axis.  A kind whose handler reads a sample's axes from the
end and runs the whole batch in one launch, where that leaves each sample's
result as its per-sample call gives it (a kernel whose launch plan follows
the per-sample problem, a purely elementwise op), says so with
``@register_batched`` and, where that holds only for some ops, a ``when``
check.  Every other op loops its per-sample handler over the batch axis and
stacks the results: bit for bit the per-sample run by construction, since
each sample's operands are laid out as a per-sample run lays them out
(``_Sample``).  Inside a CUDA graph the loop costs no host time.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping, Optional, Protocol

import torch

from repro_torch.core.plan import KERNELS, MatOp
from repro_torch.core.runtime.context import (batched_execution,
                                              in_batched_execution)
from repro_torch.core.runtime.residency import ResidentParams

# Per-sample runs read tensors that start where the caching allocator puts
# them (on 512-byte boundaries on the card); a kernel may take another
# route, and a PyTorch reduction another order of addition, at another
# alignment.  A sample's slice that starts off this boundary is copied.
ALIGN = 256


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
_BATCHED: dict[str, Callable[[MatOp, Mapping], bool]] = {}


def register_op(*kinds: str) -> Callable[[OpHandler], OpHandler]:
    """Decorator registering a handler for ``kinds``."""

    def deco(fn: OpHandler) -> OpHandler:
        for kind in kinds:
            assert kind not in _HANDLERS, \
                f"duplicate handler for op kind {kind!r}"
            _HANDLERS[kind] = fn
        return fn

    return deco


def register_batched(*kinds: str, when=None
                     ) -> Callable[[OpHandler], OpHandler]:
    """Decorator, above ``@register_op``: the handler of ``kinds`` takes a
    whole batch itself where ``when(op, env)`` holds (default: always);
    elsewhere ``run_op`` loops it per sample (see the module docstring)."""

    def deco(fn: OpHandler) -> OpHandler:
        for kind in kinds:
            assert kind not in _BATCHED, \
                f"duplicate batching rule for op kind {kind!r}"
            assert _HANDLERS.get(kind) is fn, \
                f"{kind!r}: only its own handler can take a batch"
            _BATCHED[kind] = when or (lambda op, env: True)
        return fn

    return deco


def get_handler(kind: str) -> OpHandler:
    try:
        return _HANDLERS[kind]
    except KeyError:
        raise NotImplementedError(
            f"no registered handler for op kind {kind!r}; "
            f"known: {sorted(_HANDLERS)}") from None


def registered_kinds() -> frozenset[str]:
    return frozenset(_HANDLERS)


class _Sample(Mapping):
    """Sample ``i`` of a batched env: ``env[name][i]``, copied where it
    would start off the ``ALIGN`` boundary (its strides kept)."""

    def __init__(self, env: Mapping, i: int):
        self._env, self._i = env, i

    def __getitem__(self, name):
        t = self._env[name][self._i]
        return t if t.data_ptr() % ALIGN == 0 else t.clone()

    def __iter__(self) -> Iterator:
        return iter(self._env)

    def __len__(self) -> int:
        return len(self._env)


def run_per_sample(handler: OpHandler, op: MatOp, env: Mapping,
                   params: ResidentParams | None):
    """The per-sample handler on each sample of a batch, the results
    stacked."""
    n = env[op.inputs[0]].shape[0]
    with batched_execution(False):
        return torch.stack([handler(op, _Sample(env, i), params)
                            for i in range(n)])


def run_op(op: MatOp, env: Mapping, params: ResidentParams | None = None):
    """Execute one MatOp against ``env`` — the runtime's only dispatch."""
    handler = get_handler(op.kind)
    whole = _BATCHED.get(op.kind)
    if not in_batched_execution() or (whole is not None and whole(op, env)):
        return handler(op, env, params)
    return run_per_sample(handler, op, env, params)


def validate_registry(expected_kinds: frozenset[str]) -> None:
    """Assert the registry and the lowering vocabulary agree exactly."""
    missing = expected_kinds - registered_kinds()
    extra = registered_kinds() - expected_kinds
    assert not missing, f"op kinds without handlers: {sorted(missing)}"
    assert not extra, f"handlers for unknown op kinds: {sorted(extra)}"
