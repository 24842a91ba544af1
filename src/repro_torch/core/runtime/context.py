"""Execution-context flags the plan executor sets for handlers.

Port of ``src/repro/core/runtime/context.py``.  ``batched_execution`` is
active while a ``build_runner(batch=N)`` runner walks its plan: every env
value then carries a leading batch axis of N (``batch_ndim``), and
``run_op`` hands the whole batch to a handler that declares it takes one,
else loops the per-sample handler over the axis (``runtime/registry.py``).
A runner that runs as a CUDA graph reads the flag while it captures, so
the choice is recorded in the graph.
"""
from __future__ import annotations

import contextlib
import contextvars

_BATCHED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "batched_execution", default=False)


@contextlib.contextmanager
def batched_execution(on: bool = True):
    token = _BATCHED.set(on)
    try:
        yield
    finally:
        _BATCHED.reset(token)


def in_batched_execution() -> bool:
    return _BATCHED.get()


def batch_ndim() -> int:
    """The leading batch axes every env value carries: 1 under
    ``batched_execution()``, else 0.  Handlers that take a whole batch
    read a sample's axes from the end, and the batch axes from here."""
    return int(_BATCHED.get())
