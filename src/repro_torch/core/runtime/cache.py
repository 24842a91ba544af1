"""Plan/runner cache keyed on ``(graph, options, device, batch, ...)``.

Port of ``src/repro/core/runtime/cache.py``.  Compilation (six passes), the
weight upload and a CUDA-graph capture all cost far more than one
inference, so a serving process must never repeat them for a graph it has
already seen.  Graphs are keyed by identity through a
``WeakKeyDictionary``: entries die with their graph, so a long-running
server cannot leak plans for models it dropped.  Hit and miss counters live
in the process-global ``obs.metrics()`` registry, prefixed ``cache.``.
"""
from __future__ import annotations

import weakref

from repro_torch import obs
from repro_torch.core.compiler import CompileOptions, compile_graph
from repro_torch.core.ir import Graph
from repro_torch.core.plan import ExecutionPlan

_PLANS: "weakref.WeakKeyDictionary[Graph, dict]" = weakref.WeakKeyDictionary()
_RUNNERS: "weakref.WeakKeyDictionary[Graph, dict]" = \
    weakref.WeakKeyDictionary()
_STAT_KEYS = ("plan_hits", "plan_misses", "runner_hits", "runner_misses")


def _stat(name: str) -> obs.Counter:
    return obs.metrics().counter(f"cache.{name}")


# Step 4b modes whose bindings depend on where the plan runs: a plan they
# select for the CPU (every twin) must never serve the card, so their plans
# are keyed on the backend too.
BACKEND_MODES = ("auto", "measured")


def cached_plan(graph: Graph, options: CompileOptions = CompileOptions(),
                *, backend: str | None = None) -> ExecutionPlan:
    """Compile ``graph`` once per distinct ``options`` — and, under the
    ``auto`` and ``measured`` kernel modes, per ``backend`` (``"cuda"`` or
    ``"cpu"``; None: the card when there is one)."""
    if options.kernels in BACKEND_MODES:
        if backend is None:
            from repro_torch.core.passes.select import default_backend
            backend = default_backend()
        key = (options, backend)
    else:
        key = (options, None)
    per_graph = _PLANS.setdefault(graph, {})
    if key not in per_graph:
        _stat("plan_misses").inc()
        per_graph[key] = compile_graph(graph, options, backend=key[1])
    else:
        _stat("plan_hits").inc()
    return per_graph[key]


def cached_runner(graph: Graph,
                  options: CompileOptions = CompileOptions(), *,
                  device=None, batch: int | None = None,
                  jit: bool | None = None, free_dead: bool = True,
                  residency: bool = True, mesh=None):
    """Runner for ``graph``, one per (options, device, batch, jit, ...,
    mesh).

    Kernel realizations are compile-time plan state (``options.kernels``
    via Step 4b), so two kernel modes are two plans, and under ``auto``
    and ``measured`` each device type selects its own plan.  ``device`` is
    resolved first (``None`` is the card, or the first entry of
    ``mesh``), so ``None`` and ``"cuda"`` share an entry.  ``jit=None``
    lets ``build_runner`` resolve it (a CUDA graph per sample, eager per op
    batched).  A graph runner keeps its captures, so the runner cache is
    what amortizes capturing.

    ``mesh`` (batch-axis sharding) is part of the key: the same graph
    served over two meshes is two runners with two replicated weight
    stores.  A mesh hashes by its device grid and axis names, so two equal
    meshes share one entry."""
    from repro_torch.core.executor import (build_runner, mesh_device,
                                           resolve_device)
    device = (mesh_device(mesh, device) if mesh is not None
              else resolve_device(device))
    key = (options, device, batch, jit, free_dead, residency, mesh)
    per_graph = _RUNNERS.setdefault(graph, {})
    if key not in per_graph:
        _stat("runner_misses").inc()
        per_graph[key] = build_runner(
            cached_plan(graph, options, backend=device.type), device=device,
            batch=batch, jit=jit,
            free_dead=free_dead, residency=residency, mesh=mesh)
    else:
        _stat("runner_hits").inc()
    return per_graph[key]


def cache_stats() -> dict[str, int]:
    """Sizes and effectiveness counters (hits/misses since the last
    ``clear_caches``)."""
    return {"graphs": len(_PLANS),
            "plans": sum(len(v) for v in _PLANS.values()),
            "runners": sum(len(v) for v in _RUNNERS.values()),
            **{k: _stat(k).value for k in _STAT_KEYS}}


def clear_caches() -> None:
    _PLANS.clear()
    _RUNNERS.clear()
    obs.metrics().reset("cache.")
