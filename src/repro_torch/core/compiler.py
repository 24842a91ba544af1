"""The GCV-Turbo compiler driver (paper §V, plus Step-6 liveness).

Port of ``src/repro/core/compiler.py`` (numpy/stdlib only; imports rewritten).

``compile_graph`` runs the paper's five passes in order, then annotates
liveness (Step 6 — last-use info the runtime uses to free dead values), and
returns an ``ExecutionPlan`` — the analogue of the instruction-sequence
binary the APU executes. ``CompileOptions`` exposes exactly the knobs the
paper ablates (§VII-C): layer fusion, DM fusion, sparsity-aware mapping,
plus the cost target ('fpga', the paper's accelerator, or 'h100').

Every pass entry point opens an ``obs`` span (layer/op counts as
attributes), so a compile inside a tracing block — or with
``CompileOptions(telemetry=True)`` — lands in the exported Chrome trace
as one nested region per pass.  Tracing is off by default and costs one
attribute read per pass when disabled.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.core.ir import Graph
from repro_torch.core.passes import (annotate_liveness, assign_tiles,
                                     fuse_layers, lower_to_matops,
                                     schedule_plan, select_kernels,
                                     select_primitives)
from repro_torch.core.plan import ExecutionPlan


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    fuse: bool = True                 # Step 1 (ablation: §VII-C layer fusion)
    dm_fusion: bool = True            # §V-C2
    sparsity_aware: bool = True       # Step 4 (ablation: §VII-C)
    # Steps 3-4 cost target: 'fpga' (the paper's accelerator) | 'h100'
    # (the card's tile quantum and shared memory; Step 4 by device time)
    target: str = "fpga"
    # Step 4b — per-op kernel realization: 'cuda' (hand-written kernel
    # wherever the family has one, with recorded fallbacks) | 'torch'
    # (plain-torch twins everywhere) | 'auto' (the H100 cost model) |
    # 'measured' (timed through the on-disk autotune cache)
    kernels: str = "cuda"
    # JSON cache path for kernels='measured'; None = $REPRO_AUTOTUNE_CACHE
    # or .autotune_cache.json in the cwd
    autotune_cache: str | None = None
    # Record obs spans for this compile even outside a tracing block
    # (the spans land in the process tracer; export them with
    # obs.export_chrome_trace).  Tracing never changes the compiled plan.
    telemetry: bool = False


def compile_graph(g: Graph,
                  options: CompileOptions = CompileOptions(), *,
                  backend: str | None = None) -> ExecutionPlan:
    """Run the six passes.  ``backend`` is where the plan will run
    (``"cuda"`` or ``"cpu"``; None: the card when there is one), which
    Step 4b's ``auto`` and ``measured`` modes cost against."""
    with obs.telemetry(options.telemetry), \
            obs.span("compile", cat="compile", graph=g.name,
                     layers=len(g.layers),
                     frontend=g.meta.get("frontend")) as sp:
        fused = fuse_layers(g, enable=options.fuse,
                            dm_fusion=options.fuse and options.dm_fusion)
        plan = lower_to_matops(fused)                       # Step 2
        plan = assign_tiles(plan, target=options.target)    # Step 3
        plan = select_primitives(plan, target=options.target,   # Step 4
                                 enable=options.sparsity_aware)
        plan = select_kernels(plan, kernels=options.kernels,    # Step 4b
                              autotune_cache=options.autotune_cache,
                              backend=backend)
        plan = schedule_plan(plan)                          # Step 5
        plan = annotate_liveness(plan)                      # Step 6
        sp.set(ops=len(plan.ops))
    plan.meta["options"] = dataclasses.asdict(options)
    return plan
