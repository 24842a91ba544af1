"""One-call public API: ``gcv.compile`` / ``gcv.serve`` (paper §V-A).

Port of ``src/repro/gcv.py``:

    from repro_torch import gcv

    model = gcv.compile(fn, {"x": example})     # a torch callable / Module
    model = gcv.compile(graph)                  # GraphBuilder graph
    model = gcv.compile(plan)                   # pre-compiled ExecutionPlan

    model.warmup()                              # capture the request now
    out = model.run(x=sample)                   # one replay per request
    runb = model.batched(4)                     # cached per-batch runner
    model.swap_weights({"linear_1": {"w": w2}}) # in place, no re-capture
    model.stats() / model.lint() / model.input_specs / model.plan

    eng = gcv.serve({"b6": model, "b4": graph}, max_batch=8, warmup=True)

``compile`` routes everything through the same internals (tracing
frontend -> six passes -> plan/runner cache -> device-resident weights -> a
CUDA graph per request signature); callers never stitch those stages
together by hand.

Where the port differs from the reference:

  * ``device=None`` is the card, and raises without one; ``device="cpu"``
    runs every kernel's plain version (no graphs there);
  * ``kernels`` defaults to ``"cuda"`` (the reference: ``"auto"``).  The
    port's main path runs the hand-written kernels, and no plain version
    serves it while a card is present.  ``"auto"`` (the H100 cost model)
    and ``"measured"`` (timed through the autotune cache) are the
    reference's lattice, offered as modes the caller asks for: where they
    bind a plain twin (cuBLAS on a large dense product, where it beats the
    DDMM kernel), ``plan.meta["kernel_choices"]`` records it with its
    predicted or measured cost, so nothing is hidden;
  * a callable is a torch function or an ``nn.Module`` in eval mode,
    traced by ``repro_torch.frontend`` (``make_fx`` on fake tensors);
  * ``devices=`` / ``mesh=`` name ``torch.device``s (``launch/mesh.py``);
    an explicit sequence may repeat one device, each entry a replica of
    its own, which is how one host stands in for several.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping

import torch

from repro_torch import obs
from repro_torch.core.compiler import CompileOptions
from repro_torch.core.executor import (build_runner, mesh_device,
                                       random_inputs, resolve_device,
                                       stack_inputs)
from repro_torch.core.ir import Graph
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.runtime.cache import (BACKEND_MODES, cache_stats,
                                            cached_plan, cached_runner)
from repro_torch.core.runtime.residency import (collect_params,
                                                plan_param_bytes, plan_slots)

__all__ = ["CompiledModel", "compile", "serve", "stack_inputs", "trace_to"]


def _example_shapes(example_inputs: Mapping[str, Any]) -> dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in example_inputs.items()}


def _strip_leading_axis(example_inputs: Mapping[str, Any]) -> dict:
    """Per-sample examples from batched ones (each input's first sample;
    only shapes and dtypes are read)."""
    return {k: v[0] for k, v in example_inputs.items()}


def _resolve_options(options, overrides) -> CompileOptions:
    if options is None:
        return CompileOptions(**overrides)
    assert not overrides, \
        f"pass either options= or keyword overrides, not both: " \
        f"{sorted(overrides)}"
    return options


def _resolve_mesh(devices, mesh, device=None):
    """``devices=``/``mesh=``/``device=`` -> ``(device, mesh)``: the
    device the model lives on and a 1-D data mesh, or None for the
    single-device path (a one-entry mesh included).

    With a mesh, ``device`` is its first entry and must be None or name
    it.  An int counts cards (``make_data_mesh``): on a host with none it
    degrades to the CPU, which then runs only where ``device="cpu"`` asks
    for it — ``device=None`` still means the card and raises."""
    if mesh is not None:
        assert devices is None, "pass devices= or mesh=, not both"
        from repro_torch.launch.mesh import as_data_mesh
        mesh = as_data_mesh(mesh)
    elif devices is not None:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(devices)
    if mesh is None:
        return resolve_device(device), None
    if device is None and isinstance(devices, int) \
            and mesh.devices.flat[0].type != "cuda":
        resolve_device(None)           # no card: raises
    first = mesh_device(mesh, device)
    return resolve_device(first), (mesh if mesh.size > 1 else None)


@contextlib.contextmanager
def trace_to(path: str):
    """Record every span inside the block and write a Chrome/Perfetto
    trace-event JSON file on exit (written even when the block raises):

        with gcv.trace_to("trace.json"):
            model = gcv.compile(task, telemetry=True)
            model.warmup()
            model.run(**model.random_inputs())
    """
    tracer = obs.get_tracer()
    obs.clear()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.export_chrome_trace(path)


class CompiledModel:
    """The full lifecycle of one compiled model, owned in one object.

    Construct via ``gcv.compile``.  Runners (per-sample and per-batch) are
    built lazily; when the model was compiled from a ``Graph`` they come
    from the process-wide plan/runner cache (``core.runtime.cache``), so
    two holders of one graph share weights and captured graphs — until
    ``swap_weights``, after which this model's runners are its own.
    """

    def __init__(self, plan: ExecutionPlan, *, graph: Graph | None = None,
                 options: CompileOptions, device: torch.device,
                 residency: bool = True, batch: int | None = None,
                 mesh=None):
        self.plan = plan
        self.graph = graph
        self.options = options
        self.device = device
        self.residency = residency
        self.batch = batch                   # default batch for .run()
        # 1-D data mesh for batch-axis sharding (gcv.compile(devices=));
        # None = one device.  Batched runners shard their leading axis over
        # it; per-sample runners run on ``device``, its first entry.
        self.mesh = mesh
        self._runners: dict[tuple, Callable] = {}
        self._private = graph is None
        self._swaps: dict[tuple[str, str], Any] = {}
        self._sizing = None          # memoized host-side ResidentParams

    # ------------------------------------------------------------ runners --
    def runner(self, batch: int | None = None, *, jit: bool | None = None):
        """The runner for ``batch`` (``run(**inputs)`` with ``aot_compile``,
        ``resident`` and ``trace_count`` attached).  ``jit=None`` keeps
        ``build_runner``'s default: a CUDA graph per sample, eager per op
        batched.

        On a model compiled with ``devices=``/``mesh=``, batched runners
        shard the batch axis over the mesh (``jit`` resolves to True: the
        replicas run as graphs) and ``batch`` must be divisible by the
        device count; per-sample runners run on the mesh's first device."""
        mesh = self.mesh if batch is not None else None
        if mesh is not None:
            if jit is None:
                jit = True
            assert jit, \
                "a mesh-sharded batched runner executes through " \
                "whole-program jit; jit=False is single-device only"
            assert batch % mesh.size == 0, \
                f"batch {batch} must be divisible by the mesh's " \
                f"{mesh.size} devices (buckets stay powers of two and " \
                f"divisible by the device count)"
        key = (batch, jit)
        if not self._private:
            run = cached_runner(self.graph, self.options, device=self.device,
                                batch=batch, jit=jit,
                                residency=self.residency, mesh=mesh)
            self._runners[key] = run
            return run
        run = self._runners.get(key)
        if run is None:
            run = build_runner(self.plan, device=self.device, batch=batch,
                               jit=jit, residency=self.residency, mesh=mesh)
            self._apply_swaps(run)
            self._runners[key] = run
        return run

    def run(self, **inputs) -> tuple:
        """Execute the model (per-sample, or batched when the model was
        compiled with ``batch=N`` — inputs then carry the leading axis)."""
        return self.runner(self.batch)(**inputs)

    __call__ = run

    def batched(self, n: int, *, jit: bool | None = None):
        """Cached runner expecting every input stacked on a leading axis of
        size ``n`` (``gcv.stack_inputs`` builds that from samples)."""
        assert n >= 1, f"batch must be >= 1, got {n}"
        return self.runner(n, jit=jit)

    # ------------------------------------------------------------- warmup --
    def aot_compile(self):
        """Capture the default runner's request now (see ``build_runner``);
        None where it runs eagerly (batched by default, or on the CPU)."""
        return self.runner(self.batch).aot_compile()

    def warmup(self, batches=None) -> set:
        """Capture runners ahead of traffic.  ``batches=None`` warms the
        default ``run()`` runner; otherwise each listed batch size is warmed
        as a graph runner (``jit=True``).  Returns the batch sizes captured
        (eager and CPU runners have nothing to capture)."""
        warmed = set()
        if batches is None:
            if self.aot_compile() is not None:
                warmed.add(self.batch)
            return warmed
        for b in batches:
            if self.batched(b, jit=True).aot_compile() is not None:
                warmed.add(b)
        return warmed

    # ----------------------------------------------------------- hot swap --
    def swap_weights(self, updates: Mapping) -> None:
        """Replace compile-time weights without recompiling.

        ``updates`` maps ``op_name -> {slot: value}`` (or flat
        ``(op_name, slot) -> value``); op names and slots are the plan's.
        The first swap makes the model's runners private (other holders of
        the same graph keep the original weights) and rebuilds them lazily;
        later swaps write into the private runners' buffers in place, which
        their captured graphs read with no re-capture."""
        assert self.residency, \
            "swap_weights requires residency=True (the device-resident " \
            "weight store is what gets swapped)"
        flat: dict[tuple[str, str], Any] = {}
        for key, value in updates.items():
            if isinstance(key, tuple):
                flat[key] = value
            else:
                for slot, v in value.items():
                    flat[(key, slot)] = v
        known = plan_slots(self.plan)
        missing = [k for k in flat if k not in known]
        assert not missing, \
            f"unknown weight slots {missing}; known op/slot pairs come " \
            f"from the plan's ops"
        self._swaps.update(flat)
        if not self._private:
            self._private = True
            self._runners.clear()
            return
        for run in self._runners.values():
            for (op_name, slot), value in flat.items():
                run.resident.swap(op_name, slot, value)

    def _apply_swaps(self, run) -> None:
        for (op_name, slot), value in self._swaps.items():
            run.resident.swap(op_name, slot, value)

    # -------------------------------------------------------- introspection
    @property
    def input_specs(self) -> dict[str, tuple]:
        """Per-sample input specs, name -> ``(shape, dtype)``, from the
        plan's recorded shapes.  ``run()`` on a ``batch=N`` model expects
        each with an extra leading axis of N."""
        shapes = self.plan.meta.get("input_shapes", {})
        return {n: (tuple(shapes[n]), torch.float32)
                for n in self.plan.input_names}

    def lint(self) -> str:
        """Trace-provenance report (which aten nodes produced each layer)
        for traced models, followed by the Step-4b kernel-choice report
        (per-op realization, decision source, predicted/measured cost)."""
        from repro_torch.core.passes import kernel_report
        from repro_torch.frontend.lint import lint
        head = (f"plan {self.plan.name!r}: compiled from an "
                f"ExecutionPlan — no layer graph to lint"
                if self.graph is None else lint(self.graph))
        return head + "\n\n" + kernel_report(self.plan)

    # ----------------------------------------------------------- profiling
    def profile(self, inputs: Mapping[str, Any] | None = None, *,
                repeats: int = 3) -> dict:
        """Measured seconds per MatOp on the model's device (``op_name ->
        row``): op by op, a synchronize between ops, best of ``repeats``."""
        return obs.profile_plan(self.plan, inputs, repeats=repeats,
                                device=self.device)

    def profile_report(self, inputs: Mapping[str, Any] | None = None, *,
                       repeats: int = 3) -> dict:
        """``profile()`` plus the predicted-vs-measured verdict;
        ``result['text']`` is the rendered table."""
        return obs.profile_report(self.plan, inputs, repeats=repeats,
                                  device=self.device)

    def stats(self) -> dict:
        """One dict over the whole lifecycle: plan shape, primitive and
        kernel mix, memory planning, residency footprint (with the bytes
        folded by content dedup), runner and capture state, and the process
        plan/runner cache counters.  ``resident_bytes`` is the total over
        the replicas of a ``devices=N`` model ("one upload per device"),
        ``resident_bytes_per_device`` one device's footprint."""
        stores = [r.resident for r in self._runners.values()
                  if r.resident is not None]
        # prefer the store whose replication matches the model's mesh (a
        # devices=N model may also hold a per-sample one-device runner)
        want = self.mesh.size if self.mesh is not None else 1
        resident = next((s for s in stores if s.replicas == want),
                        stores[0] if stores else None)
        per_device = total = None
        if resident is not None:
            total = resident.nbytes()
            per_device = total // resident.replicas
        elif self.residency:
            if self._sizing is None:      # hash once, not per stats() call
                self._sizing = collect_params(self.plan, "cpu")
            resident = self._sizing
            per_device = resident.nbytes()
            total = per_device * want
        out = {
            "name": self.plan.name,
            "frontend": self.plan.meta.get("frontend"),
            "ops": len(self.plan.ops),
            "primitives": self.plan.primitive_counts(),
            "kernels": self.plan.kernel_counts(),
            "kernels_mode": self.plan.meta.get("kernels_mode"),
            "peak_live_bytes": self.plan.peak_live_bytes(),
            "param_bytes": plan_param_bytes(self.plan),
            "runners_built": len(self._runners),
            "captures": sum(r.trace_count() for r in self._runners.values()),
            "default_batch": self.batch,
            "swapped_slots": len(self._swaps),
            "device": str(self.device),
            "devices": want,
        }
        if resident is not None:
            out["resident_bytes"] = total
            out["resident_bytes_per_device"] = per_device
            out["value_deduped_bytes"] = resident.value_dedup_bytes
        out["cache"] = cache_stats()
        return out

    def random_inputs(self, seed: int = 0, *,
                      batch: int | None = "default") -> dict:
        """Random inputs matching ``input_specs``; ``batch`` defaults to
        the model's."""
        b = self.batch if batch == "default" else batch
        return random_inputs(self.plan, seed=seed, batch=b)

    def __repr__(self) -> str:
        return (f"CompiledModel({self.plan.name!r}, "
                f"frontend={self.plan.meta.get('frontend')!r}, "
                f"ops={len(self.plan.ops)}, batch={self.batch}, "
                f"device={str(self.device)!r}, "
                f"devices={self.mesh.size if self.mesh else 1})")


def compile(model, example_inputs: Mapping[str, Any] | None = None, *,
            batch: int | None = None, options: CompileOptions | None = None,
            residency: bool = True, example_batched: bool | None = None,
            name: str | None = None, device=None, devices=None, mesh=None,
            **option_overrides) -> CompiledModel:
    """Compile anything the pipeline can ingest into a ``CompiledModel`` on
    ``device`` (``None``: the card, raising without one).

    ``model`` is one of:

      * a torch callable or an ``nn.Module`` in eval mode —
        ``example_inputs`` (a tensor or array per input; only shapes and
        dtypes are read) names the model inputs; the tracing frontend
        recovers the layer graph (``frontend.to_graph``) on the host, and
        the plan runs on ``device`` like any other;
      * a layer ``Graph`` (from ``GraphBuilder`` or a prior trace);
      * an already-compiled ``ExecutionPlan``.

    ``batch=N`` makes ``run()`` expect and return a leading batch axis of
    N (per-batch runners for other sizes via ``.batched(n)``).  When
    tracing a callable with ``batch=N`` and every example input carrying
    that leading axis, the axis is stripped before tracing (with a
    ``UserWarning`` saying so); ``example_batched`` forces (``True``) or
    forbids (``False``) the stripping.  ``name`` names a traced graph
    (default: the callable's ``__name__``).  Compile
    options come either as ``options=CompileOptions(...)`` or as keyword
    overrides (``gcv.compile(g, kernels="torch")``); ``kernels`` is
    ``"cuda"`` (the default), ``"torch"``, ``"auto"`` (the H100 cost
    model) or ``"measured"`` (timed on ``device`` through the autotune
    cache at ``autotune_cache=``).  ``telemetry=True`` records one span per
    compiler pass and is a distinct plan-cache key.

    ``devices=``/``mesh=`` turn on batch-axis data parallelism:
    ``devices`` is an int (the first N cards), a device sequence (which
    may repeat a device: each entry is a replica), ``mesh`` a pre-built
    1-D ``("data",)`` mesh (``launch.mesh.make_data_mesh``).  Every
    ``.batched(n)`` runner then shards its leading axis over the mesh
    (``n`` divisible by the device count), each entry with a replica of
    the resident weights, a CUDA graph per bucket and a stream of its
    own; ``device`` is the mesh's first entry (None, or naming it).  A
    one-device mesh is the single-device runner.  An int above the cards
    present degrades with a ``UserWarning`` (``stats()["devices"]`` says
    how many were taken).
    """
    assert isinstance(model, (ExecutionPlan, Graph)) or callable(model), \
        f"cannot compile {type(model).__name__}: expected a torch " \
        f"callable, a Graph, or an ExecutionPlan"
    assert isinstance(model, (ExecutionPlan, Graph)) \
        or example_inputs is not None, \
        "compiling a callable requires example_inputs (a tensor or array " \
        "per named input)"
    opts = _resolve_options(options, option_overrides)
    dev, dmesh = _resolve_mesh(devices, mesh, device)
    if isinstance(model, ExecutionPlan):
        assert example_inputs is None, \
            "an ExecutionPlan is already compiled; example_inputs are " \
            "only for tracing a callable"
        if model.meta.get("kernels_mode") != opts.kernels or (
                opts.kernels in BACKEND_MODES
                and model.meta.get("kernels_backend") != dev.type):
            # re-bind realizations in place: kernel selection is the only
            # pass whose inputs (shapes/nnz) are already on the plan
            from repro_torch.core.passes import select_kernels
            select_kernels(model, kernels=opts.kernels,
                           autotune_cache=opts.autotune_cache,
                           backend=dev.type)
        return CompiledModel(model, graph=None, options=opts, device=dev,
                             residency=residency, batch=batch, mesh=dmesh)
    if isinstance(model, Graph):
        assert example_inputs is None, \
            "a layer Graph declares its own inputs; example_inputs are " \
            "only for tracing a callable"
        return CompiledModel(cached_plan(model, opts, backend=dev.type),
                             graph=model, options=opts, device=dev,
                             residency=residency, batch=batch, mesh=dmesh)
    shapes = _example_shapes(example_inputs)
    strip = example_batched
    if strip is None:
        strip = batch is not None and all(
            len(s) >= 1 and s[0] == batch for s in shapes.values())
        if strip:
            # auto-detect is a guess: a genuine per-sample leading dim
            # that happens to equal `batch` would be mis-stripped, so say
            # what was decided and how to override it
            import warnings
            warnings.warn(
                f"gcv.compile: every example input leads with axis "
                f"{batch} == batch, so it is being interpreted as the "
                f"batch axis and stripped before tracing; pass "
                f"example_batched=True to silence this, or "
                f"example_batched=False if {batch} is a genuine model "
                f"dimension", UserWarning, stacklevel=2)
    if strip:
        leads = {s[0] for s in shapes.values() if len(s) >= 1}
        assert len(leads) == 1 and all(len(s) >= 1
                                       for s in shapes.values()), \
            f"example_batched expects one shared leading batch axis, " \
            f"got shapes {shapes}"
        (lead,) = leads
        assert batch is None or batch == lead, \
            f"batch={batch} does not match the examples' leading " \
            f"axis {lead}"
        batch = lead if batch is None else batch
        example_inputs = _strip_leading_axis(example_inputs)
    from repro_torch import frontend
    graph = frontend.to_graph(
        model, example_inputs,
        name=name or getattr(model, "__name__", None)
        or type(model).__name__)
    return CompiledModel(cached_plan(graph, opts, backend=dev.type),
                         graph=graph, options=opts, device=dev,
                         residency=residency, batch=batch, mesh=dmesh)


def serve(models: Mapping[str, Any], *,
          options: CompileOptions | None = None, max_batch: int = 8,
          jit: bool = True,
          pipeline_depth: int = 2, residency: bool = True, warmup=False,
          devices=None, mesh=None, slo_ms: float | None = None,
          scheduler=None, max_pipeline_depth: int | None = None,
          graph_buckets: Mapping[str, Any] | None = None, device=None,
          **option_overrides):
    """Build the micro-batching serving engine from models, not plumbing.

    ``models`` maps task name -> anything ``gcv.compile`` accepts (a
    ``CompiledModel``, a layer ``Graph``, an ``ExecutionPlan``, or a
    ``(fn, example_inputs)`` pair for a torch callable or module).
    Pre-compiled models keep their own kernel/residency settings;
    everything else is compiled with this call's options (``kernels=``
    picks the realization mode, ``"cuda"`` by default) on ``device``
    (None: the card, raising without one).  ``warmup=True`` builds and
    captures every (task, bucket) runner before returning — no live
    request ever builds or captures.  The engine's ``stats()`` reads from
    its own ``obs.MetricsRegistry``; run it inside ``gcv.trace_to(path)``
    to capture per-batch and per-request spans.

    ``slo_ms=`` is the default per-request deadline (``submit`` may
    override with ``deadline_ms=``/``priority=``), switches the default
    policy to the SLO-aware one (``scheduler=`` names ``"fifo"``/``"slo"``
    or passes a ``serve.Scheduler``), and turns on adaptive pipeline depth
    within ``[1, max_pipeline_depth]``.  Drive an open-loop arrival
    schedule with ``engine.stream(...)`` or pump ``engine.poll()``.

    ``graph_buckets=`` serves variable-topology tasks: map a task name to
    the node counts it serves at and make its ``models`` entry a factory
    ``n_nodes -> model spec`` (b6-dyn: ``lambda n:
    TRACED_TASKS["b6-dyn"](n_points=n)``, a traced ``(fn, example)``
    pair, or ``lambda n: build_dynamic_task("b6-dyn", n_points=n)``).
    ``submit`` routes each request to the smallest bucket that fits
    (zero-padding the node-indexed inputs; the model's validity mask keeps
    padded nodes inert) and raises ``ValueError`` for requests over the
    largest bucket.

    ``devices=``/``mesh=`` serve over a device mesh (``compile``'s
    meaning): every bucketed runner shards its batch axis over the 1-D
    data mesh, buckets stay powers of two but never drop below the device
    count, requests are placed round-robin over the devices, and the
    engine keeps its in-flight queues, pad counts and trace tracks per
    device.  ``gcv.serve(models, devices=N)`` is the whole change; a
    one-device mesh is exactly the one-device engine.
    """
    from repro_torch.serve.gnncv import GNNCVServeEngine
    opts = _resolve_options(options, option_overrides)
    eng = GNNCVServeEngine(dict(models), options=opts, max_batch=max_batch,
                           jit=jit, pipeline_depth=pipeline_depth,
                           residency=residency, devices=devices, mesh=mesh,
                           slo_ms=slo_ms, scheduler=scheduler,
                           max_pipeline_depth=max_pipeline_depth,
                           graph_buckets=graph_buckets, device=device)
    if warmup:
        eng.warmup()
    return eng
