"""Plan executor — a thin driver over the op-registry runtime.

Port of ``src/repro/core/executor.py``.  It walks the ``ExecutionPlan``
instruction sequence and dispatches every op through
``repro_torch.core.runtime.run_op``; each op executes the realization
Step 4b bound to it (``op.kernel``), so one plan can mix CUDA kernels and
plain-torch twins op by op.  Weights and compile-time ELL/COO structures
are uploaded to the device once per runner, deduplicated
(``runtime/residency.py``).

The op walk is eager under ``torch.inference_mode()``; values are dropped
from the environment as soon as Step 6's ``op.frees`` says they are dead,
so the working set follows ``ExecutionPlan.peak_live_bytes()``.  On top of
it:

  * **batched execution** — ``build_runner(plan, batch=N)`` expects every
    input stacked on a new leading axis of N and walks the plan once under
    ``batched_execution()``: each op runs its kind's batching rule (one
    launch for the batch where that leaves every sample's bits as they
    are) or loops its per-sample handler (``runtime/registry.py``).
    Weights and COO/ELL structures are shared; only activations gain the
    axis.  Outputs equal N per-sample runs bit for bit on the card;
  * **whole-request CUDA graphs** — ``jit=True`` (the reference's name: its
    whole-program ``jax.jit``) captures the eager walk of one request as
    one ``torch.cuda.CUDAGraph``, so a request costs one replay of host
    time.  Graphs are keyed by the inputs' shapes and dtypes, as jit keys
    its traces; ``run.trace_count()`` counts captures.  Inputs are copied
    into the graph's static input tensors (page-locked inputs without
    waiting for the stream, ``_pinned``); ``run`` returns copies of its
    static outputs, so an output already returned never changes under the
    next request.  A capture first runs the request once eagerly on a side
    stream (the kernel library builds and loads, first launches set their
    attributes), PyTorch's capture recipe;
  * **AOT warmup** — ``run.aot_compile()`` captures from the plan's
    recorded input shapes with zero inputs, so no live request pays a
    capture (the §VII-D2 fixed-latency argument).

``jit=None`` resolves as in the reference: a per-sample runner runs as a
graph, a batched one per op and eagerly.  On the CPU there are no graphs:
``jit`` has no effect and ``aot_compile()`` returns None.  On the card a
graph runner captures or raises; it never carries on eagerly.

A runner makes its device current while it runs (the kernels launch on
the current device, ``kernels/_build.stream_of``), and captures each
graph with that device current, on a stream of its own, from a memory
pool of its own.

**Batch sharding** — ``build_runner(plan, batch=N, mesh=mesh)`` over a 1-D
``("data",)`` mesh (``launch/mesh.py``) is the reference's SPMD runner
(``P("data")`` on the inputs and outputs, the weights replicated): each
mesh entry holds a replica of the weights and a batch runner of ``N //
mesh.size`` rows on a stream of its own, and the stacked batch is split
into contiguous blocks, block ``i`` to entry ``i``.  Every replica is
launched before any is waited on; the outputs keep the batch runner's
shapes and row order, on the mesh's first device.  Each replica's rows
run as a batch runner's rows run, so they equal the one-device runner's
bit for bit wherever its batches equal its samples (on the card).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.runtime import run_op
from repro_torch.core.runtime.context import batched_execution
from repro_torch.core.runtime.residency import collect_params
from repro_torch.launch.mesh import as_data_mesh


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: it raises when there is none, so a missing
    GPU never turns silently into a CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _host_tensor(value) -> torch.Tensor:
    """One input as a tensor where it lies, by the reference's rule: it
    stages inputs with ``jnp.asarray`` under JAX's default of 32-bit types,
    which turns a float64 array into float32.  So floats wider than
    float32 become float32, numpy arrays and tensors alike; float32,
    narrower floats and integers stay as they are."""
    t = value if isinstance(value, torch.Tensor) else torch.tensor(
        np.asarray(value))
    if t.is_floating_point() and t.element_size() > 4:
        t = t.to(torch.float32)
    return t


def _pinned(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` is a page-locked host tensor bound for the card, which
    a host-to-device copy reads without waiting for the stream: the caller
    then keeps it unchanged until the request's outputs are ready (the
    serving engine's staging slots).  A pageable input is copied as
    PyTorch copies it, after the stream's earlier work."""
    return device.type == "cuda" and t.device.type == "cpu" \
        and t.is_pinned()


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    """One input on ``device`` (``_host_tensor``'s rule)."""
    return _host_tensor(value).to(device)


def _on(device: torch.device):
    """Make ``device`` current for the block where it names one card."""
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mesh_device(mesh, device=None) -> torch.device:
    """The device a runner over ``mesh`` lives on: the mesh's first entry,
    which ``device`` must name when it is given."""
    first = torch.device(mesh.devices.flat[0])
    if device is not None:
        want = torch.device(device)
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device()
                                if torch.cuda.is_available() else 0)
        assert want == first, \
            f"device={want} must be the mesh's first entry {first} (or None)"
    return first


class _Graph:
    """One captured request: its static inputs, the graph, its static
    outputs."""
    __slots__ = ("inputs", "graph", "outputs")

    def __init__(self, inputs: dict, graph, outputs: tuple):
        self.inputs, self.graph, self.outputs = inputs, graph, outputs


def build_runner(plan: ExecutionPlan, *, device=None,
                 batch: int | None = None, jit: bool | None = None,
                 free_dead: bool = True, residency: bool = True,
                 mesh=None) -> Callable[..., tuple]:
    """Returns ``run(**inputs) -> tuple(outputs)``.

    ``device`` defaults to ``cuda`` and raises without one; pass
    ``device="cpu"`` to run on the CPU, where every kernel wrapper takes its
    plain version.  Inputs may be numpy arrays or tensors; outputs are
    tensors on ``device``.  ``batch=N`` expects every input stacked on a
    leading axis of N and returns outputs with that axis.  ``jit`` and the
    graphs: see the module docstring.  ``residency=False`` stages the
    weights anew on every call (the reference's legacy path), which a
    graph cannot capture: ``jit=None`` then resolves to eager, and
    ``jit=True`` raises on the card.

    ``mesh`` (a 1-D ``("data",)`` mesh) shards the batch axis over the
    mesh's entries (module docstring).  It needs ``batch`` divisible by
    the mesh's size and runs as graphs (``jit=False`` is refused, as the
    reference's sharded runner needs whole-program jit); ``device`` must
    be None or the mesh's first entry.  A one-entry mesh is the plain
    runner on that entry.

    The returned ``run`` carries:

      ``run.resident``      the ``ResidentParams`` (None without residency)
      ``run.aot_compile()`` capture ahead of traffic; None when eager
      ``run.trace_count()`` how many graphs were captured
      ``run.input_specs()`` name -> (shape, dtype), the batch axis included
      ``run.device``, ``run.jit`` (runs as CUDA graphs)
      ``run.mesh``          the mesh the batch axis is sharded over (None
                            for one device), ``run.replicas`` its entries'
                            runners
    """
    if mesh is not None:
        mesh = as_data_mesh(mesh)
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh_device(mesh, device), None
    if mesh is not None:
        assert batch is not None, \
            "mesh= shards the batch axis; build with batch=N"
        assert batch % mesh.size == 0, \
            f"batch {batch} must be divisible by the mesh's " \
            f"{mesh.size} devices (the serving engine's bucket rule)"
        assert jit is not False, \
            "sharded runners execute through whole-program jit; " \
            "mesh= is incompatible with jit=False"
        device, jit = mesh_device(mesh, device), True
    device = resolve_device(device)
    if jit is None:
        jit = batch is None and residency
    graphs = bool(jit) and device.type == "cuda"
    if graphs and not residency:
        raise ValueError("a CUDA-graph runner reads its weights by address; "
                         "residency=False stages them per call, which a "
                         "graph cannot capture: pass jit=False")
    if mesh is not None:
        return _mesh_runner(plan, mesh, batch, graphs, free_dead, residency)
    with obs.span("build_runner", cat="runtime", plan=plan.name,
                  batch=batch, jit=graphs, residency=residency,
                  device=str(device), devices=1) as sp:
        resident = collect_params(plan, device) if residency else None
        if resident is not None:
            sp.set(resident_bytes=resident.nbytes())
    return _device_runner(plan, device, batch, graphs, free_dead, residency,
                          resident)


def _device_runner(plan: ExecutionPlan, device: torch.device,
                   batch: int | None, graphs: bool, free_dead: bool,
                   residency: bool, resident, stream=None):
    """One device's runner over ``resident`` (a store on ``device``, or
    None without residency).  ``stream``: the stream its graphs are
    captured on (a new one of its own when None)."""
    state = {"graphs": {}, "captures": 0, "stream": stream,
             "version": resident.version if resident is not None else 0}

    def walk(env: dict) -> tuple:
        params = (resident if resident is not None
                  else collect_params(plan, device))
        with torch.inference_mode(), batched_execution(batch is not None):
            for op in plan.ops:
                env[op.name] = run_op(op, env, params)
                if free_dead:
                    for name in op.frees:
                        env.pop(name, None)
            return tuple(env[o] for o in plan.outputs)

    def capture(env: dict) -> _Graph:
        with obs.span("capture", cat="runtime", plan=plan.name,
                      batch=batch), torch.cuda.device(device):
            static = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in env.items()}
            for k, v in env.items():
                static[k].copy_(v)
            if state["stream"] is None:
                state["stream"] = torch.cuda.Stream(device)
            side = state["stream"]
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                walk(dict(static))
            # the graph gets a memory pool of its own (pool=None)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                outputs = walk(dict(static))
            torch.cuda.current_stream(device).wait_stream(side)
            state["captures"] += 1
            return _Graph(static, graph, outputs)

    def graph_for(env: dict) -> _Graph:
        if resident.version != state["version"]:
            # a slot moved to another buffer: every graph reads the old one
            state["graphs"].clear()
            state["version"] = resident.version
        sig = tuple((k, tuple(v.shape), v.dtype) for k, v in env.items())
        g = state["graphs"].get(sig)
        if g is None:
            g = state["graphs"][sig] = capture(env)
        return g

    def aot_compile():
        """Capture the request now, from the plan's recorded input shapes
        (zeros) — the serving warmup hook.  Returns the captured
        ``torch.cuda.CUDAGraph`` (the same one on every call), or None for
        an eager or CPU runner."""
        if not graphs:
            return None
        with obs.span("aot_compile", cat="runtime", plan=plan.name,
                      batch=batch), _on(device):
            zeros = {n: torch.zeros(s, dtype=d, device=device)
                     for n, (s, d) in _input_specs(plan, batch).items()}
            return graph_for(zeros).graph

    def run(**inputs):
        env = _stage(plan, batch, inputs)
        with _on(device):
            if not graphs:
                return walk({k: v.to(device,
                                     non_blocking=_pinned(v, device))
                             for k, v in env.items()})
            g = graph_for(env)
            for k, v in env.items():
                g.inputs[k].copy_(v, non_blocking=_pinned(v, device))
            g.graph.replay()
            return tuple(o.clone() for o in g.outputs)

    run.resident = resident
    run.aot_compile = aot_compile
    run.trace_count = lambda: state["captures"]
    run.input_specs = lambda: _input_specs(plan, batch)
    run.device = device
    run.jit = graphs
    run.mesh = None
    run.replicas = [run]
    return run


def _stage(plan: ExecutionPlan, batch: int | None, inputs: dict) -> dict:
    """The plan's inputs as tensors where they lie (``_host_tensor``),
    checked for presence and, batched, for the leading batch axis."""
    missing = [k for k in plan.input_names if k not in inputs]
    assert not missing, f"missing inputs: {missing}"
    env = {k: _host_tensor(inputs[k]) for k in plan.input_names}
    if batch is not None:
        for k, v in env.items():
            assert tuple(v.shape[:1]) == (batch,), \
                f"input {k!r}: expected leading batch axis {batch}, " \
                f"got shape {tuple(v.shape)}"
    return env


def _input_specs(plan: ExecutionPlan, batch: int | None) -> dict:
    shapes = plan.meta.get("input_shapes", {})
    spec = {}
    for name in plan.input_names:
        shape = shapes.get(name)
        assert shape is not None, \
            f"no recorded input shape for {name!r}; cannot capture"
        if batch is not None:
            shape = (batch, *shape)
        spec[name] = (tuple(shape), torch.float32)
    return spec


def _mesh_runner(plan: ExecutionPlan, mesh, batch: int, on_card: bool,
                 free_dead: bool, residency: bool):
    """The batch-sharded runner over ``mesh`` (module docstring);
    ``on_card``: its replicas run as CUDA graphs."""
    devices = [torch.device(d) for d in mesh.devices.flat]
    assert len({d.type for d in devices}) == 1, \
        f"a mesh's entries must be of one device type, got {mesh}"
    first, per = devices[0], batch // mesh.size
    with obs.span("build_runner", cat="runtime", plan=plan.name,
                  batch=batch, jit=on_card, residency=residency,
                  device=str(first), devices=mesh.size) as sp:
        resident = (collect_params(plan, first, mesh=mesh) if residency
                    else None)
        if resident is not None:
            sp.set(resident_bytes=resident.nbytes())
    stores = resident.stores() if resident is not None \
        else [None] * len(devices)
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devices]
    replicas = [_device_runner(plan, d, per, on_card, free_dead,
                               residency, store, stream)
                for d, store, stream in zip(devices, stores, streams)]

    def blocks(env: dict):
        for i in range(len(replicas)):
            yield {k: v[i * per:(i + 1) * per] for k, v in env.items()}

    def run(**inputs):
        env = _stage(plan, batch, inputs)
        if not on_card:
            parts = [rep(**block) for rep, block in zip(replicas,
                                                        blocks(env))]
            return tuple(torch.cat(outs) for outs in zip(*parts))
        cur = torch.cuda.current_stream(first)
        parts = []
        for rep, dev, stream, block in zip(replicas, devices, streams,
                                           blocks(env)):
            with torch.cuda.device(dev):
                stream.wait_stream(torch.cuda.current_stream(dev))
                for v in block.values():
                    if v.is_cuda:
                        v.record_stream(stream)
                with torch.cuda.stream(stream):
                    parts.append(tuple(o.to(first, non_blocking=True)
                                       for o in rep(**block)))
        for stream in streams:
            cur.wait_stream(stream)
        for outs in parts:
            for o in outs:
                o.record_stream(cur)
        return tuple(torch.cat(outs) for outs in zip(*parts))

    def aot_compile():
        """Capture every replica's request now; the replicas' graphs, or
        None on the CPU."""
        got = tuple(rep.aot_compile() for rep in replicas)
        return got if on_card else None

    run.resident = resident
    run.aot_compile = aot_compile
    run.trace_count = lambda: sum(rep.trace_count() for rep in replicas)
    run.input_specs = lambda: _input_specs(plan, batch)
    run.device = first
    run.jit = on_card
    run.mesh = mesh
    run.replicas = replicas
    return run


def random_inputs(plan: ExecutionPlan, seed: int = 0,
                  input_shapes: dict[str, tuple] | None = None,
                  batch: int | None = None) -> dict:
    """Convenience: dense random numpy inputs for every plan input (the
    same draws as the reference's ``random_inputs`` for the same seed).
    ``batch=N`` prepends a batch axis (matching ``build_runner(batch=N)``).
    """
    rng = np.random.default_rng(seed)
    out = {}
    shapes = input_shapes or {}
    for op_name in plan.input_names:
        shape = shapes.get(op_name)
        if shape is None:
            shape = plan.meta.get("input_shapes", {}).get(op_name)
        assert shape is not None, f"no shape for input {op_name}"
        if batch is not None:
            shape = (batch, *shape)
        out[op_name] = rng.standard_normal(shape).astype(np.float32)
    return out


def stack_inputs(samples: list[dict]) -> dict:
    """Stack per-sample input dicts into one batched input dict, on the
    host (``np.stack``; tensors with ``torch.stack`` where they lie), so a
    batched run makes one transfer per input name."""
    assert samples, "empty batch"
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = (torch.stack(vals) if isinstance(vals[0], torch.Tensor)
                  else np.stack([np.asarray(v) for v in vals]))
    return out
