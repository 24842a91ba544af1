"""Plan executor — a thin driver over the op-registry runtime.

Port of the per-sample path of ``src/repro/core/executor.py``.  It walks
the ``ExecutionPlan`` instruction sequence and dispatches every op through
``repro_torch.core.runtime.run_op``; each op executes the realization
Step 4b bound to it (``op.kernel``), so one plan can mix CUDA kernels and
plain-torch twins op by op.  Weights and compile-time ELL structures are
uploaded to the device once per runner (``runtime/residency.py``).

Execution is eager under ``torch.inference_mode()``; values are dropped
from the environment as soon as Step 6's ``op.frees`` says they are dead,
so the working set follows ``ExecutionPlan.peak_live_bytes()``.  Batched
runners, AOT warmup and the runner cache are ROADMAP queue 1 item 4.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.runtime import run_op
from repro_torch.core.runtime.residency import collect_params


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: it raises when there is none, so a missing
    GPU never turns silently into a CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    """One input on ``device``, by the reference's rule: it stages inputs
    with ``jnp.asarray`` under JAX's default of 32-bit types, which turns a
    float64 array into float32.  So floats wider than float32 become
    float32, numpy arrays and tensors alike; float32, narrower floats and
    integers stay as they are."""
    t = value if isinstance(value, torch.Tensor) else torch.tensor(
        np.asarray(value))
    if t.is_floating_point() and t.element_size() > 4:
        t = t.to(torch.float32)
    return t.to(device)


def build_runner(plan: ExecutionPlan, *, device=None,
                 free_dead: bool = True) -> Callable[..., tuple]:
    """Returns ``run(**inputs) -> tuple(outputs)`` for one sample.

    ``device`` defaults to ``cuda`` and raises without one; pass
    ``device="cpu"`` to run on the CPU, where every kernel wrapper takes its
    plain version.  Inputs may be numpy arrays or tensors; outputs are
    tensors on ``device``.  ``run.resident`` is the uploaded weight store.
    """
    device = resolve_device(device)
    with obs.span("build_runner", cat="runtime", plan=plan.name,
                  device=str(device)) as sp:
        resident = collect_params(plan, device)
        sp.set(resident_bytes=resident.nbytes())

    def run(**inputs):
        missing = [k for k in plan.input_names if k not in inputs]
        assert not missing, f"missing inputs: {missing}"
        with torch.inference_mode():
            env = {k: _as_tensor(v, device) for k, v in inputs.items()}
            for op in plan.ops:
                env[op.name] = run_op(op, env, resident)
                if free_dead:
                    for name in op.frees:
                        env.pop(name, None)
            return tuple(env[o] for o in plan.outputs)

    run.resident = resident
    run.device = device
    return run


def random_inputs(plan: ExecutionPlan, seed: int = 0,
                  input_shapes: dict[str, tuple] | None = None) -> dict:
    """Convenience: dense random numpy inputs for every plan input (the
    same draws as the reference's ``random_inputs`` for the same seed)."""
    rng = np.random.default_rng(seed)
    out = {}
    shapes = input_shapes or {}
    for op_name in plan.input_names:
        shape = shapes.get(op_name)
        if shape is None:
            shape = plan.meta.get("input_shapes", {}).get(op_name)
        assert shape is not None, f"no shape for input {op_name}"
        out[op_name] = rng.standard_normal(shape).astype(np.float32)
    return out
