"""Per-op profiling — measured seconds per MatOp, beside the cost model.

Port of ``src/repro/obs/profile.py``.  ``profile_plan`` executes an
``ExecutionPlan`` op by op, so each MatOp's time is attributable to that
op (a whole-request CUDA graph hides per-op cost).  On the card each op is
timed by CUDA events with a synchronize between ops; on the CPU by the
host clock.  ``profile_report`` then lines the measurements up with Step
4b's H100-model predictions (``plan.meta["kernel_choices"]``) and — for
ops whose realization family has real alternatives — times the rival
kernels standalone to compute the **cost-model agreement rate**: the
fraction of multi-candidate ops where the predicted argmin picks the same
kernel the measurement does.  Off the card only the plain twins can run,
so an op with one measurable candidate is not considered.

Profiling is measurement-time only: it never touches the serving path.
"""
from __future__ import annotations

from repro_torch.obs.trace import now, span

__all__ = ["profile_plan", "profile_report", "render_report"]


def profile_plan(plan, inputs=None, *, repeats: int = 3,
                 device=None) -> dict:
    """Measured seconds per MatOp, keyed like ``meta["kernel_choices"]``.

    Runs the plan eagerly op by op on ``device`` (``None``: the card; it
    raises without one) with device-resident weights and no liveness frees;
    each op's time is the best of ``repeats`` full passes after one warmup
    pass that pays the kernel build and first launches.  Returns
    ``op_name -> {"s", "kernel", "kind", "primitive", "predicted_s"}``.
    """
    import torch

    from repro_torch.core.executor import (_as_tensor, random_inputs,
                                           resolve_device)
    from repro_torch.core.runtime import run_op
    from repro_torch.core.runtime.residency import collect_params

    assert repeats >= 1, f"repeats must be >= 1, got {repeats}"
    device = resolve_device(device)
    if inputs is None:
        inputs = random_inputs(plan, seed=0)
    base = {k: _as_tensor(v, device) for k, v in inputs.items()}
    missing = [k for k in plan.input_names if k not in base]
    assert not missing, f"missing inputs: {missing}"
    params = collect_params(plan, device)
    cuda = device.type == "cuda"

    def timed(op, env):
        if not cuda:
            t0 = now()
            out = run_op(op, env, params)
            return out, now() - t0
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_op(op, env, params)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) * 1e-3

    def one_pass(record: dict | None) -> None:
        env = dict(base)
        with torch.inference_mode():
            for op in plan.ops:
                env[op.name], dt = timed(op, env)
                if record is not None \
                        and dt < record.get(op.name, float("inf")):
                    record[op.name] = dt

    with span("profile", cat="profile", plan=plan.name, repeats=repeats,
              ops=len(plan.ops), device=str(device)):
        one_pass(None)
        best: dict[str, float] = {}
        for _ in range(repeats):
            one_pass(best)

    choices = plan.meta.get("kernel_choices", {})
    return {op.name: {"s": best[op.name], "kernel": op.kernel,
                      "kind": op.kind, "primitive": op.primitive,
                      "predicted_s": (choices.get(op.name, {}).get(
                          "predicted_s") or {}).get(op.kernel)}
            for op in plan.ops}


def _measure_candidates(plan, names, *, repeats: int, backend: str) -> dict:
    """Standalone timings of every rival kernel for the named
    multi-candidate ops (the same measurement ``kernels="measured"`` runs,
    through a throwaway in-memory cache that is never written to disk)."""
    from repro_torch.core.autotune import AutotuneCache, measure_op

    cache = AutotuneCache(path=".obs_profile_scratch.does_not_exist")
    choices = plan.meta.get("kernel_choices", {})
    measured = {}
    by_name = {op.name: op for op in plan.ops}
    for name in names:
        timings = measure_op(by_name[name], choices[name]["candidates"],
                             cache, backend=backend, repeats=repeats)
        if timings:
            measured[name] = timings
    return measured


def profile_report(plan, inputs=None, *, repeats: int = 3, device=None,
                   measure_candidates: bool = True) -> dict:
    """Predicted-vs-measured report over one plan: one row per op (bound
    kernel, decision source, prediction, in-plan measured seconds, the
    rivals' standalone timings and whether the predicted argmin agrees
    with the measured argmin over the family), plus the aggregate
    ``agreement`` block ``{"agree", "considered", "rate"}`` — ``rate`` is
    None when no op has two measurable candidates.  ``render_report``
    turns the dict into the table."""
    from repro_torch.core.executor import resolve_device
    device = resolve_device(device)
    profiled = profile_plan(plan, inputs, repeats=repeats, device=device)
    choices = plan.meta.get("kernel_choices", {})
    multi = [n for n, c in choices.items() if len(c["candidates"]) > 1]
    rivals = _measure_candidates(plan, multi, repeats=repeats,
                                 backend=device.type) \
        if measure_candidates and multi else {}

    rows, agree, considered = [], 0, 0
    for name, p in profiled.items():
        choice = choices.get(name, {})
        row = {"op": name, "kind": p["kind"], "kernel": p["kernel"],
               "source": choice.get("source"),
               "predicted_s": p["predicted_s"], "measured_s": p["s"],
               "candidates_s": rivals.get(name),
               "candidates_predicted_s": choice.get("predicted_s"),
               "agree": None}
        meas = rivals.get(name)
        pred = choice.get("predicted_s") or {}
        if meas and len(meas) > 1 and all(k in pred for k in meas):
            considered += 1
            row["agree"] = (min(meas, key=meas.get)
                            == min({k: pred[k] for k in meas},
                                   key=lambda k: pred[k]))
            agree += row["agree"]
        rows.append(row)
    report = {
        "plan": plan.name,
        "kernels_mode": plan.meta.get("kernels_mode"),
        "backend": device.type,
        "repeats": repeats,
        "rows": rows,
        "agreement": {"agree": agree, "considered": considered,
                      "rate": agree / considered if considered else None},
    }
    report["text"] = render_report(report)
    return report


def _us(v) -> str:
    return f"{v * 1e6:10.2f}" if v is not None else " " * 9 + "-"


def render_report(report: dict) -> str:
    """The human-readable predicted-vs-measured table."""
    head = (f"per-op profile for {report['plan']!r} "
            f"(mode={report['kernels_mode']}, backend={report['backend']}, "
            f"best of {report['repeats']}):")
    lines = [head,
             f"  {'op':<28} {'kernel':<18} {'predicted_us':>12} "
             f"{'measured_us':>12}  agree"]
    for r in report["rows"]:
        mark = {True: "yes", False: "NO", None: "-"}[r["agree"]]
        lines.append(f"  {r['op']:<28} {str(r['kernel']):<18} "
                     f"{_us(r['predicted_s']):>12} "
                     f"{_us(r['measured_s']):>12}  {mark}")
    ag = report["agreement"]
    rate = "n/a (no op with two measurable candidates)" \
        if ag["rate"] is None \
        else f"{ag['rate']:.0%} ({ag['agree']}/{ag['considered']})"
    lines.append(f"  cost-model agreement: {rate}")
    return "\n".join(lines)
