"""One run of one cell: set up, measure for ``--seconds``, check every
answer against the plain reference, print the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the process's start to the window's first
request): the weights and a pool of requests drawn from the seed on the
card, ``gcv.serve`` over the configuration's model function (which calls
``gcv.compile(fn, example)`` per model: ``compile_s``), the engine's
``warmup()`` (every bucket's CUDA graph captured: ``capture_s``), then
every bucket once through the real ``submit`` / ``dispatch`` /
``harvest`` path as deep as the engine may pipeline, so that no slot is
allocated and nothing is built inside the window.

After the window: every answer (for at most a minute past the close),
the device's memory peak, the engine freed, then the reference over the
pool entries the window used, in blocks, and each window request's answer
held to its entry's reference (``compare``).  The process then looks for
JAX and the JAX package among its modules and refuses to print a result
if it finds them.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np

from gcvbench import compare, devtrace, peaks, record, spec, window
from gcvbench import traffic as gen

clock = time.perf_counter
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``BANNED``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED)


def _counters(eng) -> dict:
    """The engine's counters, and each histogram's count, by name."""
    out = {}
    for name, v in eng.metrics.snapshot().items():
        out[name] = v["count"] if isinstance(v, dict) else v
    return out


def _warm_traffic(eng, task, pool) -> None:
    """Every bucket once through ``submit`` / ``dispatch`` / ``harvest``,
    with as many batches in flight as the engine may keep, so each bucket
    has every staging slot it can need."""
    depth = max(eng.max_pipeline_depth, eng.pipeline_depth)
    for bucket in eng.buckets():
        for rep in range(depth):
            for j in range(bucket):
                eng.submit(task, **pool[(rep * bucket + j) % len(pool)])
            eng.dispatch()
        while eng.inflight():
            eng.harvest()
    while eng.pending() or eng.inflight():
        eng.poll(draining=True)


@dataclasses.dataclass
class Served:
    """A cell's program up and warm, with what the run drew for it."""
    eng: object
    task: str
    pool: list                    # the requests, numpy arrays
    weights: dict                 # the weight leaves, host tensors
    device: object                # the engine's (first) torch device
    compile_s: float
    capture_s: float


def start(cell: spec.Cell, seed: int, device_type: str = "cuda",
          traffic: dict | None = None) -> Served:
    """Draw the weights and the request pool from ``seed``, build the
    engine over the configuration's model function, capture and warm it
    (module docstring)."""
    import torch
    from repro_torch import gcv
    cfg, chips = cell.config, cell.chips
    trf = cell.traffic if traffic is None else traffic
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    task = cell.config_name
    w_dev = cell.model.make_weights(cfg, seed, dev)
    w_host = {k: v.to("cpu") for k, v in w_dev.items()}
    del w_dev
    pool = cell.model.make_requests(cfg, seed, int(trf["pool"]), dev,
                                    w_host)
    fn, example = cell.model.make_model(cfg, w_host)
    models = {task: (fn, example())}
    extra = {}
    if chips > 1:
        extra["devices"] = ([dev] * chips if device_type == "cpu"
                            else chips)
    else:
        extra["device"] = dev
    t_a = clock()
    eng = gcv.serve(models, **gen.engine_kwargs(trf, chips), **extra)
    compile_s = clock() - t_a
    t_a = clock()
    eng.warmup()
    capture_s = clock() - t_a
    _warm_traffic(eng, task, pool)
    if device_type == "cuda":
        for d in range(chips):
            torch.cuda.synchronize(d)
    return Served(eng, task, pool, w_host, dev, compile_s, capture_s)


def measure(served: Served, cell: spec.Cell, traffic: dict, seed: int,
            seconds: float, tracer):
    """One window of ``traffic`` -> ``(Window, counters as it opened,
    counters as it closed)``."""
    eng, task, pool = served.eng, served.task, served.pool
    marks = {}

    def at_open():
        marks["open"] = _counters(eng)

    def at_close():
        marks["close"] = _counters(eng)
    if traffic["loop"] == "open":
        win = window.run_open(eng, task, pool, traffic, seed, seconds,
                              tracer, at_open, at_close)
    elif traffic["loop"] == "closed":
        win = window.run_closed(eng, task, pool, traffic, seed, seconds,
                                tracer, cell.chips, at_open, at_close)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    return win, marks["open"], marks["close"]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device_type: str = "cuda",
             plant=None) -> dict:
    """Run the cell once and return the result line's object (with the
    compared numbers under ``checks``).  ``device_type="cpu"`` and
    ``plant`` (a function given the engine, to break its timed path) are
    for the CPU tests: the command line refuses to run without a card."""
    import torch
    cfg, chips = cell.config, cell.chips
    served = start(cell, seed, device_type)
    if plant is not None:
        plant(served.eng)
    tracer = devtrace.DeviceTracer() if trace else devtrace.NullTracer()
    # what set-up left alive (modules, traced graphs, plans) is moved out of
    # the collector's reach, so that a full collection inside the window
    # walks only the window's own objects (a long-running server does the
    # same after its start)
    gc.collect()
    gc.freeze()
    win, counters0, counters1 = measure(served, cell, cell.traffic, seed,
                                        seconds, tracer)
    setup_s = win.t0 - t_start
    tracer.close()
    gc.unfreeze()
    if device_type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(chips))
        device = peaks.device_info(torch, chips, peak)
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": chips,
                  "memory_peak_bytes": 0}
    pool, w_host, dev = served.pool, served.weights, served.device
    compile_s, capture_s = served.compile_s, served.capture_s
    del served
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()

    # --- the reference, and every window answer held to it ---------------
    used = sorted(set(win.pool_idx))
    w_ref = {k: v.to(dev) for k, v in w_host.items()}
    want = dict(zip(used, cell.reference.forward(
        cfg, w_ref, [pool[k] for k in used], device=dev)))
    checks, ok = compare.hold(cell.reference, [r.result for r in win.reqs],
                              [want[k] for k in win.pool_idx])
    flops = np.zeros(len(pool))
    io_bytes = np.zeros(len(pool))
    out_bytes = sum(np.asarray(a).nbytes for a in want[used[0]])
    for k in used:
        flops[k] = cell.reference.flops(cfg, w_ref, pool[k])
        io_bytes[k] = sum(np.asarray(v).nbytes
                          for v in pool[k].values()) + out_bytes
    weight_bytes = sum(v.numel() * v.element_size()
                       for k, v in w_host.items() if k not in pool[0])
    del w_ref
    run = record.Run(cell, seed, seconds, trace, chips, setup_s, compile_s,
                     capture_s, win, counters0, counters1,
                     tracer.result, flops, io_bytes, weight_bytes, ok)

    # --- the result ------------------------------------------------------
    metrics = {}
    for m in cell.reported(trace):
        v = m.reader.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    attempted = len(win.reqs)
    failed = int(attempted - ok.sum())
    correct = bool(win.drained and failed == 0
                   and all(c["value"] <= c["limit"]
                           for c in checks.values()))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if trace and run.device is not None:
        out["device"]["busy_s"] = run.device.busy_s()
        out["device"]["window_s"] = run.device.window_s()
        out["breakdown"] = {
            "device_ops": run.device.device_ops(),
            "idle_gaps": run.device.idle_gaps(win.spans)}
    out["checks"] = checks
    late = (np.asarray(win.t_submit) - np.asarray(win.t_due)) * 1e3
    out["_lateness_ms"] = {"p50": record.percentile(late, 50),
                           "p99": record.percentile(late, 99),
                           "max": float(late.max()) if late.size else 0.0}
    done = np.asarray(win.t_done, float) - win.t0
    bins = max(1, int(round(seconds)))
    out["_per_second"] = np.histogram(
        done[np.isfinite(done)], bins=bins, range=(0.0, seconds))[0].tolist()
    lat = run.latencies_ms()
    sec = np.minimum(((np.asarray(win.t_due) - win.t0) * bins / seconds)
                     .astype(int), bins - 1)
    out["_p95_per_second"] = [round(record.percentile(lat[sec == b], 95), 3)
                              for b in range(bins) if np.any(sec == b)]
    return out


def control(cell: spec.Cell, seed: int, device_type: str = "cuda") -> dict:
    """The control of ``correct``: the reference in TF32 put in the
    program's place over the whole request pool of ``seed``, held to the
    fp32 reference -> ``{name: {"value", "limit"}}``.  Its value has to
    come out above the limit."""
    import torch
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    cfg, trf = cell.config, cell.traffic
    w = cell.model.make_weights(cfg, seed, dev)
    w_host = {k: v.to("cpu") for k, v in w.items()}
    pool = cell.model.make_requests(cfg, seed, int(trf["pool"]), dev, w_host)
    want = cell.reference.forward(cfg, w, pool, device=dev)
    got = cell.reference.forward(cfg, w, pool, device=dev, tf32=True)
    return compare.hold(cell.reference, got, want)[0]


def main(argv=None, t_start: float | None = None) -> int:
    t_start = clock() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"gcvbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {have}: no result", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    found = banned_modules()
    if found:
        print(f"gcvbench: modules of JAX or the JAX package are loaded: "
              f"{found}; no result", file=sys.stderr)
        return 3
    late = out.pop("_lateness_ms")
    print(f"answers a second of the window: {out.pop('_per_second')}",
          file=sys.stderr)
    print(f"p95 latency ms by second due: {out.pop('_p95_per_second')}",
          file=sys.stderr)
    print(f"generator lateness ms: p50 {late['p50']} p99 {late['p99']} "
          f"max {late['max']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
