"""Find an open-loop cell's knee once, by a sweep of offered rates on the
card.  First the cell's batch service time: ``--batches`` full batches
through ``submit`` / ``dispatch`` / ``harvest`` one at a time; the
deadline is four times their median, rounded up to a whole ms.  Then, for
each rate in turn, the cell is set up afresh (a cold engine, as every run
of the cell starts) at that deadline and measured for ``--seconds``.
Prints one JSON line for the service time and one per rate, and stops
after two rates in a row that are not sustained.

    python3 bench/sweep_open.py --workload b2-open --seed 7 --seconds 5 \
        --rates 100,120,140,160

A rate is sustained where the window's answers keep up with its arrivals
(``completed_rps`` within 2% of ``offered_rps``) and the latency of the
window's second half is not above its first half's by more than half
(no growing backlog).  The cell's rate is then fixed at about four fifths
of the highest sustained one, and its deadline at the one printed here.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402

from gcvbench import devtrace, harness, record, spec  # noqa: E402


def service_ms(served, batches: int) -> list[float]:
    """Host milliseconds of each of ``batches`` full batches, each
    submitted, dispatched and harvested before the next."""
    eng, task, pool = served.eng, served.task, served.pool
    full = max(eng.buckets())
    out = []
    for b in range(batches):
        for j in range(full):
            eng.submit(task, **pool[(b * full + j) % len(pool)])
        t_a = time.perf_counter()
        eng.dispatch()
        while eng.inflight():
            eng.harvest()
        out.append((time.perf_counter() - t_a) * 1e3)
    return out


def window_line(win, c0, c1, seconds: float) -> dict:
    done = np.asarray(win.t_done, float)
    due = np.asarray(win.t_due)
    lat = np.where(np.isnan(done), np.inf, (done - due) * 1e3)
    half = due < win.t0 + seconds / 2
    inside = (done >= win.t0) & (done <= win.t_end)
    late = (np.asarray(win.t_submit) - due) * 1e3
    batches = c1.get("dispatches", 0) - c0.get("dispatches", 0)
    answered = c1.get("completed", 0) - c0.get("completed", 0)
    line = {
        "offered_rps": len(due) / seconds,
        "completed_rps": float(inside.sum()) / seconds,
        "p50_ms": record.percentile(lat, 50),
        "p95_ms": record.percentile(lat, 95),
        "p95_first_half_ms": record.percentile(lat[half], 95),
        "p95_second_half_ms": record.percentile(lat[~half], 95),
        "lateness_p99_ms": record.percentile(late, 99),
        "mean_batch": answered / batches if batches else None,
        "backlog_at_close": int(np.sum(~(done <= win.t_end))),
    }
    line["sustained"] = bool(
        line["completed_rps"] >= 0.98 * line["offered_rps"]
        and line["p95_second_half_ms"] <= 1.5 * line["p95_first_half_ms"])
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--batches", type=int, default=40)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_open: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.runtime.cache import clear_caches
    cell = spec.load_cell(args.workload)
    served = harness.start(cell, args.seed)
    times = service_ms(served, args.batches)
    p50 = float(np.median(times))
    deadline = float(math.ceil(4 * p50))
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "compile_s": served.compile_s,
                      "capture_s": served.capture_s,
                      "batch": max(served.eng.buckets()),
                      "service_p50_ms": p50,
                      "service_ms": times,
                      "deadline_ms": deadline}), flush=True)
    failed = 0
    for rate in (float(r) for r in args.rates.split(",")):
        del served
        gc.collect()
        clear_caches()
        torch.cuda.empty_cache()
        trf = dict(cell.traffic, rate_per_s=rate, deadline_ms=deadline)
        served = harness.start(cell, args.seed, traffic=trf)
        win, c0, c1 = harness.measure(served, cell, trf, args.seed,
                                      args.seconds, devtrace.NullTracer())
        line = window_line(win, c0, c1, args.seconds)
        print(json.dumps(line), flush=True)
        failed = 0 if line["sustained"] else failed + 1
        if failed == 2:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
