"""Perf probe: run one dry-run cell and rank its byte contributors — the
dry-run profiler for the perf iterations.

Port of ``src/repro/launch/perf_probe.py``.  The reference compiles the
cell, captures its HLO and ranks each op line by its result and operand
bytes, weighted by the trip counts of the loops around it.  The port has
no HLO: its step runs eager, one kernel an op (``launch/step_analysis``),
so the rows are ``StepCounter.rows``, the HBM bytes of every ``(op name,
operand shapes)`` over the whole step, each with its number of calls in
place of the trip weight; the rows sum to the cell's ``bytes/dev``.
With no HLO there is nothing to dump, so the reference's ``--hlo-out``
has no counterpart.

Usage: python -m repro_torch.launch.perf_probe --arch llama3.2-1b \
    --shape decode_32k [--multi-pod] [--top 25]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.step_analysis import StepCounter


def probe(arch: str, shape: str, *, top: int = 25, **cell):
    """One dry-run cell (``dryrun.lower_cell(arch, shape, **cell)``): its
    record and the ``top`` rows of ``StepCounter.top_rows``, ``(bytes,
    calls, op name, operand shapes)`` most bytes first."""
    sc = StepCounter()
    res = lower_cell(arch, shape, counter=sc, **cell)
    return res, sc.top_rows(top)


def report(res: dict, rows: list) -> str:
    """The reference's printout: the cell's totals a device, then one
    row a contributor (bytes, calls, op; its operand shapes below)."""
    lines = [f"flops/dev {res['flops_per_device']:.3e}  "
             f"bytes/dev {res['bytes_per_device']:.3e}  "
             f"coll/dev {res['collective_bytes_per_device']['total']:.3e}",
             "---- top byte contributors (call-weighted) ----"]
    for nbytes, calls, op, shapes in rows:
        lines.append(f"{nbytes:9.3e}  n={calls:6d} {op}\n    "
                     f"{', '.join(map(str, shapes))}"[:200])
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    res, rows = probe(args.arch, args.shape, top=args.top,
                      multi_pod=args.multi_pod)
    if res["status"] != "ok":
        print(f"{args.arch} {args.shape}: {res['status']} "
              f"({res.get('reason', '')})")
        return 1
    print(report(res, rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
