"""The readings a cell's limit of ``correct`` is set from, on the card, in
one process: for each seed, the program's reading (a full run of the cell
with a short window, every answer held to the reference) and the
control's (the reference in TF32 in the program's place, over the same
request pool).  One JSON line per seed.

    python3 bench/control.py --workload b2-closed --seeds 1,2,3 \
        --seconds 3

``--seconds 0`` reads the control alone.  The limit goes above the
largest program reading and below the smallest control reading
(PERF.md gives both and the limit).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from gcvbench import harness, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.runtime.cache import clear_caches
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"seed": seed,
                "control": harness.control(cell, seed)}
        if args.seconds > 0:
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   t_start=time.perf_counter())
            line.update(program=out["checks"], correct=out["correct"],
                        attempted=out["attempted"], failed=out["failed"])
            clear_caches()
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
