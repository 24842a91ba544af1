"""Roofline analysis over dry-run records, at the H100's peaks.

Port of ``src/repro/launch/roofline.py``, whose hardware model is a TPU
v5e-class chip (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s a link).  Here it
is one ``NVIDIA H100 80GB HBM3`` at its full power limit (700 W), by the
data sheet (SXM part, dense rates):
    peak bf16     989 TFLOP/s a card
    HBM bandwidth 3.35 TB/s a card
    NVLink        450 GB/s a direction a card

Terms, per (arch, shape, mesh) cell (all per device, in seconds; the
records are ``launch/dryrun.py``'s, counted on the host):
    compute    = FLOPs / peak
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

MODEL_FLOPS = 6·N·D for training (N = active params for MoE, D =
tokens), 2·N·D for inference steps.  ``useful`` = MODEL_FLOPS / FLOPs
catches remat and redundancy waste; ``roofline_fraction`` =
ideal_compute_time / max(term) is the headline score (1.0 = the cell runs
at the roofline).  The formulas are the reference's; a card set below
700 W runs below these peaks.

Usage: python -m repro_torch.launch.roofline --in experiments/dryrun --md
       python -m repro_torch.launch.roofline --in experiments/dryrun --cells
"""
from __future__ import annotations

import argparse
import glob
import json
import os

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,          # one token per request
    "long_500k": 1,
}


def analyze(rec: dict) -> dict:
    n_dev = rec["devices"]
    flops = rec["flops_per_device"]
    nbytes = rec["bytes_per_device"]
    coll = rec["collective_bytes_per_device"].get("total", 0.0)
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    tokens = SHAPE_TOKENS[rec["shape"]]
    n_par = rec["active_params"]
    mult = 6.0 if rec["kind"] == "train" else 2.0
    model_flops = mult * n_par * tokens / n_dev      # per device
    useful = model_flops / flops if flops else 0.0
    ideal_s = model_flops / PEAK_FLOPS
    bound = max(terms.values())
    frac = ideal_s / bound if bound else 0.0
    return {
        **{k: rec[k] for k in ("arch", "shape", "kind", "mesh", "tag")},
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": useful,
        "roofline_fraction": frac,
        "note": _note(rec, terms, dominant, useful),
    }


def _note(rec, terms, dominant, useful):
    a = rec["arch"]
    if dominant == "collective":
        return (f"{a}: collective-bound — reshard to cut cross-device "
                "traffic (fold layouts into adjacent matmuls, paper §V-C4)")
    if dominant == "memory":
        if rec["kind"] == "decode":
            return (f"{a}: HBM-bound decode (cache sweep) — shrink "
                    "bytes/token: KV layout, quantized cache, or larger "
                    "batch per chip")
        return (f"{a}: memory-bound — fuse epilogues / raise arithmetic "
                "intensity per HBM byte")
    if useful < 0.5:
        return (f"{a}: compute-bound but only {useful:.0%} of FLOPs are "
                "model-useful — cut remat recompute or dense-MoE waste")
    return (f"{a}: compute-bound at {useful:.0%} useful FLOPs — near "
            "roofline; remaining lever is kernel efficiency")


def load(dir_: str, *, pod: str = "pod1", tag: str = ""):
    out = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            if rec.get("status") == "n/a":
                out.append({"arch": rec["arch"], "shape": rec["shape"],
                            "status": "n/a"})
            continue
        want_pod = (rec.get("multi_pod", False) == (pod == "pod2"))
        if not want_pod or rec.get("tag", "") != tag:
            continue
        out.append({"status": "ok", **analyze(rec)})
    return out


def to_markdown(rows):
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | useful | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.get("status") == "n/a":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | n/a |"
                         " — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def cells_markdown(dir_: str, *, pod: str = "pod1", tag: str = "") -> str:
    """Every record of ``dir_`` (failed ones with their error) as a table
    of what a device holds and moves beside the roofline: peak memory
    (arguments + the step's peak), FLOPs, HBM and collective bytes, the
    dominant term and ``roofline_fraction``."""
    lines = ["| arch | shape | status | peak GiB | FLOPs | HBM bytes | "
             "collective bytes | dominant | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("multi_pod", False) != (pod == "pod2") \
                or rec.get("tag", "") != tag:
            continue
        head = f"| {rec['arch']} | {rec['shape']} | {rec['status']} |"
        if rec["status"] != "ok":
            lines.append(head + " — | — | — | — | "
                         f"{rec.get('error', rec.get('reason', ''))[:80]} "
                         "| — |")
            continue
        r = analyze(rec)
        lines.append(
            f"{head} {rec['memory']['peak_bytes'] / 2**30:.2f} | "
            f"{rec['flops_per_device']:.3e} | "
            f"{rec['bytes_per_device']:.3e} | "
            f"{rec['collective_bytes_per_device']['total']:.3e} | "
            f"{r['dominant']} | {r['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="indir", default="experiments/dryrun")
    ap.add_argument("--pod", default="pod1")
    ap.add_argument("--tag", default="")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--cells", action="store_true",
                    help="the records' memory, FLOPs and bytes beside the "
                         "roofline (cells_markdown)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.cells:
        print(cells_markdown(args.indir, pod=args.pod, tag=args.tag))
        return
    rows = load(args.indir, pod=args.pod, tag=args.tag)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    print(to_markdown(rows) if args.md else json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
