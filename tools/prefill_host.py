"""Host time of one qwen3-0.6b 2048-token prefill through the flash kernel.

    PYTHONPATH=<tree>/src python3 tools/prefill_host.py [LABEL]

Runs the ``repro_torch`` found on ``PYTHONPATH`` (its kernels build from
that tree's ``csrc``) on one CUDA card: qwen3-0.6b at its published size
in bf16, random weights from seed 0, one 2048-token prompt from numpy
seed 0, ``lm_prefill(impl="chunked")`` (28 flash launches); after 3 warm
prefills, PREFILLS prefills each timed on the host clock from the call to
its ``synchronize()``.  Prints the p50, p25 and p75 in ms, the flash
launches a prefill and the card's name and power limit.  Running it on
two trees in turns (parent, change, change, parent) in one call shows
what a change to the host path costs.  Imports torch and numpy only.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PREFILLS, WARM, LENGTH = 40, 3, 2048


def main(argv) -> int:
    from repro_torch import configs
    from repro_torch.kernels import flash_attention
    from repro_torch.models.transformer import init_lm, lm_prefill
    if not torch.cuda.is_available():
        raise SystemExit("prefill_host: no CUDA device")
    label = argv[0] if argv else ""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]
    cfg = configs.get("qwen3-0.6b")
    params = init_lm(0, cfg, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, LENGTH))).to("cuda")
    ms = []
    with torch.no_grad():
        for i in range(WARM + PREFILLS):
            if i == WARM:
                flash_attention.launches = 0
            t0 = time.perf_counter()
            lm_prefill(params, cfg, tokens, max_len=LENGTH, impl="chunked")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    q1, p50, q3 = statistics.quantiles(ms[WARM:], n=4)
    print(f"prefill_host {label}: qwen3-0.6b {LENGTH}-token prefill, host "
          f"p50 {p50:.4f} ms (p25 {q1:.4f}, p75 {q3:.4f}) over {PREFILLS}; "
          f"flash launches a prefill "
          f"{flash_attention.launches / PREFILLS:g}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
