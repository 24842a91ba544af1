"""Time the LM paths that the bf16 products' fp32 results touch, on one card.

    PYTHONPATH=<tree>/src python3 tools/dot_cost.py LABEL [--rounded-dot]

Runs the ``repro_torch`` found on ``PYTHONPATH`` (its kernels build from
that tree's ``csrc``): qwen3-0.6b served ``ROUNDS`` times through
``launch.serve.serve`` at the launcher's defaults and the published config
(16 requests, 32 new tokens each, 8 slots), and llama3.2-1b trained
``STEPS`` steps through ``launch.train.train`` at the published config
(batch 8 x 128).  Prints one JSON line: the median served tok/s (and each
round's), the train step p50/p25/p75 after ``WARM`` steps on the
launcher's clock, the label, and the card's name and power limit.  Run it
from two trees in turns (parent, change, change, parent) in one call to
compare them on one card.  ``--rounded-dot`` swaps the port's
``models.layers.dot`` for the product it replaced, ``torch.matmul``
rounded to the operands' dtype and then widened, in every model module:
the same tree with and without the fp32-out product.  Imports torch and
the port only.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

ROUNDS, STEPS, WARM = 3, 23, 3


def rounded_dot() -> None:
    """Every model module's ``dot`` -> ``wide(torch.matmul(x, w))``."""
    from repro_torch.models import layers
    fp32_out = layers.dot

    def dot(x, w):
        return layers.wide(torch.matmul(x, w))

    for name, module in list(sys.modules.items()):
        if name.startswith("repro_torch.models") and \
                getattr(module, "dot", None) is fp32_out:
            module.dot = dot


def main(argv) -> int:
    flags = [a for a in argv if a.startswith("--")]
    argv = [a for a in argv if not a.startswith("--")]
    if len(argv) != 1 or set(flags) - {"--rounded-dot"} \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    if flags:
        import repro_torch.models.transformer  # noqa: F401  (all modules)
        rounded_dot()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    tok = [serve("qwen3-0.6b", smoke=False, device="cuda")["tok_per_s"]
           for _ in range(ROUNDS)]
    torch.cuda.empty_cache()
    steps = train("llama3.2-1b", smoke=False, steps=STEPS, log_every=1000,
                  device="cuda")["step_ms"][WARM:]
    q1, p50, q3 = statistics.quantiles(steps, n=4)
    print(json.dumps({"label": argv[0], "rounded_dot": bool(flags),
                      "card": card,
                      "qwen3_tok_per_s": statistics.median(tok),
                      "qwen3_rounds": tok, "llama_step_p50_ms": p50,
                      "llama_step_p25_ms": q1, "llama_step_p75_ms": q3}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
