"""zamba2-2.7b's bf16 stream margins for three engines, on one card.

    python3 tools/stream_margins.py [--seeds=N]

zamba2-2.7b at its published config in bf16, with the weights of
``chip_smoke.py``'s recurrent phase (``init_lm(0, ...)``): the
margin-aware stream check ``chip_smoke.token_margins`` (each engine
token's logit under one plain ``lm_forward`` against that position's
maximum, over max|logits|) for three engines: the kernel (the engine's
default attention), SDPA in the kernel's place, and the plain core
(``impl="naive"``, no kernel).  On the launcher's prompts at seeds 0 to
N-1 (default 4; seed 0 is the set ``chip_smoke.py`` asserts), then at
seed 0 with the product this repo had before ``layers.dot`` kept the fp32
result (``torch.matmul`` rounded to bf16, then widened) in every model
module (``dot_cost.rounded_dot``).  Prints the card's name and power limit, then one JSON line per
prompt set.  Imports torch and the port only.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import types

import torch

from dot_cost import rounded_dot

ROOT = pathlib.Path(__file__).resolve().parent.parent


def stream_gaps(cs, cfg, params, seed: int) -> dict:
    """The three engines' stream checks on the prompts of ``seed``."""
    out = {}
    for name, impl in (("kernel", "chunked"), ("library", "library"),
                       ("plain", "naive")):
        with cs.AttentionProbe():
            outs = cs.engine_tokens(cfg, params, impl, seed)
        gap, agree, total = cs.token_margins(cfg, params, [
            types.SimpleNamespace(prompt=p, out=o)
            for p, o in zip(cs.rec_prompts(cfg, seed), outs)])
        out[name] = {"gap": gap, "on_argmax": agree, "tokens": total}
    return out


def zamba2(cs, seeds: int) -> None:
    from repro_torch import configs
    from repro_torch.models.transformer import init_lm  # (all modules)
    cfg = configs.get("zamba2-2.7b")
    params = init_lm(0, cfg, device="cuda")
    for seed in range(seeds):
        print(json.dumps({"zamba2_streams": stream_gaps(cs, cfg, params,
                                                        seed),
                          "seed": seed, "dot": "fp32 result",
                          "margin_rtol": cs.MARGIN_RTOL}), flush=True)
    rounded_dot()               # the last set: the port's dot stays swapped
    print(json.dumps({"zamba2_streams": stream_gaps(cs, cfg, params, 0),
                      "seed": 0, "dot": "rounded to bf16",
                      "margin_rtol": cs.MARGIN_RTOL}), flush=True)


def main(argv) -> int:
    seeds = 4
    for a in argv:
        if a.startswith("--seeds="):
            seeds = int(a.split("=", 1)[1])
        else:
            print(__doc__, file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    zamba2(cs, seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
