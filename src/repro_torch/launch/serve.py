"""Serving launcher: batched requests through the ServeEngine.

Port of ``src/repro/launch/serve.py``.  Usage:

  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16
  python -m repro_torch.launch.serve --full          # published config

Weights are random, drawn from ``seed`` on the device; the prompts are the
reference's (numpy, from the same seed).  Runs on ``cuda`` unless
``device="cpu"`` (``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import configs
from repro_torch.models.transformer import init_lm
from repro_torch.serve import ServeEngine


def prompts(vocab: int, requests: int, prompt_len=(8, 48), seed: int = 0):
    """The reference launcher's prompts: per request a length in
    ``[prompt_len)``, then that many tokens, from one numpy generator."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(*prompt_len)))
            for _ in range(requests)]


def serve(arch: str, *, requests: int = 16, smoke: bool = True,
          slots: int = 8, max_len: int = 256, max_new: int = 32,
          prompt_len: tuple[int, int] = (8, 48), seed: int = 0,
          device: str = "cuda"):
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    params = init_lm(seed, cfg, device=device)
    eng = ServeEngine(cfg, params, slots=slots, max_len=max_len)
    batch = prompts(cfg.vocab, requests, prompt_len, seed)
    t0 = time.time()
    reqs = [eng.submit(p, max_new=max_new) for p in batch]
    steps = 0
    while any(not r.done for r in reqs):
        eng.step()
        steps += 1
        if steps > requests * max_new + 100:
            raise RuntimeError("serving did not converge")
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    return {"requests": requests, "decode_steps": steps,
            "tokens_generated": n_tok, "wall_s": dt,
            "tok_per_s": n_tok / dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = serve(args.arch, requests=args.requests, smoke=not args.full,
                slots=args.slots, max_len=args.max_len,
                max_new=args.max_new, device=args.device)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
