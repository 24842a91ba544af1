"""Hold two builds of the flash kernels, forward and backward, to the same
bits.

    PYTHONPATH=<tree>/src python3 tools/flash_bits.py save OUT.pt
    python3 tools/flash_bits.py compare A.pt B.pt

``save`` runs the ``repro_torch.kernels.flash_attention`` found on
``PYTHONPATH`` on one CUDA card (its kernels build from that tree's
``csrc``) at qwen3-0.6b's shapes (16 query and 8 kv heads of 128: the
served buckets 16, 32 and 48 and a 2048-token prompt) and zamba2-2.7b's
(32 heads of 80 under the 128 instantiation: the exact prompt lengths 8,
29 and 47 and 2048 tokens), with a continuation (Sq < Sk), rows with no
live key (Sq > Sk) and a non-causal case at each head dim, and llama3.2-1b's
training shape (8 x 32/8 heads of 64 x 128 tokens, the 64 instantiation),
in bf16 and fp32, on inputs from numpy seed 0, and writes every output:
the forward's, and dq, dk and dv of ``flash_attention_bwd`` on the
training forward's out and LSE and a random dout.  ``compare``
counts the elements that differ between two saves, case by case, and
exits 1 if any does.  Saving once from each of two trees (say a parent
commit's ``git archive`` and this one) and comparing shows whether a
change to the kernel left these instantiations' results as they were.
Imports torch and numpy only.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

# (B, Hq, Hkv, Sq, Sk, D, causal)
CASES = ([(1, 16, 8, s, s, 128, True) for s in (16, 32, 48, 2048)]
         + [(1, 16, 8, 64, 256, 128, True), (1, 16, 8, 80, 48, 128, True),
            (2, 16, 8, 77, 77, 128, False)]
         + [(1, 32, 32, s, s, 80, True) for s in (8, 29, 47, 2048)]
         + [(1, 32, 32, 64, 256, 80, True), (1, 32, 32, 80, 48, 80, True),
            (2, 32, 32, 77, 77, 80, False)]
         + [(8, 32, 8, 128, 128, 64, True)])
DTYPES = (torch.bfloat16, torch.float32)


def key(case, dtype) -> str:
    return f"{str(dtype).split('.')[-1]} {case}"


def save(path: str) -> None:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bits: no CUDA device")
    rng = np.random.default_rng(0)
    out = {}
    for case in CASES:
        b, hq, hkv, sq, sk, d, causal = case
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((b, hq, sq, d), (b, hkv, sk, d),
                            (b, hkv, sk, d), (b, hq, sq, d))]
        for dtype in DTYPES:
            q, k, v, dout = (torch.from_numpy(a).to("cuda", dtype)
                             for a in arrays)
            out[key(case, dtype)] = flash_attention(
                q, k, v, causal=causal).cpu()
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         return_lse=True)
            grads = flash_attention_bwd(q, k, v, o, lse, dout, causal=causal)
            for name, g in zip(("dq", "dk", "dv"), grads):
                out[f"{key(case, dtype)} {name}"] = g.cpu()
    torch.cuda.synchronize()
    torch.save(out, path)
    print(f"flash_bits: saved {len(out)} outputs to {path} "
          f"({torch.cuda.get_device_name(0)})")


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    assert a.keys() == b.keys(), "the saves hold different cases"
    bad = 0
    for name in a:
        differ = int((a[name] != b[name]).sum())
        bad += differ > 0
        print(f"flash_bits {name}: {differ} of {a[name].numel()} elements "
              f"differ" + ("  FAIL" if differ else ""))
    print(f"flash_bits: {len(a) - bad}/{len(a)} cases bit for bit")
    return int(bad > 0)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "save":
        save(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
