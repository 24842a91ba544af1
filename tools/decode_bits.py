"""Hold two trees' LM prefill and decode steps without a mesh to the same
bits.

    PYTHONPATH=<tree>/src python3 tools/decode_bits.py save OUT.pt
    python3 tools/decode_bits.py compare A.pt B.pt

``save`` runs the ``repro_torch`` found on ``PYTHONPATH`` on the CPU: for
the smoke configs of llama3.2-1b (GQA), deepseek-v3 (MLA and experts),
zamba2-2.7b (Mamba2 and the shared blocks), qwen3-0.6b and
musicgen-medium (from embeddings), a 6-token prefill of 3 rows into
16-position caches (``impl="naive"``), then 12 decode steps from per-row
lengths 6, 3 and 9 (the first and last rows run past the caches' end,
whose writes are dropped), and writes every step's logits and the caches
after the last.  ``compare`` names the archs whose saves differ in any
bit and exits 1 if one does.  Saving from a parent commit's ``git
archive`` and from this tree shows whether a change left the one-device
path as it was.  Imports torch only.
"""
from __future__ import annotations

import sys

import torch

ARCHS = ("llama3.2-1b", "deepseek-v3-671b", "zamba2-2.7b", "qwen3-0.6b",
         "musicgen-medium")


def save(path: str) -> None:
    from repro_torch import configs
    from repro_torch.models.transformer import (init_lm, lm_decode_step,
                                                lm_prefill)
    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        params = init_lm(0, cfg, device="cpu")
        toks = torch.arange(3) * 5 % cfg.vocab
        with torch.no_grad():
            if cfg.embed_inputs:
                prompt = {"tokens": torch.arange(18).reshape(3, 6)
                          % cfg.vocab}
            else:
                prompt = {"embeds": torch.randn(
                    3, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))}
            lg, caches, _ = lm_prefill(params, cfg, **prompt, max_len=16,
                                       impl="naive")
            logits = [lg]
            for i in range(12):
                lg, caches = lm_decode_step(params, cfg, toks, caches,
                                            torch.tensor([6, 3, 9]) + i)
                logits.append(lg)
                toks = lg.argmax(-1)
        out[arch] = {"logits": logits, "caches": caches}
    torch.save(out, path)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    return torch.equal(a, b)


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    apart = [arch for arch in a if not _same(a[arch], b.get(arch))]
    print(f"{len(a) - len(apart)} of {len(a)} archs bit for bit"
          + (f"; apart: {apart}" if apart else ""))
    return 1 if apart else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["save"]:
        save(sys.argv[2])
    elif sys.argv[1:2] == ["compare"]:
        raise SystemExit(compare(sys.argv[2], sys.argv[3]))
    else:
        raise SystemExit(__doc__)
