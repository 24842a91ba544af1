"""Architecture registry of the port's LM slice.

Port of ``src/repro/configs/__init__.py``.  ``get(name)`` returns the full
published config, ``get_smoke(name)`` a reduced same-family config for CPU
tests.  The port runs all ten of the reference's ``ARCHS`` (``PORTED``,
kept as the name callers use): the dense GQA archs (qwen2 and codeqwen
with their qkv biases, chameleon and musicgen fed embeddings from
outside, musicgen with sinusoidal positions), the recurrent family
(zamba2's Mamba2 backbone with its shared GQA blocks, xLSTM's mLSTM and
sLSTM blocks) and the mixtures of experts (deepseek-v3's MLA + MoE,
grok-1's GQA + MoE).

Input-shape cells (``SHAPES``, the reference's): train_4k, prefill_32k,
decode_32k, long_500k; ``long_500k`` is defined only for sub-quadratic
archs (``cfg.subquadratic``).  ``cells()`` lists the (arch, shape) pairs
the dry run (``launch/dryrun.py``) takes.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "zamba2-2.7b", "deepseek-v3-671b", "grok-1-314b", "qwen2-72b",
    "codeqwen1.5-7b", "llama3.2-1b", "qwen3-0.6b", "musicgen-medium",
    "xlstm-350m", "chameleon-34b",
]
PORTED = ARCHS

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()


def cells(include_na: bool = False):
    """All (arch, shape) cells.  long_500k only for sub-quadratic archs
    unless include_na."""
    out = []
    for a in ARCHS:
        cfg = get(a)
        for s in SHAPES:
            if s == "long_500k" and not cfg.subquadratic and not include_na:
                continue
            out.append((a, s))
    return out
