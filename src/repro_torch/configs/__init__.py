"""Architecture registry of the port's LM slice.

Port of ``src/repro/configs/__init__.py``.  ``get(name)`` returns the full
published config, ``get_smoke(name)`` a reduced same-family config for CPU
tests.  The port serves the dense GQA archs, the recurrent family
(zamba2's Mamba2 backbone with its shared GQA blocks, xLSTM's mLSTM and
sLSTM blocks) and the mixtures of experts (deepseek-v3's MLA + MoE,
grok-1's GQA + MoE): ``PORTED``.  Every other arch of the reference's
``ARCHS`` (outside embeddings, sinusoidal positions, and the two dense
archs that need only their config) raises ``NotImplementedError`` until
ROADMAP queue 1 item 10 ports it.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "zamba2-2.7b", "deepseek-v3-671b", "grok-1-314b", "qwen2-72b",
    "codeqwen1.5-7b", "llama3.2-1b", "qwen3-0.6b", "musicgen-medium",
    "xlstm-350m", "chameleon-34b",
]
PORTED = ("qwen3-0.6b", "llama3.2-1b", "zamba2-2.7b", "xlstm-350m",
          "deepseek-v3-671b", "grok-1-314b")


def _module(name: str):
    if name not in PORTED:
        if name in ARCHS:
            raise NotImplementedError(
                f"{name}: not ported yet (ROADMAP queue 1 item 10: outside "
                f"embeddings, sinusoidal positions and the config-only "
                f"dense archs); the port serves "
                f"{', '.join(PORTED)}")
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke()
