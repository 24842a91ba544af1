"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the card's identity.

Every share of a peak that this benchmark reports is taken against these
numbers, and every result line carries the card's name, count and power
limit beside it (``device_info``): a card set below 700 W runs slower under
load, so a share read on it is not comparable with one read at 700 W.

The configurations are fp32.  The port runs their products as 3xTF32 on the
tensor cores (fp32-level results), whose ceiling is ``TF32_FLOPS / 3``; the
shares are taken against ``TF32_FLOPS`` itself, the fastest route that keeps
fp32 inputs on the tensor cores, so no later kernel on any route can pass
100%.  Single-pass TF32 is faster still but is a lower precision, which the
comparison with the reference refuses.
"""
from __future__ import annotations

import shutil
import subprocess

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores, dense
TF32_FLOPS = 495e12          # TF32 tensor cores, dense
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3
HBM_BYTES = 80e9

# The peak a roofline or an mfu share of an fp32 configuration is taken
# against (module docstring).
FP32_MODEL_PEAK = TF32_FLOPS


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` operations that
    must move ``nbytes`` through HBM: the larger of the two bounds."""
    return max(flops / FP32_MODEL_PEAK, nbytes / HBM_BYTES_PER_S)


def power_limits() -> list[str] | None:
    """Each card's power limit as ``nvidia-smi`` reads it (``"700.00 W"``),
    or None where ``nvidia-smi`` is not there or fails."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def device_info(torch, chips: int, memory_peak_bytes: int) -> dict:
    """The result line's ``device`` object.  Only called on the card: a
    measurement path that finds no card has already failed."""
    limits = power_limits()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit": (limits[:chips] if limits else None)}
