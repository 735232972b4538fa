"""The card: its published peaks, what it says of itself, and the guard
that keeps JAX and the JAX package out of a measured process."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "canonicalvoting_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def smi() -> Dict[str, str]:
    """The card's name, SM clock, power draw and power limit by
    ``nvidia-smi``, or what went wrong."""
    q = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    return {"gpus": out.splitlines()}


def device_info(torch, count: int) -> Dict[str, object]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
