"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each
reader takes the traced run's record and returns its number, or None where
the run has nothing to read; a share of a peak or a roofline is never
written as 0 for a missing reading."""

from __future__ import annotations

from typing import Optional

from harness.device import PEAK_BF16_FLOPS

# the tiled conv kernels' occupied-row GEMMs (convs, downs, ups) ...
CONV_GEMMS = ("conv_rows_kernel", "up_rows_kernel", "conv_rows_f32_kernel",
              "up_rows_f32_kernel")
# ... and with them every kernel that computes a spatial conv's output
CONV_KERNELS = CONV_GEMMS + ("split_reduce_kernel", "split_reduce_f32_kernel")


def mean_span_ms(rec, name: str) -> Optional[float]:
    """A span's mean time a unit over the traced window."""
    v = rec.get("spans_ms", {}).get(name)
    return sum(v) / len(v) if v else None


def idle_pct(rec) -> Optional[float]:
    t = rec.get("trace")
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_gib(rec) -> Optional[float]:
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None


def mfu_pct(rec, flops_factor: float = 1.0) -> Optional[float]:
    """The window's counted operations over its time at the bf16 peak."""
    t, f = sum(rec.get("unit_s", [])), sum(rec.get("unit_flops", []))
    if t <= 0 or f <= 0:
        return None
    return 100.0 * flops_factor * f / t / PEAK_BF16_FLOPS


def per_profiled_unit(rec, value) -> Optional[float]:
    n = rec.get("profiled_units", 0)
    return value / n if n and value is not None else None
