"""Kernels the peel launches a scan (every pass), from the profiled
scans."""
from harness.readers import per_profiled_unit


def read(rec):
    t = rec.get("trace")
    if t is None or "peel" not in t.span_kernels:
        return None
    return per_profiled_unit(rec, t.span_kernels["peel"])
