"""Conv GEMM kernel launches a scan (the occupied-row GEMMs of the
tiled convs, ups and downs), from the profiled scans."""
from harness.readers import CONV_GEMMS, per_profiled_unit


def read(rec):
    t = rec.get("trace")
    if t is None or "backbones" not in t.span_kernel_names:
        return None
    return per_profiled_unit(rec, t.launches_matching(CONV_GEMMS, "backbones"))
