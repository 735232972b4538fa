"""Device ms a step in the scatter-add kernels (index_add_ and scatter
adds, matched by name) of the profiled steps."""
from harness.readers import per_profiled_unit

SCATTER = ("indexFuncLargeIndex", "indexFuncSmallIndex", "index_add",
           "scatter_add", "indexing_backward")


def read(rec):
    t = rec.get("trace")
    if t is None:
        return None
    s = t.seconds_matching(SCATTER)
    return per_profiled_unit(rec, s * 1e3) if s > 0 else None
