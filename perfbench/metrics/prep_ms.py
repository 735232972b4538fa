"""Host prep of a scan: the span around prepare_quantized (dense
prep of the quantized voxels and their upload), mean ms a scan."""
from harness.readers import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "prep")
