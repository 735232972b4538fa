"""Host NMS: the span around postprocess (the outputs copied to the host
and each category's NMS), mean ms a scan."""
from harness.readers import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "nms")
