"""The vote splat: a synchronized span around vote (head slice, corners,
one objectness splat of the nine categories), mean ms a scan."""
from harness.readers import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "splat")
