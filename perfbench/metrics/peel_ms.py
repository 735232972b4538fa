"""The batched peel: a synchronized span around peel_votes, every pass
of a scan (retries included), mean ms a scan."""
from harness.readers import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "peel")
