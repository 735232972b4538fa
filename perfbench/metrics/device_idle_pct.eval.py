"""The card's idle share of the profiled scans, in %."""
from harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
