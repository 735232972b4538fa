"""The nine backbones' occupied-pair operations of every scan of the
window over the scans' time at the bf16 peak, in %."""
from harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
