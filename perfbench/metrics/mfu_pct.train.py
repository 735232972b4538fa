"""Three times the forward's occupied-pair operations of every step's
batch (forward and backward) over the steps' time at the bf16 peak, in %."""
from harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec, 3.0)
