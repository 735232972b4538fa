"""The nine backbones of a scan (shared grids, stem fold, nine
forwards): a synchronized span around backbones, mean ms a scan."""
from harness.readers import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "backbones")
