"""The conv kernels' share of their roofline: the least time of the
profiled scans' spatial convs in the nine backbones (each conv the larger
of its occupied-pair operations at the bf16 peak and its bytes at the HBM
peak, counted by harness/work.py) over the device time of the conv
kernels (the occupied-row GEMMs and their split-K reductions) that the
backbones launched, in %. Fills, compactions, the shared grids and the
dense 1x1 products are outside both."""
from harness.readers import CONV_KERNELS


def read(rec):
    t = rec.get("trace")
    dev = t.seconds_matching(CONV_KERNELS, "backbones") if t else 0.0
    if dev <= 0 or not rec.get("profiled_conv_least_s"):
        return None
    return 100.0 * rec["profiled_conv_least_s"] / dev
