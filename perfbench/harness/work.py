"""The operations and bytes a backbone's convs need, counted from the
voxel coordinates by the benchmark's own code (``reference/minkunet.py``),
so the count reads the same work whatever implements the conv.

A conv's work is its occupied (output, tap) pairs: 2 * pairs * Cin * Cout
operations (a multiply and an add). Its bytes read each occupied input row
and write each output row once, at the compute dtype's width, and read the
kernel once; the head writes float32 rows. The spatial convs (stem, subm,
down, up: k > 1) are the ones the tiled conv kernels run; the 1x1
downsample convs and the head are dense products.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from harness.device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from reference import minkunet


@dataclass
class Work:
    flops: float
    bytes: float
    least_s: float      # the sum of each conv's least time on the card
    conv_least_s: float  # the same over the spatial convs (k > 1) alone


def backbone_work(geo: "minkunet.Geometry", sites: Sequence[minkunet.Site],
                  elem_bytes: int = 2) -> Work:
    flops = nbytes = least = spatial = 0.0
    for s in sites:
        pairs = minkunet.occupied_pairs(geo, s)
        n_out = len(geo.coords[s.level])
        if s.kind == "down":
            n_in = len(geo.coords[s.level - 1])
        elif s.kind == "up":
            n_in = len(geo.coords[s.level + 1])
        else:
            n_in = n_out
        f = 2.0 * pairs * s.cin * s.cout
        out_bytes = 4 if s.kind == "head" else elem_bytes
        b = (n_in * s.cin * elem_bytes + n_out * s.cout * out_bytes
             + s.k ** 3 * s.cin * s.cout * elem_bytes)
        flops += f
        nbytes += b
        t = max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES_PER_S)
        least += t
        if s.k > 1:
            spatial += t
    return Work(flops, nbytes, least, spatial)
