"""The control of a cell's comparison: the reference put in the program's
place at the precision below the configuration's, held against the
reference, on the cell's own inputs and sizes.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13

prints one JSON line a seed with the numbers the cell compares. The
benchmark's own runs never run it: its readings, with the sound runs'
(``run.py``), set the limits in ``limits/<workload>.json``. The faults a
cell can have are read with ``run.py --fault``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    import torch

    from harness import manifest

    cell = manifest.find_cell(args.workload)
    dev = torch.device("cpu" if args.rehearse else "cuda")
    drv = manifest.driver(cell.config["driver"])
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inp = drv.Inputs(torch, cell, seed, dev, args.rehearse)
        nums = drv.control(inp)
        row = {"workload": args.workload, "seed": seed, "control": nums,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
