"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The workload's configuration, traffic mix,
per-layer metrics and comparison limits are found by name through
``BENCHMARK.json`` (``harness/manifest.py``); its configuration names the
driver (``drivers/<driver>.py``) that sets the program up, warms up every
shape the traffic uses, runs the measured window and hands what the window
produced to the reference.

The run needs as many CUDA cards as the cell asks for, and exits non-zero
with no result without them. ``--rehearse`` runs the same code on the CPU
at the configuration's tiny rehearsal sizes (the port's plain versions):
its numbers are never a device's and go under ``cpu_rehearsal``.
``--fault`` plants one of the faults the comparison has to catch (the
fault tests under ``tests/``).

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``: each compared number beside its limit, which also end
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
HOST_THREADS = 4   # torch's intra-op pool and numpy's OpenMP / BLAS pools
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
            "NUMEXPR_NUM_THREADS"):
    os.environ[var] = str(HOST_THREADS)
BUILD = ROOT / "build"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(BUILD / "torch_kernels")
sys.path[:0] = [str(HERE), str(ROOT)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, tiny sizes, no device metrics")
    p.add_argument("--fault", default="",
                   choices=("", "answer", "half", "unchanged"))
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def run(argv=None) -> dict:
    args = parse(argv)
    import torch

    from harness import device as hw
    from harness import manifest

    torch.set_num_threads(HOST_THREADS)
    cell = manifest.find_cell(args.workload)
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{args.workload} needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
    drv_mod = manifest.driver(cell.config["driver"])
    drv = drv_mod.Driver(torch, cell, args.seed, dev, bool(args.trace),
                         fault=args.fault, rehearse=args.rehearse)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    smi_before = hw.smi() if dev.type == "cuda" else {}
    setup_s = time.perf_counter() - T_START
    window_s = drv.run_window(args.seconds)
    summary = None
    if args.trace:
        summary = drv.run_profiled()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    smi_after = hw.smi() if dev.type == "cuda" else {}

    if args.trace:
        record = dict(drv.layer_record(window_s), trace=summary, peak_bytes=peak)
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = dict(drv.end_to_end(window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    info = drv.info()
    drv.release()
    t_check = time.perf_counter()
    nums = drv.check(cell.limits)
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in nums.items()}
    correct = all(math.isfinite(v) and v <= cell.limits[k] for k, v in nums.items())

    found = hw.forbidden_modules()
    if found:
        fail("JAX or the JAX package was loaded: " + ", ".join(found), 3)

    print(json.dumps({"info": info, "compared": getattr(drv, "worst", None),
                      "host_threads": HOST_THREADS,
                      "window_s": window_s, "setup_s": setup_s,
                      "check_s": check_s,
                      "smi": [smi_before, smi_after]}), flush=True)
    result = {"correct": bool(correct), "attempted": drv.attempted(),
              "failed": int(drv.failed)}
    if dev.type == "cuda":
        result["metrics"] = metrics
        result["device"] = dict(hw.device_info(torch, cell.chips),
                                memory_peak_bytes=int(peak))
    else:
        result["metrics"] = {}
        result["cpu_rehearsal"] = metrics
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'OVER'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    run()
