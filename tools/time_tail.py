"""Time the joint path's tail (vote splat + box peel) and the peel alone on
one GPU, for the port in the current directory.

    cd <checkout root> && python3 <path>/tools/time_tail.py [--reps N]
        [--parent-peel FILE]

It imports ``canonicalvoting_tpu_torch`` and ``chip_smoke`` from the
working directory, not from the script's own checkout, so one copy of the
script times two checkouts in turn (for instance a parent commit unpacked
beside the change, run alternately in one call). The workload is
``chip_smoke.py``'s first scene with its planted head rows. Prints one
JSON line: per-call ms (CUDA events around each call) of ``pipe.tail`` and
of ``peel_boxes``, every rep and the median, and the CUDA kernels one peel
launches (``torch.profiler``).

``--parent-peel FILE`` loads another version of ``decode/peeling.py`` (a
parent commit's, say) beside the current one and times the two peels in
one process, alternating rep by rep, so that both see the same host and
card state; it also checks that they peel the same boxes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys


def timed(fn, reps):
    import torch

    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def kernel_launches(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_tail: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from canonicalvoting_tpu_torch.decode.peeling import peel_boxes
    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        compute_corners, grid_dims_from_corners, hough_voting_obj,
        vote_stats_at_cell)

    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 10
    torch.set_grad_enabled(False)
    pipe = cs.build_pipeline()
    scene = cs.make_scenes()[0]
    args = pipe.prepare_scene(scene.points, scene.rgb)
    rows = cs.planted_rows(scene, args)
    cw, valid, gshape = args.coords_w, args.valid, args.grid_shape

    xyz, scale, cls, prob = slice_joint_heads(rows)
    scale = torch.exp(scale)
    corners = compute_corners(cw, valid)
    go = hough_voting_obj(cw, xyz, scale, prob, res=cs.RES,
                          num_rots=cs.NUM_ROTS, grid_shape=gshape,
                          corners=corners, valid=valid)
    dims = torch.minimum(grid_dims_from_corners(corners, cs.RES),
                         torch.tensor(gshape, dtype=torch.int32, device=cw.device))

    def peel(fn=peel_boxes):
        return fn(go, cw, xyz, prob, cls, corners[0], pipe.peel,
                  lambda c: vote_stats_at_cell(
                      cw, xyz, scale, prob, corners[0], dims, cs.RES,
                      cs.NUM_ROTS, c, valid=valid),
                  valid=valid)

    if "--parent-peel" in sys.argv:
        parent = load_module(sys.argv[sys.argv.index("--parent-peel") + 1],
                             "parent_peeling").peel_boxes
        a, b = peel(parent), peel()
        same = all(torch.equal(a[k], b[k]) for k in a)
        ms = {"parent": [], "current": []}
        for _ in range(reps):
            for name, fn in (("parent", parent), ("current", peel_boxes)):
                ms[name] += timed(lambda: peel(fn), 1)
        print(json.dumps({
            "cwd": os.path.basename(os.getcwd()), "reps": reps,
            "same_boxes": same, "n_boxes": int(b["n_boxes"]),
            "peel_ms_median": {k: statistics.median(v) for k, v in ms.items()},
            "peel_ms": ms,
            "peel_cuda_kernels": {"parent": kernel_launches(lambda: peel(parent)),
                                  "current": kernel_launches(peel)}}), flush=True)
        return 0

    tail_ms = timed(lambda: pipe.tail(rows, cw, valid, gshape), reps)
    peel_ms = timed(peel, reps)
    print(json.dumps({
        "cwd": os.path.basename(os.getcwd()), "reps": reps,
        "n_boxes": int(peel()["n_boxes"]),
        "tail_ms_median": statistics.median(tail_ms), "tail_ms": tail_ms,
        "peel_ms_median": statistics.median(peel_ms), "peel_ms": peel_ms,
        "peel_cuda_kernels": kernel_launches(peel)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
