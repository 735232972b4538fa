"""Measure the vote splat's pieces on one GPU, for the port in the current
directory: the objectness splat (``hv_splat``), with ``--channels 6`` the
6-channel splat of the non-lazy tails (``hv_splat6``), or with
``--windowed`` the windowed objectness splat of
``hv_method="pallas_windowed"`` (``hv_splat_windowed``, 32-cell x buckets).

    cd <checkout root> && python3 <path>/tools/splat_probe.py [--reps N] [--channels 6 | --windowed] [--heads FILE]

It imports ``canonicalvoting_tpu_torch`` from the working directory and the
workload and timers from the ``chip_smoke.py`` of the checkout that holds
the script, so one copy of the script measures two checkouts in turn (a
parent commit unpacked beside the change) on the same workload. The
workload is ``chip_smoke.py``'s first scene, with two sets of head rows:

- ``planted``: the joint path's planted head rows (one grid) and the
  separate path's planted rows of its nine categories. Their
  background points have an offset of exactly 0, so all 120 votes of such
  a point fall in one cell;
- ``backbone``: the head rows of the joint model and of the nine
  category models themselves (random weights from their seeds), whose
  offsets are not zero. Two checkouts whose backbones round differently
  give different rows; with ``--heads FILE`` the rows are read from FILE
  where it exists and written to it otherwise, so that a second checkout
  splats the first one's rows and the grids' SHA-1 compare.

Prints one JSON line with, for each set and path (``joint``, and
``separate``, whose nine categories splat over the separate path's own
points and grid):

- ``call_ms``: one splat call (the nine categories: nine single calls, and
  one batched call where the checkout has it), CUDA events over ``reps``
  calls;
- ``host_ms``: the host's time to issue one call, no sync between calls
  (a wrapper that syncs inside waits for the card here);
- ``device_ms``: device time by kernel name over one call, from
  ``torch.profiler`` ("not measured" when it reports none): the vote
  kernel, the scratch's zero fill and the fixed-point conversion apart;
- ``votes``, ``in_range``: votes and the votes inside the grid;
- ``small_offset_share``: the valid points whose offset is under one cell
  in x and z (their votes at every rotation stay in or next to one cell);
- ``whole_warp``: with threads rotations fastest, the share of the warps
  holding an in-range vote whose 32 votes are all in range and share one
  floor cell (the kernel's whole-warp path), and the share of the
  in-range votes in them;
- ``atomics``: the 64-bit atomics that three vote designs issue for these
  inputs: ``per_vote`` one a corner (and channel) of every in-range vote
  (one thread a vote, no grouping), and ``points_fastest`` /
  ``rotations_fastest`` one a corner and channel of each group of a warp's
  in-range votes that share a floor cell, with the threads' order running
  points or rotations fastest, the group's exact fixed-point sums of zero
  skipped;
- ``sha1``: of each grid's bytes, to compare checkouts bit for bit.

With ``--windowed``, each joint entry also has:

- ``host_pieces_ms``: the host's time to issue each piece of one call,
  each piece alone (the pieces the checkout's wrapper has: the segment
  keys, their stable sort and the segments' ranges where it sorts; the
  kernel arguments, the scratch's zero fill, the vote launch and the
  conversion's launch where it does not);
- ``window_order``: ``call_ms``, ``device_ms`` and ``sha1`` of the same
  call on the rows sorted by their window key (``window_keys``, stable),
  the order the TPU kernel's segments put the votes in: whether that
  locality pays on the card. The grid's SHA-1 must equal the unsorted
  call's (the sums are exact).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys


def load_chip_smoke():
    """The chip_smoke.py beside this script's tools/ directory."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_ms(fn):
    """{kernel name: device ms} of one call, or "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0:
            out[e.key[:80]] = out.get(e.key[:80], 0.0) + us / 1e3
    return out or "not measured"


def atomics(points, xyz, scale, obj, corner, dims, res, num_rots, valid,
            grid_shape, channels=1):
    """Counts of one category's splat, the votes placed as the plain version
    places them: votes, in-range votes, valid points with an offset under a
    cell, whole-warp groups and {design: atomics}. A group's atomics are
    those of its corners and channels whose sum of 64-bit fixed-point
    weights (``round(w * 2^32)``, the kernels' conversion) is not zero."""
    import torch
    import torch.nn.functional as F

    from canonicalvoting_tpu_torch.ops.hv_splat import (
        device_scalar, rotation_table)

    gx, gy, gz = grid_shape
    n = points.shape[0]
    cosv, sinv = rotation_table(num_rots, points.device)
    c, s = cosv[:, None], sinv[:, None]                        # (R, 1)
    corr = xyz * scale
    cx, cy, cz = corr[:, 0], corr[:, 1], corr[:, 2]
    r = device_scalar(res, points.device)
    uy = ((points[:, 1] - cy) - corner[1]) / r
    u = torch.stack([(points[:, 0] + (-c * cx + s * cz) - corner[0]) / r,
                     uy.expand(num_rots, n),
                     (points[:, 2] + (-s * cx - c * cz) - corner[2]) / r], -1)
    ok = torch.all((u >= 0.0) & (u < dims.float() - 1.0), -1) & (valid > 0)
    fl = torch.floor(u)
    w1 = u - fl
    fl = fl.long()
    key = (fl[..., 0] * gy + fl[..., 1]) * gz + fl[..., 2]     # (R, N)
    rot = torch.arange(num_rots, device=points.device)[:, None]
    pt = torch.arange(n, device=points.device)[None, :]
    warps = {"points_fastest": (rot * n + pt) // 32,
             "rotations_fastest": (pt * num_rots + rot) // 32}
    ob = (obj * valid)[None, :]
    # the channels' factors: [1] or [1, cos, sin, sx, sy, sz]
    factors = [None] if channels == 1 else \
        [None, c, s] + [scale[None, :, a] for a in range(3)]
    cells = gx * gy * gz
    out = {"per_vote": 8 * len(factors) * int(ok.sum())}
    groups = {}
    for name, warp in warps.items():
        out[name] = 0
        groups[name] = torch.unique(warp[ok] * cells + key[ok],
                                    return_inverse=True)[1]
    for b in range(8):
        bits = ((b >> 2) & 1, (b >> 1) & 1, b & 1)
        w = None  # the kernels' order: ((wx * wy) * wz) * obj
        for a, bit in enumerate(bits):
            wa = w1[..., a] if bit else 1.0 - w1[..., a]
            w = wa if w is None else w * wa
        w = w * ob
        for f in factors:
            wf = (w if f is None else w * f)[ok]
            fixed = torch.round(wf * 2.0 ** 32).long()
            for name, inv in groups.items():
                sums = torch.zeros(int(inv.max()) + 1 if inv.numel() else 0,
                                   dtype=torch.int64, device=points.device)
                sums.scatter_add_(0, inv, fixed)
                out[name] += int((sums != 0).sum())
    # the kernel's warps, rotations fastest: lanes past the last vote are out
    pad = (-n * num_rots) % 32
    ok_w = F.pad(ok.T.reshape(-1), (0, pad)).reshape(-1, 32)
    key_w = F.pad(key.T.reshape(-1), (0, pad)).reshape(-1, 32)
    whole = ok_w.all(1) & (key_w == key_w[:, :1]).all(1)
    small = (valid > 0) & (torch.maximum(cx.abs(), cz.abs()) < r)
    counts = {"votes": num_rots * n, "in_range": int(ok.sum()),
              "valid_points": int((valid > 0).sum()),
              "small_offset_points": int(small.sum()),
              "warps_in_range": int(ok_w.any(1).sum()),
              "whole_warps": int(whole.sum())}
    return counts, out


def windowed_pieces(hs, cs, a, kw, reps):
    """{piece: the host's ms to issue it} of one windowed splat call with
    args ``a`` and keywords ``kw``, each piece alone."""
    import torch

    points, xyz, scale, obj, corner, dims, res = a
    kk = dict(grid_shape=kw["grid_shape"], valid=kw["valid"],
              x_bucket=kw["x_bucket"])
    if "window" not in inspect.signature(hs._votes).parameters:
        key = hs.window_keys(points, xyz, scale, corner, dims, res, **kk)
        segs = torch.arange(int(key.max()) + 1, device=key.device)
        sorted_key = torch.sort(key, stable=True)[0]
        return {"keys": cs.host_ms(lambda: hs.window_keys(
                    points, xyz, scale, corner, dims, res, **kk), reps),
                "sort": cs.host_ms(lambda: torch.sort(key, stable=True), reps),
                "ranges": cs.host_ms(lambda: (
                    torch.searchsorted(sorted_key, segs),
                    torch.searchsorted(sorted_key, segs + 1)), reps)}
    shape = tuple(obj.shape[:-1]) + tuple(kw["grid_shape"]) + (1,)
    f, v, d, tables = hs._kernel_args(points, xyz, scale, obj, corner, dims,
                                      kw["valid"], kw["num_rots"],
                                      kw["grid_shape"])
    acc = torch.zeros(shape, dtype=torch.int64, device=points.device)
    out = torch.empty(shape, dtype=torch.float32, device=points.device)
    pad = inspect.signature(hs.hv_splat_windowed).parameters["x_pad"].default
    return {"kernel_args": cs.host_ms(lambda: hs._kernel_args(
                points, xyz, scale, obj, corner, dims, kw["valid"],
                kw["num_rots"], kw["grid_shape"]), reps),
            "scratch": cs.host_ms(lambda: torch.zeros(
                shape, dtype=torch.int64, device=points.device), reps),
            "votes": cs.host_ms(lambda: hs._votes(
                acc, f, v, d, tables, res, kw["num_rots"], kw["grid_shape"],
                1, (kw["x_bucket"], pad)), reps),
            "convert": cs.host_ms(lambda: hs._fixed_to_float(acc, out), reps)}


def summarize(per_cat):
    """Sums of atomics() over categories, with the shares."""
    counts = {k: sum(p[0][k] for p in per_cat) for k in per_cat[0][0]}
    return {"votes": counts["votes"], "in_range": counts["in_range"],
            "small_offset_share": counts["small_offset_points"]
            / max(counts["valid_points"], 1),
            "whole_warp": {
                "warp_share": counts["whole_warps"]
                / max(counts["warps_in_range"], 1),
                "vote_share": 32 * counts["whole_warps"]
                / max(counts["in_range"], 1)},
            "atomics": {k: sum(p[1][k] for p in per_cat) for k in per_cat[0][1]}}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--channels", type=int, choices=(1, 6), default=1)
    parser.add_argument("--windowed", action="store_true")
    parser.add_argument("--heads", help="the backbone head rows' file: read "
                        "where it exists, else written")
    opts = parser.parse_args()
    reps, channels = opts.reps, opts.channels
    if opts.windowed and channels != 1:
        parser.error("--windowed splats one channel")
    if not torch.cuda.is_available():
        print("splat_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    from canonicalvoting_tpu_torch.eval.pipeline import (
        slice_joint_heads, slice_separate_heads)
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        clipped_grid_dims, compute_corners)

    torch.set_grad_enabled(False)
    scene = cs.make_scenes()[0]
    pipe = cs.build_pipeline()
    sep = cs.build_separate()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    sargs = sep.prepare_quantized(*cs.quantize(scene))
    C = len(sep.categories)

    def sha(t):
        return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    def splat_of(a):
        corners = compute_corners(a.coords_w, a.valid)
        dims = clipped_grid_dims(corners, cs.RES, a.grid_shape)
        kw = dict(num_rots=cs.NUM_ROTS, grid_shape=a.grid_shape, valid=a.valid)
        if opts.windowed:
            splat, kw["x_bucket"] = hs.hv_splat_windowed, 32
        else:
            splat = hs.hv_splat if channels == 1 else hs.hv_splat6

        def one(x, s, o, points=None, valid=None):
            return splat(a.coords_w if points is None else points, x, s, o,
                         corners[0], dims, cs.RES,
                         **{**kw, "valid": a.valid if valid is None else valid})

        def counts(x, s, o):
            return atomics(a.coords_w, x, s, o, corners[0], dims, cs.RES,
                           cs.NUM_ROTS, a.valid, a.grid_shape, channels)

        def pieces(x, s, o):
            return windowed_pieces(hs, cs, (a.coords_w, x, s, o, corners[0],
                                            dims, cs.RES), kw, reps)

        def window_rows(x, s, o):
            """points, x, s, o and valid sorted by their window key"""
            key = hs.window_keys(a.coords_w, x, s, corners[0], dims, cs.RES,
                                 grid_shape=a.grid_shape, valid=a.valid,
                                 x_bucket=32)
            rows = torch.argsort(key, stable=True)
            return tuple(t[rows].contiguous()
                         for t in (a.coords_w, x, s, o, a.valid))
        return one, counts, pieces, window_rows

    def joint(heads):
        xyz, scale, _, prob = slice_joint_heads(heads)
        x = (xyz.contiguous(), torch.exp(scale).contiguous(), prob.contiguous())
        one, counts, pieces, window_rows = splat_of(args)
        out = {"call_ms": cs.time_ms(lambda: one(*x), reps),
               "host_ms": cs.host_ms(lambda: one(*x), reps),
               "device_ms": device_ms(lambda: one(*x)),
               **summarize([counts(*x)]), "sha1": sha(one(*x))}
        if opts.windowed:
            p, xs, ss, os_, v = window_rows(*x)

            def in_window_order():
                return one(xs, ss, os_, points=p, valid=v)

            out["host_pieces_ms"] = pieces(*x)
            out["window_order"] = {
                "call_ms": cs.time_ms(in_window_order, reps),
                "device_ms": device_ms(in_window_order),
                "sha1": sha(in_window_order())}
        return out

    def separate(heads):
        xyz, scale, prob = slice_separate_heads(heads)
        x = (xyz.contiguous(), torch.exp(scale).contiguous(), prob.contiguous())
        one, counts, _, _ = splat_of(sargs)

        def singles():
            return [one(x[0][c], x[1][c], x[2][c]) for c in range(C)]

        out = {"singles_ms": cs.time_ms(singles, max(1, reps // 3)),
               "singles_host_ms": cs.host_ms(singles, max(1, reps // 3)),
               "singles_device_ms": device_ms(singles),
               **summarize([counts(x[0][c], x[1][c], x[2][c])
                            for c in range(C)]),
               "sha1": sha(torch.stack(singles()))}
        try:
            batched = one(*x)
        except ValueError:  # a checkout without the category axis
            return out
        out.update(batched_ms=cs.time_ms(lambda: one(*x), reps),
                   batched_host_ms=cs.host_ms(lambda: one(*x), reps),
                   batched_device_ms=device_ms(lambda: one(*x)),
                   batched_sha1=sha(batched))
        return out

    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip(),
              "channels": channels, "windowed": opts.windowed,
              "grid_shape": list(args.grid_shape),
              "points": int(args.valid.shape[0])}
    dev = args.coords_w.device
    report["planted"] = {
        "joint": joint(cs.planted_rows(scene, args)),
        "separate": separate(torch.as_tensor(cs.separate_rows(scene, sargs, C),
                                             device=dev))}
    if opts.heads and os.path.exists(opts.heads):
        heads = {k: v.to(dev) for k, v in torch.load(opts.heads).items()}
    else:
        heads = {"joint": pipe.run_backbone(args), "separate": sep.backbones(sargs)}
        if opts.heads:
            torch.save({k: v.cpu() for k, v in heads.items()}, opts.heads)
    report["backbone"] = {"joint": joint(heads["joint"]),
                          "separate": separate(heads["separate"])}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
