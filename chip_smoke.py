"""Drive the PyTorch port (canonicalvoting_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from csrc/ and names the card.
Phase 1 runs every kernel at every configuration the main path gives it
(recorded from a forward pass on a ScanNet-scale synthetic scene, in
bfloat16), holds it against its plain PyTorch version, and times kernel,
plain version, the library call computing the same function where there is
one, and the card's bound for the work.
Phase 2 drives the joint inference path at full MinkUNet34C width on three
synthetic scenes (random weights from a seed; the tail decodes planted head
rows, so every scene carries boxes) and checks from the launch counters that
the path ran on the kernels.
Phase 3 runs the same path with the plain versions forced, on one scene,
and compares.

The last two lines are the kernels' summary and the status line. The script
exits non-zero, printing neither, if there is no CUDA device, if the port is
missing, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOPS = 989e12         # dense bf16 tensor cores
F32_FLOPS = 67e12           # f32 outside the tensor cores
RES, NUM_ROTS, N_SCENES = 0.03, 120, 3
# bf16 outputs (2^-8 relative rounding) from f32 sums taken in another
# order: 1% of the output's largest magnitude
CONV_REL_TOL = 1e-2
# f32 vote weights, summed exactly (fixed point, kernel) and in float64
# (plain): 1e-4 of the grid's peak
SPLAT_REL_TOL = 1e-4
# the head rows after 47 bf16 convs on each side: 1% of their largest
# magnitude
HEAD_REL_TOL = 1e-2
PER_SCENE = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 4}
SOURCES = {
    "tiled_conv3d": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                     "canonicalvoting_tpu/ops/pallas/tiled_conv.py:444"),
    "tiled_down2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                    "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1270"),
    "tiled_up2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                  "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1609"),
    "hv_splat": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                 "canonicalvoting_tpu/ops/pallas/hv_splat.py:195"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_scenes():
    import numpy as np

    from canonicalvoting_tpu_torch.data.synthetic import make_scene

    rng = np.random.RandomState(0)
    return [make_scene(rng, extent=(6.0, 2.5, 7.0), n_background=50000,
                       n_boxes=6, pts_per_box=3000) for _ in range(N_SCENES)]


def build_pipeline():
    import torch

    from canonicalvoting_tpu_torch.data.geometry import NCLASSES
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C

    torch.manual_seed(0)
    model = DenseMinkUNet34C(3, 6 * NCLASSES + NCLASSES + 1)
    return DetectionPipeline(model=model, res=RES, num_rots=NUM_ROTS,
                             peel=PeelConfig(res=RES, max_boxes=64, max_iters=96),
                             cap_multiple=4096, device="cuda")


def planted_rows(scene, args):
    import numpy as np
    import torch

    from canonicalvoting_tpu_torch.data.synthetic import (
        encode_joint_head_rows, perfect_predictions)

    coords_w = args.coords_w.cpu().numpy()
    valid = args.valid.cpu().numpy() > 0
    points_w = coords_w[valid]
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    rows = encode_joint_head_rows(points_w, xyz, scl, prob > 0.5, cls,
                                  len(valid))
    return torch.from_numpy(rows).to(args.coords_w.device)


@contextlib.contextmanager
def patched(module, **fns):
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(module, k, f)


def counters():
    from canonicalvoting_tpu_torch.ops.hv_splat import hv_splat
    from canonicalvoting_tpu_torch.ops.tiled_conv import (
        tiled_conv3d, tiled_down2, tiled_up2)

    return {"tiled_conv3d": tiled_conv3d, "tiled_down2": tiled_down2,
            "tiled_up2": tiled_up2, "hv_splat": hv_splat}


# ---------------------------------------------------------------------------
# phase 0

def phase0():
    import torch

    from canonicalvoting_tpu_torch.ops.cuda_build import build_all

    secs = build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"phase": 0, "build_s": round(secs, 3),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1

def record_calls(pipe, args, rows):
    """{config: record} of every kernel call one scene's pass makes."""
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as hv

    records = {}

    def recorder(module, name):
        f = getattr(module, name)

        def rec(*a, **kw):
            if name == "hv_splat":
                key = (name, tuple(a[0].shape), kw["grid_shape"])
            else:
                res = kw.get("residual")
                kind = ("none" if res is None else
                        f"1x1<-{res.shape[3]}" if kw.get("res_w") is not None
                        else "plain")
                key = (name, tuple(a[0].shape[3:]), tuple(a[1].shape),
                       kw["tile_shape"], int(a[2].shape[0]), kind,
                       kw.get("skip_c", 0))
            r = records.setdefault(key, {"name": name, "args": a, "kw": kw,
                                         "count": 0})
            r["count"] += 1
            return f(*a, **kw)
        return rec

    with patched(du, **{n: recorder(du, n) for n in
                        ("tiled_conv3d", "tiled_down2", "tiled_up2")}), \
            patched(hv, hv_splat=recorder(hv, "hv_splat")):
        pipe.backbone(args)
        pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    return records


def occupied_work(r, occ_of):
    """(listed cells, occupied listed cells, occupied (output, tap) pairs)
    of a recorded conv call. Empty cells hold zeros, so only the pairs whose
    output and input cells are both occupied need their products."""
    import torch

    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    name, (x, w, tiles), kw = r["name"], r["args"][:3], r["kw"]
    cells = tc._row_cells(tiles, kw["tile_shape"])
    occ = kw["occ"]
    live = occ.reshape(-1)[tc._flat(cells, occ.shape)] > 0
    n_live = int(live.sum())
    if name == "tiled_up2":  # an occupied fine cell takes one parent tap
        return cells.shape[0], n_live, n_live
    src = occ_of[tuple(x.shape[:3])].reshape(-1)
    shape = x.shape[:3]
    if name == "tiled_down2":
        base, taps = 2 * cells, [(d & 1, (d >> 1) & 1, d >> 2) for d in range(8)]
    else:
        k = kw["kernel_size"]
        base, taps = cells - k // 2, [(t % k, (t // k) % k, t // (k * k))
                                      for t in range(k ** 3)]
    pairs = 0
    for d in taps:
        src_live = src[tc._flat(base + torch.tensor(d, device=base.device), shape)] > 0
        pairs += int((live & src_live).sum())
    return cells.shape[0], n_live, pairs


def conv_bound(r, occ_of):
    """(bound_ms, bound_by): the listed cells' inputs, outputs, residual or
    skip and occupancy moved once, weights once, all at their element sizes;
    against the bf16 MACs of the occupied (output, tap) pairs, plus the
    fused 1x1 at occupied cells."""
    a, kw, name = r["args"], r["kw"], r["name"]
    x, w = a[0], a[1]
    rows, live, pairs = occupied_work(r, occ_of)
    _, cin, cout = w.shape
    el = x.element_size()
    in_rows = {"tiled_down2": rows * 8, "tiled_up2": rows // 8}.get(name, rows)
    skip_c = kw.get("skip_c", 0)
    nbytes = ((in_rows * cin + rows * (cout + 2 * skip_c)) * el
              + w.numel() * el + rows * 4)
    flops = 2 * pairs * cin * cout
    res = kw.get("residual")
    if res is not None:
        nbytes += rows * res.shape[3] * el
        if kw.get("res_w") is not None:
            nbytes += kw["res_w"].numel() * el
            flops += 2 * live * res.shape[3] * cout
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), \
        {"listed_cells": rows, "occupied_cells": live, "occupied_pairs": pairs}


def splat_bound(r):
    """Point rows in, grid out; f32 ops per vote: ~12 to place it, ~32
    more to weight its 8 corners when it lands in range."""
    import torch

    from canonicalvoting_tpu_torch.ops.hv_splat import rotation_table

    points, xyz, scale, obj, corner, dims, res = r["args"]
    valid = r["kw"]["valid"]
    gx, gy, gz = r["kw"]["grid_shape"]
    cosv, sinv = rotation_table(r["kw"]["num_rots"], points.device)
    corr = xyz * scale
    live = valid > 0
    in_range = 0
    for c, s in zip(cosv, sinv):
        u = torch.stack([points[:, 0] - c * corr[:, 0] + s * corr[:, 2],
                         points[:, 1] - corr[:, 1],
                         points[:, 2] - s * corr[:, 0] - c * corr[:, 2]], -1)
        u = (u - corner) / res
        ok = torch.all((u >= 0) & (u < dims.float() - 1), -1) & live
        in_range += int(ok.sum())
    votes = int(live.sum()) * len(cosv)
    nbytes = points.shape[0] * 11 * 4 + gx * gy * gz * 4
    flops = votes * 12 + in_range * 32
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), in_range


def library_call(r):
    """One PyTorch call computing the same (unmasked, whole-grid) function,
    used only as a yardstick here."""
    import torch.nn.functional as F

    name, a = r["name"], r["args"]
    if name == "hv_splat":
        return None
    x, w = a[0], a[1]
    xs = x.permute(3, 0, 1, 2)[None].contiguous()
    if name == "tiled_up2":
        wt = w.reshape(2, 2, 2, w.shape[1], w.shape[2]).permute(3, 4, 2, 1, 0)
        wt = wt.contiguous().to(x.dtype)
        return lambda: F.conv_transpose3d(xs, wt, stride=2)
    k = round(w.shape[0] ** (1 / 3))
    wc = w.reshape(k, k, k, w.shape[1], w.shape[2]).permute(4, 3, 2, 1, 0)
    wc = wc.contiguous().to(x.dtype)
    if name == "tiled_down2":
        return lambda: F.conv3d(xs, wc, stride=2)
    return lambda: F.conv3d(xs, wc, padding=k // 2)


def rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, float(want.float().abs().max())


def phase1(pipe, scene):
    import torch

    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    plain = {"tiled_conv3d": tc.tiled_conv3d_plain,
             "tiled_down2": tc.tiled_down2_plain,
             "tiled_up2": tc.tiled_up2_plain, "hv_splat": hs.hv_splat_plain}
    kern = counters()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    records = record_calls(pipe, args, planted_rows(scene, args))
    occ_of = {tuple(r["kw"]["occ"].shape): r["kw"]["occ"]
              for r in records.values() if r["name"] == "tiled_conv3d"}
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                   "operations": 0.0} for n in kern}
    failures = []
    for key, r in records.items():
        name, a, kw = r["name"], r["args"], r["kw"]
        err, scale = rel_err(kern[name](*a, **kw), plain[name](*a, **kw))
        tol = (SPLAT_REL_TOL if name == "hv_splat" else CONV_REL_TOL) * scale
        if not err <= tol:
            failures.append((key, err, tol))
        extra = {}
        ms = time_ms(lambda: kern[name](*a, **kw), 5)
        plain_ms = time_ms(lambda: plain[name](*a, **kw), 2)
        lib = library_call(r)
        lib_ms = time_ms(lib, 3) if lib is not None else None
        if name == "hv_splat":
            (bound_ms, bound_by), extra["in_range_votes"] = splat_bound(r)
        else:
            (bound_ms, bound_by), work = conv_bound(r, occ_of)
            extra.update(work)
        n = r["count"]
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms * n
        s["plain_ms"] += plain_ms * n
        s["bound_ms"] += bound_ms * n
        s[bound_by] += bound_ms * n
        s["library_ms"] = None if lib_ms is None else s["library_ms"] + lib_ms * n
        emit({"phase": 1, "kernel": name, "config": [str(v) for v in key[1:]],
              "per_scene": n, "max_abs_err": err, "ref_max": scale,
              "tol": tol, "kernel_ms": ms, "plain_ms": plain_ms,
              "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, **extra})
    records.clear()
    occ_of.clear()
    torch.cuda.empty_cache()
    assert not failures, f"kernels disagree with their plain versions: {failures}"
    for n, s in summary.items():
        s["bound_by"] = "bytes" if s.pop("bytes") >= s.pop("operations") \
            else "operations"
    return summary


# ---------------------------------------------------------------------------
# phase 2

def run_planted(pipe, args, rows):
    out = pipe.backbone(args)
    res = pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    return out, res, pipe.postprocess(res)


def stage_times(pipe, scene):
    """Per-stage ms of one scene, synchronizing between stages."""
    import torch

    from canonicalvoting_tpu_torch.decode.peeling import peel_boxes
    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        compute_corners, grid_dims_from_corners, hough_voting_obj,
        vote_stats_at_cell)

    t = {}
    t0 = time.perf_counter()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    torch.cuda.synchronize()
    t["prep"] = time.perf_counter() - t0
    rows = planted_rows(scene, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.backbone(args)
    torch.cuda.synchronize()
    t["backbone"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xyz, scale, cls, prob = slice_joint_heads(rows)
    scale = torch.exp(scale)
    corners = compute_corners(args.coords_w, args.valid)
    go = hough_voting_obj(args.coords_w, xyz, scale, prob, res=RES,
                          num_rots=NUM_ROTS, grid_shape=args.grid_shape,
                          corners=corners, valid=args.valid)
    torch.cuda.synchronize()
    t["splat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dims = torch.minimum(grid_dims_from_corners(corners, RES),
                         torch.tensor(args.grid_shape, dtype=torch.int32,
                                      device=go.device))
    out = peel_boxes(go, args.coords_w, xyz, prob, cls, corners[0], pipe.peel,
                     lambda c: vote_stats_at_cell(
                         args.coords_w, xyz, scale, prob, corners[0], dims,
                         RES, NUM_ROTS, c, valid=args.valid),
                     valid=args.valid)
    torch.cuda.synchronize()
    t["peel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.postprocess(out)
    t["nms"] = time.perf_counter() - t0
    return {k: v * 1e3 for k, v in t.items()}


def phase2(pipe, scenes):
    import numpy as np
    import torch

    prepped = [pipe.prepare_scene(s.points, s.rgb) for s in scenes]
    planted = [planted_rows(s, a) for s, a in zip(scenes, prepped)]
    for a, r in zip(prepped, planted):  # warm-up: allocator, cuBLAS, libraries
        run_planted(pipe, a, r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters().values():
        fn.launches = 0
    t0 = time.perf_counter()
    n_boxes = []
    for a, r in zip(prepped, planted):
        out, res, dets = run_planted(pipe, a, r)
        n_boxes.append(int(res["n_boxes"]))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    rows_ok = bool(torch.isfinite(out).all()) and out.shape[1] == 64
    stages = [stage_times(pipe, s) for s in scenes]
    emit({"phase": 2, "scenes": len(scenes), "scenes_per_s": len(scenes) / elapsed,
          "n_boxes": n_boxes, "launches": launches,
          "stage_ms": {k: float(np.median([s[k] for s in stages]))
                       for k in stages[0]},
          "peak_mem_gib": peak / 2 ** 30,
          "voxels": [int(a.valid.sum()) for a in prepped],
          "dense_dims": list(prepped[0].dense_dims),
          "grid_shape": list(prepped[0].grid_shape)})
    assert rows_ok, "head rows not finite or not 64 wide"
    assert all(n >= 4 for n in n_boxes), f"planted scenes lost boxes: {n_boxes}"
    for n, per in PER_SCENE.items():
        assert launches[n] == per * len(scenes), (n, launches[n])
    assert launches["hv_splat"] >= len(scenes), launches
    return launches, prepped[0], planted[0]


# ---------------------------------------------------------------------------
# phase 3

def phase3(pipe, args, rows):
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as hv
    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    head_k, res_k, _ = run_planted(pipe, args, rows)
    with patched(du, tiled_conv3d=tc.tiled_conv3d_plain,
                 tiled_down2=tc.tiled_down2_plain,
                 tiled_up2=tc.tiled_up2_plain), \
            patched(hv, hv_splat=hs.hv_splat_plain):
        head_p, res_p, _ = run_planted(pipe, args, rows)
    torch.cuda.synchronize()
    n = int(res_k["n_boxes"])
    head_err = float((head_k - head_p).abs().max())
    head_max = float(head_p.abs().max())
    box_err = float((res_k["boxes"][:n] - res_p["boxes"][:n]).abs().max()) \
        if n else 0.0
    emit({"phase": 3, "n_boxes": [n, int(res_p["n_boxes"])],
          "head_rows_max_abs_err": head_err, "head_rows_max": head_max,
          "head_rows_tol": HEAD_REL_TOL * head_max,
          "box_max_abs_err": box_err})
    assert n == int(res_p["n_boxes"]) and n >= 4, "box counts differ"
    assert torch.equal(res_k["classes"][:n], res_p["classes"][:n]), "classes differ"
    # an argmax tie broken the other way moves a peeled cell by one: boxes
    # agree within one vote cell
    assert box_err <= RES + 1e-4, f"boxes differ by {box_err}"
    assert head_err <= HEAD_REL_TOL * head_max, \
        f"head rows differ by {head_err} (limit {HEAD_REL_TOL * head_max})"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import canonicalvoting_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root: the port "
              "(canonicalvoting_tpu_torch) is missing", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)  # inference only
    # float32 references in full float32 (no TF32 in matmuls or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    failed = []
    smi = phase0()
    pipe = build_pipeline()
    scenes = make_scenes()
    done = {}
    phases = (("phase1", lambda: phase1(pipe, scenes[0])),
              ("phase2", lambda: phase2(pipe, scenes)),
              ("phase3", lambda: phase3(pipe, *done["phase2"][1:])))
    for name, run in phases:
        try:
            done[name] = run()
        except Exception as e:  # reported; the run then exits 1
            failed.append(name)
            print(f"chip_smoke: {name} FAILED: {e!r}", file=sys.stderr)
    emit({"total_s": time.perf_counter() - t_start, "failed": failed})
    if failed:
        return 1
    summary, launches = done["phase1"], done["phase2"][0]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"]})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
