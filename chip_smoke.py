"""Drive the PyTorch port (canonicalvoting_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from csrc/ and names the card.
Phase 1 runs every kernel at every configuration the paths give it
(recorded from a pass on a ScanNet-scale synthetic scene, in bfloat16: the
joint path, the separate path's prefolded stem, the non-lazy tail's
6-channel splat, the joint path's variant routes: the into-convs of
up_impl="into" and the windowed splat of hv_method="pallas_windowed"),
holds it against its plain PyTorch version, and times kernel, plain
version, the library call computing the same function where there is one,
the zero fill of the output grid inside the wrapper, and the card's bound
for the work. The occupied-row kernels (tiled_conv3d, tiled_up2) must also
give bitwise-equal outputs on a repeated call, and equal their plain
versions at one L0 and one L1 configuration on random inputs that are
non-zero at unoccupied cells too (x, a plain residual, the skip). The
fused BasicBlock kernel, which no path runs, is held against its plain
version and the two-conv output on the recorded input of each of the joint
pass's 23 blocks.
Phase 2 drives the joint inference path at full MinkUNet34C width on three
synthetic scenes (random weights from a seed; the tail decodes planted head
rows, so every scene carries boxes) and checks from the launch counters that
the path ran on the kernels.
Phase 3 runs the same path with the plain versions forced, on one scene,
and compares.
The separate phase drives the 9-category separate evaluator (nine
MinkUNet34C(3, 8), prefold stem, lazy rot/scale) on two of those scenes,
checks the exact launch counts and that each planted category finds its
box, then reruns one scene with two categories on the plain versions.
The stem phase times the separate path's shared grids and nine backbones
with the prefolded stem and with the tiled k=5 stem, and compares their
head rows.
The non-lazy phase runs the joint path and the separate evaluator with
lazy_rot_scale=False (the 6-channel splat) against their lazy paths, and
the separate evaluator with group_size=2 against group_size=1.
The variants phase drives the three scenes through the joint path with
up_impl="into" and hv_method="pallas_windowed", checks the exact launch
counts and the default routes' boxes and head rows, times backbone and
splat both ways, and runs one separate scene with both variants against
the default.

The last two lines are the kernels' summary and the status line. The script
exits non-zero, printing neither, if there is no CUDA device, if the port is
missing, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import functools
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
# the default routes run none of the variant routes' kernels
NO_VARIANTS = {"tiled_up2_into": 0, "hv_splat_windowed": 0, "tiled_block3d": 0}
PER_SCENE = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 4,
             **NO_VARIANTS}
# one separate scene: 9 categories x (46 k=3 convs, the prefolded stem, 4
# downs, 4 ups, one objectness splat)
SEPARATE_PER_SCENE = {"tiled_conv3d": 9 * 46, "tiled_conv3d_prefolded": 9,
                      "tiled_down2": 36, "tiled_up2": 36, "hv_splat": 9,
                      "hv_splat6": 0, **NO_VARIANTS}
# one joint scene with up_impl="into" (the ups into L0 and L1) and
# hv_method="pallas_windowed"
VARIANT_PER_SCENE = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 2,
                     "tiled_up2_into": 2, "hv_splat_windowed": 1,
                     "hv_splat": 0, "tiled_block3d": 0}
N_SEPARATE_SCENES = 2
SOURCES = {
    "tiled_conv3d": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                     "canonicalvoting_tpu/ops/pallas/tiled_conv.py:444"),
    "tiled_conv3d_prefolded": (
        "canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
        "canonicalvoting_tpu/ops/pallas/tiled_conv.py:444 (prefolded=True)"),
    "tiled_down2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                    "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1270"),
    "tiled_up2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                  "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1609"),
    "hv_splat": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                 "canonicalvoting_tpu/ops/pallas/hv_splat.py:195"),
    "hv_splat6": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                  "canonicalvoting_tpu/ops/pallas/hv_splat.py:195 (channels=6)"),
    "tiled_up2_into": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                       "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1961"),
    "hv_splat_windowed": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                          "canonicalvoting_tpu/ops/pallas/hv_splat.py:404"),
    "tiled_block3d": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                      "canonicalvoting_tpu/ops/pallas/tiled_conv.py:977"),
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


def build_separate(**kw):
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.separate import (
        ALL_CATEGORIES, SeparateDetectionPipeline)
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

    model = DenseMinkUNet34C(3, 8, up_impl=kw.pop("up_impl", None))
    cats = kw.pop("categories", ALL_CATEGORIES)
    pipe = SeparateDetectionPipeline(
        model=model, categories=cats, res=RES, num_rots=NUM_ROTS,
        peel=PeelConfig(res=RES, max_boxes=64, max_iters=96,
                        elimination_inclusive=False), device="cuda", **kw)
    # random weights, torch.manual_seed(c) for category c
    pipe.set_state_dicts(category_state_dicts(model, cats))
    return pipe


def quantize(scene):
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    coords, idx = sparse_quantize(scene.points, RES)
    return coords, scene.rgb[idx]


def separate_rows(scene, args, n_categories):
    """Planted (C, cap, 8) head rows: category c gets the confident points
    of the scene's class-c boxes (the category order is the class order)."""
    import numpy as np

    from canonicalvoting_tpu_torch.data.synthetic import (
        encode_separate_head_rows, perfect_predictions)

    valid = args.valid.cpu().numpy() > 0
    points_w = args.coords_w.cpu().numpy()[valid]
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    return np.stack([encode_separate_head_rows(
        points_w, xyz, scl, (prob > 0.5) & (cls == c), len(valid))
        for c in range(n_categories)])


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
def variants(pipe, up_impl="into", hv_method="pallas_windowed"):
    """The joint pipeline on the opt-in routes, restored on exit."""
    old = pipe.model.up_impl, pipe.hv_method
    pipe.model.up_impl, pipe.hv_method = up_impl, hv_method
    try:
        yield pipe
    finally:
        pipe.model.up_impl, pipe.hv_method = old


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
    from canonicalvoting_tpu_torch.ops.hv_splat import (
        hv_splat, hv_splat6, hv_splat_windowed)
    from canonicalvoting_tpu_torch.ops.tiled_conv import (
        tiled_block3d, tiled_conv3d, tiled_conv3d_prefolded, tiled_down2,
        tiled_up2, tiled_up2_into)

    return {"tiled_conv3d": tiled_conv3d,
            "tiled_conv3d_prefolded": tiled_conv3d_prefolded,
            "tiled_down2": tiled_down2, "tiled_up2": tiled_up2,
            "hv_splat": hv_splat, "hv_splat6": hv_splat6,
            "tiled_up2_into": tiled_up2_into,
            "hv_splat_windowed": hv_splat_windowed,
            "tiled_block3d": tiled_block3d}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {n: fn.launches for n, fn in counters().items()}


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

def recorder(records, module, name):
    """A stand-in for ``module.name`` that records each call's
    configuration, arguments and count per scene, then calls it."""
    f = getattr(module, name)

    def rec(*a, **kw):
        if name.startswith("hv_splat"):
            key = (name, tuple(a[0].shape), kw["grid_shape"])
        else:
            res = kw.get("residual")
            kind = ("none" if res is None else
                    f"1x1<-{res.shape[3]}" if kw.get("res_w") is not None
                    else "plain")
            key = (name, tuple(a[0].shape[3:]), tuple(a[1].shape),
                   kw["tile_shape"], int(a[2].shape[0]), kind,
                   kw.get("skip_c", 0))
        # the into-conv writes its dest in place: keep dest as it came
        kept = {**kw, "dest": kw["dest"].clone()} if "dest" in kw else kw
        r = records.setdefault(key, {"name": name, "args": a, "kw": kept,
                                     "count": 0})
        r["count"] += 1
        return f(*a, **kw)
    return rec


def record_calls(pipe, sep, args, rows, sep_args):
    """{config: record} of every kernel call one scene's passes make: the
    joint path, the separate path's prefolded stem (its other calls have
    the joint path's configurations), the non-lazy tail's splat and the
    joint path's variant routes (the into-convs and the windowed splat)."""
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as hv

    records = {}
    with patched(du, **{n: recorder(records, du, n) for n in
                        ("tiled_conv3d", "tiled_down2", "tiled_up2")}), \
            patched(hv, hv_splat=recorder(records, hv, "hv_splat")):
        pipe.backbone(args)
        pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    with variants(pipe), \
            patched(du, tiled_up2_into=recorder(records, du, "tiled_up2_into")), \
            patched(hv, hv_splat_windowed=recorder(records, hv,
                                                   "hv_splat_windowed")):
        pipe.backbone(args)
        pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    with patched(du, tiled_conv3d_prefolded=recorder(
            records, du, "tiled_conv3d_prefolded")):
        sep.backbones(sep_args)
    pipe.lazy_rot_scale = False
    try:
        with patched(hv, hv_splat6=recorder(records, hv, "hv_splat6")):
            pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    finally:
        pipe.lazy_rot_scale = True
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
    if name in ("tiled_up2", "tiled_up2_into"):  # one parent tap a fine cell
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
    fused 1x1 at occupied cells. The into-conv writes its conv channels
    only: the skip copy into its dest is not charged."""
    a, kw, name = r["args"], r["kw"], r["name"]
    x, w = a[0], a[1]
    rows, live, pairs = occupied_work(r, occ_of)
    _, cin, cout = w.shape
    el = x.element_size()
    in_rows = {"tiled_down2": rows * 8, "tiled_up2": rows // 8,
               "tiled_up2_into": rows // 8}.get(name, rows)
    skip_c = kw.get("skip_c", 0) if name == "tiled_up2" else 0
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


def prefold_bound(r):
    """(bound_ms, bound_by): the listed cells' x windows of the fold read
    once at its k*k*Cin channels (the port's padding channels are not
    charged), outputs, weights and occupancy moved once; against the bf16
    MACs of the occupied (output, x-tap) pairs, an x tap being occupied when
    its folded cell holds an occupied (dy, dz) neighbour."""
    import torch
    import torch.nn.functional as F

    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    (xf, w, tiles), kw = r["args"][:3], r["kw"]
    k = kw["kernel_size"]
    cells = tc._row_cells(tiles, kw["tile_shape"])
    occ = kw["occ"]
    live = occ.reshape(-1)[tc._flat(cells, occ.shape)] > 0
    occ_fold = F.max_pool3d(occ[None, None].float(), (1, k, k), stride=1,
                            padding=(0, k // 2, k // 2))[0, 0].reshape(-1)
    taps = [tc._flat(cells + torch.tensor([dx - k // 2, 0, 0],
                                          device=cells.device), xf.shape)
            for dx in range(k)]
    window = torch.unique(torch.cat(taps))
    pairs = sum(int((live & (occ_fold[t] > 0)).sum()) for t in taps)
    el = xf.element_size()
    cin, cout = k * k * w.shape[1], w.shape[2]
    nbytes = (window.numel() * cin + cells.shape[0] * cout) * el \
        + w.numel() * el + cells.shape[0] * 4
    flops = 2 * pairs * cin * cout
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), \
        {"listed_cells": int(cells.shape[0]), "occupied_cells": int(live.sum()),
         "window_cells": int(window.numel()), "occupied_pairs": pairs}


def splat_bound(r, channels=1):
    """Point rows in, grid out (channels wide); f32 ops per vote: ~12 to
    place it, ~32 more per channel to weight its 8 corners when it lands in
    range."""
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
    nbytes = points.shape[0] * 11 * 4 + gx * gy * gz * channels * 4
    flops = votes * 12 + in_range * 32 * channels
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), in_range


def library_call(r):
    """One PyTorch call computing the same (unmasked, whole-grid) function,
    used only as a yardstick here."""
    import torch.nn.functional as F

    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    name, a = r["name"], r["args"]
    if name.startswith("hv_splat"):
        return None
    x, w = a[0], a[1]
    xs = x.permute(3, 0, 1, 2)[None].contiguous()
    if name == "tiled_conv3d_prefolded":  # the (5, 1, 1) conv over the fold
        k = r["kw"]["kernel_size"]
        wf = tc.fold_stem_weights(w.to(x.dtype), k, x.shape[3])
        wc = wf.permute(2, 1, 0)[..., None, None].contiguous()
        return lambda: F.conv3d(xs, wc, padding=(k // 2, 0, 0))
    if name in ("tiled_up2", "tiled_up2_into"):
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


def fresh(kw):
    """kw with a copy of the into-conv's dest, which it writes in place."""
    return {**kw, "dest": kw["dest"].clone()} if "dest" in kw else kw


def block_bound(x, w1, w2, tiles, ts, occ, res_w):
    """(bound_ms, bound_by) of one BasicBlock: the listed cells' input and
    output, both weights (and the 1x1 downsample's) and occupancy moved
    once, no mid (every occupied cell lies in a listed tile, so the halo
    around them holds zeros the block need not read); against the bf16
    MACs of the occupied (output, tap) pairs of both convs (the mid is
    masked by the same occupancy as the input), plus the 1x1 at occupied
    cells."""
    import torch

    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    cells = tc._row_cells(tiles, ts)
    occf = occ.reshape(-1)
    live = occf[tc._flat(cells, occ.shape)] > 0
    pairs = 0
    for t in range(27):
        d = torch.tensor([t % 3 - 1, (t // 3) % 3 - 1, t // 9 - 1], device=cells.device)
        pairs += int((live & (occf[tc._flat(cells + d, occ.shape)] > 0)).sum())
    cin, mid, cout = w1.shape[1], w1.shape[2], w2.shape[2]
    el, rows, n_live = x.element_size(), cells.shape[0], int(live.sum())
    weights = w1.numel() + w2.numel() + (0 if res_w is None else res_w.numel())
    nbytes = (rows * (cin + cout) + weights) * el + rows * 4
    flops = 2 * pairs * (cin * mid + mid * cout)
    if res_w is not None:
        flops += 2 * n_live * cin * cout
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), \
        {"listed_cells": rows, "occupied_cells": n_live, "occupied_pairs": pairs}


def phase1_blocks(pipe, args, s, failures):
    """tiled_block3d, which no path runs, on the recorded input of each of
    the default joint pass's 23 BasicBlocks: against its plain version and
    against the two-conv output of that block, each within 1% of the
    output's largest magnitude; timed beside the two convs."""
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    blocks, two_conv = [], du.BasicBlock.forward

    def rec(blk, x, occ, tiles, ts, in_perm=None):
        out = two_conv(blk, x, occ, tiles, ts, in_perm)
        blocks.append((blk, x, occ, tiles, ts, out))
        return out

    with patched(du.BasicBlock, forward=rec):
        pipe.backbone(args)

    def block_call(blk, x, occ, tiles, ts):
        a1, b1 = blk.norm1.affine()
        a2, b2 = blk.norm2.affine()
        kw = dict(tile_shape=ts, scale1=a1, bias1=b1, scale2=a2, bias2=b2,
                  occ=occ)
        if blk.downsample:
            rs, rb = blk.downsample_norm.affine()
            kw.update(res_w=blk.downsample_conv.kernel[0], res_scale=rs,
                      res_bias=rb)
        return (x, blk.conv1.kernel, blk.conv2.kernel, tiles), kw

    # the checking calls alone, counted by the wrapper before any timing
    torch.cuda.synchronize()
    reset_counters()
    errs = []
    for i, (blk, x, occ, tiles, ts, out) in enumerate(blocks):
        a, kw = block_call(blk, x, occ, tiles, ts)
        got = tc.tiled_block3d(*a, **kw)
        err, scale = rel_err(got, tc.tiled_block3d_plain(*a, **kw))
        err2, scale2 = rel_err(got, out)
        del got
        tol, tol2 = CONV_REL_TOL * scale, CONV_REL_TOL * scale2
        if not (err <= tol and err2 <= tol2):
            failures.append(("tiled_block3d", i, err, tol, err2, tol2))
        errs.append((err, scale, tol, err2, tol2))
    s["launches"] = tc.tiled_block3d.launches
    s["library_ms"] = None
    s["two_conv_ms"] = 0.0
    for i, (blk, x, occ, tiles, ts, out) in enumerate(blocks):
        a, kw = block_call(blk, x, occ, tiles, ts)
        err, scale, tol, err2, tol2 = errs[i]
        ms = time_ms(lambda: tc.tiled_block3d(*a, **kw), 5)
        plain_ms = time_ms(lambda: tc.tiled_block3d_plain(*a, **kw), 2)
        two_ms = time_ms(lambda: two_conv(blk, x, occ, tiles, ts), 5)
        (bound_ms, bound_by), work = block_bound(x, a[1], a[2], tiles, ts, occ,
                                                 kw.get("res_w"))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["two_conv_ms"] += two_ms
        s["bound_ms"] += bound_ms
        s[bound_by] += bound_ms
        emit({"phase": 1, "kernel": "tiled_block3d", "block": i,
              "config": [str(tuple(x.shape[3:])), str(tuple(a[1].shape)),
                         str(tuple(a[2].shape)), str(ts), str(int(tiles.shape[0])),
                         "1x1" if blk.downsample else "identity"],
              "max_abs_err": err, "ref_max": scale, "tol": tol,
              "two_conv_max_abs_err": err2, "two_conv_tol": tol2,
              "kernel_ms": ms, "plain_ms": plain_ms, "two_conv_ms": two_ms,
              "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
              **work})
    blocks.clear()


# the kernels whose rows are compacted to the occupied ones: their outputs
# must not depend on the row order the compaction's atomics give
ROW_KERNELS = ("tiled_conv3d", "tiled_up2")
# the wrappers that zero-fill a fresh output grid
FILLED = ("tiled_conv3d", "tiled_conv3d_prefolded", "tiled_down2", "tiled_up2")


def fill_call(r):
    """The zero fill of the output grid that the wrapper allocates."""
    import torch

    name, (x, w), kw = r["name"], r["args"][:2], r["kw"]
    cout = w.shape[2]
    if name == "tiled_down2":
        shape = tuple(kw["occ"].shape) + (cout,)
    elif name == "tiled_up2":
        shape = tuple(kw["occ"].shape) + (cout + kw.get("skip_c", 0),)
    else:
        shape = tuple(x.shape[:3]) + (cout,)
    return lambda: torch.zeros(shape, dtype=x.dtype, device=x.device)


def unmasked_inputs(r):
    """(args, kw) of a recorded call with random inputs that are non-zero
    at unoccupied cells too: x, and the plain residual or the skip. The
    model's own inputs are zero there, so they cannot show a compaction
    that drops the rows whose output is the residual alone."""
    import torch

    a, kw = r["args"], dict(r["kw"])
    g = torch.Generator(device=a[0].device).manual_seed(1)

    def rand_like(t):
        return torch.randn(t.shape, generator=g, device=t.device).to(t.dtype)

    for key in ("residual", "skip"):
        if kw.get(key) is not None:
            kw[key] = rand_like(kw[key])
    return (rand_like(a[0]),) + tuple(a[1:]), kw


def unmasked_checks(records, kern, plain, levels, failures):
    """One L0 and one L1 configuration of each occupied-row kernel (the
    conv with a plain residual) on unmasked random inputs, against the
    plain version, and a repeated call bitwise equal."""
    import torch

    done = set()
    for key, r in records.items():
        name = r["name"]
        lvl = levels.get(tuple(r["kw"]["occ"].shape)) if name in ROW_KERNELS else None
        if lvl not in (0, 1) or (name, lvl) in done:
            continue
        if name == "tiled_conv3d" and (r["kw"].get("residual") is None
                                       or r["kw"].get("res_w") is not None):
            continue
        done.add((name, lvl))
        a, kw = unmasked_inputs(r)
        got, again = kern[name](*a, **kw), kern[name](*a, **kw)
        want = plain[name](*a, **kw)
        err, scale = rel_err(got, want)
        bitwise = bool(torch.equal(got, again))
        if not (err <= CONV_REL_TOL * scale and bitwise):
            failures.append((key, "unmasked inputs", err, CONV_REL_TOL * scale, bitwise))
        emit({"phase": 1, "kernel": name, "check": "unmasked_inputs", "level": lvl,
              "config": [str(v) for v in key[1:]], "max_abs_err": err,
              "ref_max": scale, "tol": CONV_REL_TOL * scale,
              "bitwise_repeat": bitwise})
        del got, again, want, a, kw
    if len(done) != 2 * len(ROW_KERNELS):
        failures.append(("unmasked inputs: checked only", sorted(done)))


def phase1(pipe, scene):
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    plain = {"tiled_conv3d": tc.tiled_conv3d_plain,
             "tiled_conv3d_prefolded": tc.tiled_conv3d_prefolded_plain,
             "tiled_down2": tc.tiled_down2_plain,
             "tiled_up2": tc.tiled_up2_plain, "hv_splat": hs.hv_splat_plain,
             "hv_splat6": functools.partial(hs.hv_splat_plain, channels=6),
             "tiled_up2_into": tc.tiled_up2_into_plain,
             "hv_splat_windowed": hs.hv_splat_windowed_plain}
    kern = counters()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    # the separate path's stem calls; the pipeline is dropped with the
    # records, so that phase 2 holds the joint path's memory alone
    sep = build_separate()
    records = record_calls(pipe, sep, args, planted_rows(scene, args),
                           sep.prepare_quantized(*quantize(scene)))
    del sep
    occ_of = {tuple(r["kw"]["occ"].shape): r["kw"]["occ"]
              for r in records.values() if r["name"] == "tiled_conv3d"}
    # level of each occupancy grid: L0 is the largest
    levels = {shape: i for i, shape in enumerate(sorted(
        occ_of, key=lambda sh: -sh[0] * sh[1] * sh[2]))}
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                   "operations": 0.0,
                   "fill_ms": 0.0 if n in FILLED else None} for n in kern}
    failures = []
    for key, r in records.items():
        name, a, kw = r["name"], r["args"], r["kw"]
        got, want = kern[name](*a, **fresh(kw)), plain[name](*a, **fresh(kw))
        extra = {}
        if name in ROW_KERNELS:
            extra["level"] = levels[tuple(kw["occ"].shape)]
            extra["bitwise_repeat"] = bool(torch.equal(got, kern[name](*a, **kw)))
            if not extra["bitwise_repeat"]:
                failures.append((key, "a repeated call differs"))
        if name == "hv_splat_windowed":
            extra["bitwise_equal_hv_splat"] = bool(torch.equal(got, hs.hv_splat(
                *a, **{k: v for k, v in kw.items() if k != "x_bucket"})))
            if not extra["bitwise_equal_hv_splat"]:
                failures.append((key, "not bitwise equal to hv_splat"))
        if name == "hv_splat6":  # each channel within 1e-4 of its own peak
            errs = [rel_err(got[..., c], want[..., c]) for c in range(6)]
            err, scale = max(e for e, _ in errs), max(m for _, m in errs)
            tol = SPLAT_REL_TOL * scale
            extra["channels"] = [{"max_abs_err": e, "ref_max": m,
                                  "tol": SPLAT_REL_TOL * m} for e, m in errs]
            if not all(e <= SPLAT_REL_TOL * m for e, m in errs):
                failures.append((key, errs))
        else:
            err, scale = rel_err(got, want)
            tol = (SPLAT_REL_TOL if name.startswith("hv_splat")
                   else CONV_REL_TOL) * scale
            if not err <= tol:
                failures.append((key, err, tol))
        del got, want
        # the into-conv rewrites the same values into its dest on each call
        kw_k, kw_p = fresh(kw), fresh(kw)
        ms = time_ms(lambda: kern[name](*a, **kw_k), 5)
        plain_ms = time_ms(lambda: plain[name](*a, **kw_p), 2)
        del kw_k, kw_p
        if name == "tiled_up2_into":  # the skip copy that builds its dest
            skc = kw["skip_c"]
            skip = kw["dest"][..., :skc].contiguous()
            extra["dest_copy_ms"] = time_ms(lambda: du.into_dest(
                skip, skc, a[1].shape[2]), 5)
            del skip
        fill_ms = time_ms(fill_call(r), 5) if name in FILLED else None
        lib = library_call(r)
        lib_ms = time_ms(lib, 3) if lib is not None else None
        if name.startswith("hv_splat"):
            (bound_ms, bound_by), extra["in_range_votes"] = splat_bound(
                r, 6 if name == "hv_splat6" else 1)
        elif name == "tiled_conv3d_prefolded":
            (bound_ms, bound_by), work = prefold_bound(r)
            extra.update(work)
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
        if fill_ms is not None:
            s["fill_ms"] += fill_ms * n
        emit({"phase": 1, "kernel": name, "config": [str(v) for v in key[1:]],
              "per_scene": n, "max_abs_err": err, "ref_max": scale,
              "tol": tol, "kernel_ms": ms, "fill_ms": fill_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, **extra})
    unmasked_checks(records, kern, plain, levels, failures)
    records.clear()
    occ_of.clear()
    torch.cuda.empty_cache()
    phase1_blocks(pipe, args, summary["tiled_block3d"], failures)
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
        clipped_grid_dims, compute_corners, hough_voting_obj,
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
    dims = clipped_grid_dims(corners, RES, args.grid_shape)
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
    reset_counters()
    t0 = time.perf_counter()
    n_boxes = []
    for a, r in zip(prepped, planted):
        out, res, dets = run_planted(pipe, a, r)
        n_boxes.append(int(res["n_boxes"]))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
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


# ---------------------------------------------------------------------------
# the separate path

def separate_stage_times(sep, args, rows):
    """Per-stage ms of one separate scene, synchronizing between stages."""
    import torch

    from canonicalvoting_tpu_torch.models.dense_unet import shared_scene_grids
    from canonicalvoting_tpu_torch.ops.tiled_conv import fold_dydz

    t = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return v

    # the scatter grid and occupancy pyramid, then the stem's fold on its own
    m = sep.plan
    shared = stage("shared_prep", lambda: shared_scene_grids(
        args.feats, args.flat, args.valid, args.dense_dims,
        in_channels=m.in_channels, compute_dtype=m.compute_dtype))
    shared["x_folded"] = stage("stem_fold", lambda: fold_dydz(
        shared["x"], m.stem_kernel))
    stage("backbones", lambda: sep.backbones(args, shared))
    del shared
    heads = torch.as_tensor(rows, device=args.valid.device)
    votes = stage("splats", lambda: sep.vote(heads, args))
    out = stage("batched_peel", lambda: sep.peel_votes(votes, args))
    stage("nms", lambda: sep.postprocess(out))
    return t


def phase_separate(sep, scenes):
    """Two scenes through the 9-category evaluator: exact launch counts,
    each planted category finds its box and no other category finds one,
    then one scene with two categories on the plain versions."""
    import numpy as np
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as hv
    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    scenes = scenes[:N_SEPARATE_SCENES]
    C = len(sep.categories)
    prepped = [sep.prepare_quantized(*quantize(s)) for s in scenes]
    planted = [separate_rows(s, a, C) for s, a in zip(scenes, prepped)]
    for a, r in zip(prepped, planted):  # warm-up
        sep.postprocess(sep.run_scene(a, planted=r))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    outs = [sep.run_scene(a, planted=r) for a, r in zip(prepped, planted)]
    dets = [sep.postprocess(o) for o in outs]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    stages = [separate_stage_times(sep, a, r) for a, r in zip(prepped, planted)]
    n_boxes = [o["n_boxes"].tolist() for o in outs]
    want = [[sum(b.class_idx == c for b in s.boxes) for c in range(C)]
            for s in scenes]
    emit({"phase": "separate", "scenes": len(scenes), "categories": C,
          "scenes_per_s": len(scenes) / elapsed, "n_boxes": n_boxes,
          "planted_boxes": want, "detections": [len(d) for d in dets],
          "launches": launches,
          "stage_ms": {k: float(np.median([s[k] for s in stages]))
                       for k in stages[0]},
          "peak_mem_gib": peak / 2 ** 30})
    for n, per in SEPARATE_PER_SCENE.items():
        assert launches[n] == per * len(scenes), (n, launches[n])
    for got, exp in zip(n_boxes, want):
        for c in range(C):
            assert (got[c] >= 1) if exp[c] else (got[c] == 0), (n_boxes, want)

    # one scene, two categories, on the plain versions
    sep2 = build_separate(categories=sep.categories[:2])
    a, r = prepped[0], planted[0][:2]
    heads_k = sep2.backbones(a)
    out_k = sep2.tail(torch.as_tensor(r, device=heads_k.device), a)
    with patched(du, tiled_conv3d=tc.tiled_conv3d_plain,
                 tiled_conv3d_prefolded=tc.tiled_conv3d_prefolded_plain,
                 tiled_down2=tc.tiled_down2_plain,
                 tiled_up2=tc.tiled_up2_plain), \
            patched(hv, hv_splat=hs.hv_splat_plain):
        heads_p = sep2.backbones(a)
        out_p = sep2.tail(torch.as_tensor(r, device=heads_p.device), a)
    torch.cuda.synchronize()
    n_k, n_p = out_k["n_boxes"].tolist(), out_p["n_boxes"].tolist()
    head_err = float((heads_k - heads_p).abs().max())
    head_max = float(heads_p.abs().max())
    box_err = max([float((out_k["boxes"][c, :n] - out_p["boxes"][c, :n])
                         .abs().max()) for c, n in enumerate(n_k) if n] + [0.0])
    emit({"phase": "separate_plain", "categories": 2, "n_boxes": [n_k, n_p],
          "head_rows_max_abs_err": head_err, "head_rows_max": head_max,
          "head_rows_tol": HEAD_REL_TOL * head_max, "box_max_abs_err": box_err})
    assert n_k == n_p and sum(n_k) >= 1, "box counts differ"
    assert torch.equal(out_k["classes"], out_p["classes"]), "classes differ"
    assert box_err <= RES + 1e-4, f"boxes differ by {box_err}"
    assert head_err <= HEAD_REL_TOL * head_max, \
        f"head rows differ by {head_err} (limit {HEAD_REL_TOL * head_max})"
    return launches


def phase_stem(sep, scenes):
    """The prefolded stem against the tiled k=5 stem, end to end: the
    scene's shared grids (with the fold, or without) and the nine backbones,
    ms per scene, alternated on each scene; their head rows agree as phase
    3's do."""
    import numpy as np
    import torch

    def backbones_ms(s, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        heads = s.backbones(a)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, heads

    sep_t = build_separate(stem_impl="tiled")
    prepped = [sep.prepare_quantized(*quantize(s))
               for s in scenes[:N_SEPARATE_SCENES]]
    sep_t.backbones(prepped[0])  # warm-up
    ms, heads = {"prefold": [], "tiled": []}, {}
    for a in prepped:
        for name, s in (("prefold", sep), ("tiled", sep_t)):
            t, heads[name] = backbones_ms(s, a)
            ms[name].append(t)
    head_err = float((heads["prefold"] - heads["tiled"]).abs().max())
    head_max = float(heads["tiled"].abs().max())
    emit({"phase": "stem", "shared_prep_and_backbones_ms": ms,
          "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
          "head_rows_max_abs_err": head_err, "head_rows_max": head_max,
          "head_rows_tol": HEAD_REL_TOL * head_max})
    assert head_err <= HEAD_REL_TOL * head_max, \
        f"stems' head rows differ by {head_err} (limit {HEAD_REL_TOL * head_max})"


def phase_nonlazy(pipe, sep, scene):
    """The non-lazy tail (the 6-channel splat and the dense rot/scale
    grids) against the lazy one, in the joint path and in the separate
    evaluator, and the separate evaluator with group_size=2 against
    group_size=1, on one scene each. Returns the two non-lazy runs'
    launches, each counted from 0."""
    import torch

    args = pipe.prepare_scene(scene.points, scene.rgb)
    rows = planted_rows(scene, args)
    _, lazy, _ = run_planted(pipe, args, rows)
    pipe.lazy_rot_scale = False
    try:
        reset_counters()
        _, full, _ = run_planted(pipe, args, rows)
        torch.cuda.synchronize()
        launches = read_counters()
    finally:
        pipe.lazy_rot_scale = True
    n = int(lazy["n_boxes"])
    box_err = float((full["boxes"][:n] - lazy["boxes"][:n]).abs().max()) \
        if n else 0.0

    sargs = sep.prepare_quantized(*quantize(scene))
    srows = separate_rows(scene, sargs, len(sep.categories))
    out1 = sep.run_scene(sargs, planted=srows)
    sep.lazy_rot_scale = False
    try:
        reset_counters()
        sfull = sep.run_scene(sargs, planted=srows)
        torch.cuda.synchronize()
        sep_launches = read_counters()
    finally:
        sep.lazy_rot_scale = True
    sn = out1["n_boxes"].tolist()
    sbox_err = max([float((sfull["boxes"][c, :m] - out1["boxes"][c, :m])
                          .abs().max()) for c, m in enumerate(sn) if m] + [0.0])

    sep2 = build_separate(group_size=2)
    heads1, heads2 = sep.backbones(sargs), sep2.backbones(sargs)
    out2 = sep2.run_scene(sargs, planted=srows)
    dets1, dets2 = sep.postprocess(out1), sep2.postprocess(out2)
    head_err = float((heads2 - heads1).abs().max())
    head_max = float(heads1.abs().max())
    emit({"phase": "nonlazy", "n_boxes": [n, int(full["n_boxes"])],
          "box_max_abs_err": box_err, "launches": launches,
          "separate": {"n_boxes": [sn, sfull["n_boxes"].tolist()],
                       "box_max_abs_err": sbox_err,
                       "launches": sep_launches},
          "grouped": {"n_boxes": [out1["n_boxes"].tolist(),
                                  out2["n_boxes"].tolist()],
                      "detections": [len(dets1), len(dets2)],
                      "head_rows_max_abs_err": head_err,
                      "head_rows_max": head_max}})
    assert launches["hv_splat6"] == 1 and launches["hv_splat"] == 0, launches
    assert n >= 4 and int(full["n_boxes"]) == n, "box counts differ"
    assert torch.equal(full["classes"][:n], lazy["classes"][:n]), "classes differ"
    assert box_err <= RES + 1e-4, f"boxes differ by {box_err}"
    C = len(sep.categories)
    assert sep_launches["hv_splat6"] == C and sep_launches["hv_splat"] == 0, \
        sep_launches
    assert sfull["n_boxes"].tolist() == sn and sum(sn) >= 1, \
        "separate non-lazy box counts differ"
    assert torch.equal(sfull["classes"], out1["classes"]), \
        "separate non-lazy classes differ"
    assert sbox_err <= RES + 1e-4, f"separate non-lazy boxes differ by {sbox_err}"
    assert torch.equal(out1["n_boxes"], out2["n_boxes"]), "grouped box counts differ"
    assert torch.equal(out1["boxes"], out2["boxes"]), "grouped boxes differ"
    assert [(c, float(s)) for c, _, s in dets1] == \
        [(c, float(s)) for c, _, s in dets2], "grouped detections differ"
    assert head_err <= HEAD_REL_TOL * head_max, \
        f"grouped head rows differ by {head_err} (limit {HEAD_REL_TOL * head_max})"
    return {k: launches[k] + sep_launches[k] for k in launches}


def splat_ms(pipe, args, rows, method):
    """(ms, grid) of the joint tail's objectness splat through ``method``,
    synchronized on both sides."""
    import torch

    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        compute_corners, hough_voting_obj)

    xyz, scale, _, prob = slice_joint_heads(rows)
    scale = torch.exp(scale)
    corners = compute_corners(args.coords_w, args.valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go = hough_voting_obj(args.coords_w, xyz, scale, prob, res=RES,
                          num_rots=NUM_ROTS, grid_shape=args.grid_shape,
                          corners=corners, valid=args.valid, method=method)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, go


def phase_variants(pipe, sep, scenes):
    """The joint path on the opt-in routes, up_impl="into" and
    hv_method="pallas_windowed", over the three scenes: exact launch
    counts, >= 4 planted boxes a scene, the default routes' box counts,
    classes and boxes (within one vote cell) and head rows (within 1% of
    their largest magnitude); backbone and splat timed both ways,
    alternated scene by scene; then one separate scene with both variants
    finds the default's detections. Returns the joint run's launches."""
    import numpy as np
    import torch

    prepped = [pipe.prepare_scene(s.points, s.rgb) for s in scenes]
    planted = [planted_rows(s, a) for s, a in zip(scenes, prepped)]
    default = [run_planted(pipe, a, r)[:2] for a, r in zip(prepped, planted)]
    with variants(pipe):
        for a, r in zip(prepped, planted):  # warm-up
            run_planted(pipe, a, r)
        torch.cuda.synchronize()
        reset_counters()
        runs = [run_planted(pipe, a, r)[:2] for a, r in zip(prepped, planted)]
        torch.cuda.synchronize()
        launches = read_counters()
    n_boxes, box_err, head_err, head_tol, bitwise = [], 0.0, [], [], []
    for (out_d, res_d), (out_v, res_v) in zip(default, runs):
        n = int(res_v["n_boxes"])
        n_boxes.append([int(res_d["n_boxes"]), n])
        assert n >= 4 and n == int(res_d["n_boxes"]), n_boxes
        assert torch.equal(res_v["classes"][:n], res_d["classes"][:n]), "classes differ"
        box_err = max(box_err, float((res_v["boxes"][:n] - res_d["boxes"][:n])
                                     .abs().max()))
        head_err.append(float((out_v - out_d).abs().max()))
        head_tol.append(HEAD_REL_TOL * float(out_d.abs().max()))
    ms = {"backbone_concat": [], "backbone_into": [], "splat_plane": [],
          "splat_windowed": []}
    for a, r in zip(prepped, planted):
        for up in ("concat", "into"):
            with variants(pipe, up_impl=up):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.backbone(a)
                torch.cuda.synchronize()
                ms[f"backbone_{up}"].append((time.perf_counter() - t0) * 1e3)
        t_p, go_p = splat_ms(pipe, a, r, "auto")
        t_w, go_w = splat_ms(pipe, a, r, "pallas_windowed")
        ms["splat_plane"].append(t_p)
        ms["splat_windowed"].append(t_w)
        bitwise.append(bool(torch.equal(go_p, go_w)))
        del go_p, go_w

    # one separate scene, both variants, against the default evaluator
    sepv = build_separate(up_impl="into", hv_method="pallas_windowed")
    sargs = sep.prepare_quantized(*quantize(scenes[0]))
    srows = separate_rows(scenes[0], sargs, len(sep.categories))
    out_d, out_v = sep.run_scene(sargs, planted=srows), sepv.run_scene(
        sargs, planted=srows)
    dets_d, dets_v = sep.postprocess(out_d), sepv.postprocess(out_v)
    sn = out_d["n_boxes"].tolist()
    sbox_err = max([float((out_v["boxes"][c, :m] - out_d["boxes"][c, :m])
                          .abs().max()) for c, m in enumerate(sn) if m] + [0.0])
    del sepv
    torch.cuda.empty_cache()
    emit({"phase": "variants", "scenes": len(scenes), "launches": launches,
          "n_boxes": n_boxes, "box_max_abs_err": box_err,
          "head_rows_max_abs_err": head_err, "head_rows_tol": head_tol,
          "splat_bitwise_equal": bitwise, "ms": ms,
          "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
          "separate": {"n_boxes": [sn, out_v["n_boxes"].tolist()],
                       "detections": [len(dets_d), len(dets_v)],
                       "box_max_abs_err": sbox_err}})
    for n, per in VARIANT_PER_SCENE.items():
        assert launches[n] == per * len(scenes), (n, launches[n])
    assert all(bitwise), f"windowed splat not bitwise equal to hv_splat: {bitwise}"
    assert box_err <= RES + 1e-4, f"variant boxes differ by {box_err}"
    assert all(e <= t for e, t in zip(head_err, head_tol)), \
        f"variant head rows differ by {head_err} (limits {head_tol})"
    assert out_v["n_boxes"].tolist() == sn and sum(sn) >= 1, \
        "separate variant box counts differ"
    assert sbox_err <= RES + 1e-4, f"separate variant boxes differ by {sbox_err}"
    assert [c for c, _, _ in dets_v] == [c for c, _, _ in dets_d], \
        "separate variant detections differ"
    return launches


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
    # built on first use, after the joint phases, so that phase 2 measures
    # the joint path alone
    sep = functools.cache(build_separate)
    done = {}
    phases = (("phase1", lambda: phase1(pipe, scenes[0])),
              ("phase2", lambda: phase2(pipe, scenes)),
              ("phase3", lambda: phase3(pipe, *done["phase2"][1:])),
              ("separate", lambda: phase_separate(sep(), scenes)),
              ("stem", lambda: phase_stem(sep(), scenes)),
              ("nonlazy", lambda: phase_nonlazy(pipe, sep(), scenes[0])),
              ("variants", lambda: phase_variants(pipe, sep(), scenes)))
    for name, run in phases:
        try:
            done[name] = run()
        except Exception as e:  # reported; the run then exits 1
            failed.append(name)
            print(f"chip_smoke: {name} FAILED: {e!r}", file=sys.stderr)
    emit({"total_s": time.perf_counter() - t_start, "failed": failed})
    if failed:
        return 1
    # launches: the sum over the runs of the four paths (phase 2, the
    # separate phase, the non-lazy phase, the variants phase), each counted
    # from 0; the fused block, which no path runs, counts phase 1's checks
    summary = done["phase1"]
    launches = {n: done["phase2"][0][n] + done["separate"][n]
                + done["nonlazy"][n] + done["variants"][n] for n in SOURCES}
    launches["tiled_block3d"] = summary["tiled_block3d"]["launches"]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        "fill_ms": s["fill_ms"]})
        if name == "tiled_block3d":
            kernels[-1]["launches_from"] = (
                "phase 1: one check a BasicBlock of a joint pass; no path "
                "runs the fused block")
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
