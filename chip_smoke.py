"""Drive the PyTorch port (canonicalvoting_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 builds the CUDA kernels from csrc/ and names the card.
Phase 1 runs every kernel at every configuration the paths give it
(recorded from a pass on a ScanNet-scale synthetic scene, in bfloat16: the
joint path, the separate path's prefolded stem and its objectness splat
over the nine categories, the non-lazy tails' 6-channel splats, joint and
over the nine categories, the joint path's variant routes: the into-convs
of up_impl="into" and the windowed splat of hv_method="pallas_windowed"),
holds it against its plain PyTorch version, and times kernel, plain
version, the library call computing the same function where there is one,
the zero fill of the output grid (or the splat's scratch) inside the
wrapper, the host's time to issue one call, the card's time for one call
with the host ahead of it (back-to-back calls read the larger of the two),
and the card's bound for the work (the prefolded stem is held against a
fold of the stem kernel of the plain version's own, not the kernel's
K-major weights; each splat channel or category within 1e-4 of its own
peak, each channel of the 6-channel call over the categories within 1e-4
of its own peak plus 16 steps of the 2^-32 fixed point). The occupied-row
kernels (tiled_conv3d, the prefolded stem, tiled_down2, tiled_up2,
tiled_up2_into) must also give bitwise-equal outputs on a repeated call,
and equal their plain versions on random inputs that are non-zero at
unoccupied cells too (x or the fold, a plain residual, the skip, the
into-conv's dest with junk in its conv channels) at one L0 and one L1
configuration (the stem: L0; the down: each of L1-L4; the stem, the down
and the into-conv with exact zeros at their unoccupied listed cells, the
into-conv at the children of dead coarse parents too, and keeping dest's
skip channels and unlisted cells bit for bit); their times are summed by
level. The into-conv's conv channels must equal tiled_up2's bit for bit at
both of its levels. The splats must be bitwise equal to themselves on a
repeat; the objectness splat's joint call bitwise equal to the windowed
splat, and a call over nine made-up categories to the nine single calls;
each splat's call over the separate path's nine categories bitwise equal
to its nine single calls; the windowed splat (joint, and over the separate
path's nine categories) bitwise equal to the objectness splat on the
planted head rows and on the backbones' own. Their vote kernels, scratch
fills and conversions are timed apart. One call of each of the prefolded
stem, the down and the three splats runs under
torch.cuda.set_sync_debug_mode("error"): no host sync inside. The fused
BasicBlock (tiled_block3d), which no path runs, is held on the recorded
input of each of the joint pass's 23 blocks to its plain version, to the
two-conv output bit for bit and to a repeat bit for bit, with one call a
level under the sync debug mode, and on unmasked random inputs at one L0
and one L1 block of each residual (identity: relu(x) at unoccupied listed
cells; fused 1x1: zeros); timed beside the two convs and summed by level.
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
lazy_rot_scale=False (the 6-channel splat, one call a scene in either)
against their lazy paths, with each pass's peak memory, and the separate
evaluator with group_size=2 against group_size=1.
The variants phase drives the three scenes through the joint path with
up_impl="into" and hv_method="pallas_windowed", checks the exact launch
counts and the default routes' boxes and head rows, times backbone and
splat both ways, and runs one separate scene with both variants against
the default.
The scannet phase writes the three scenes as a ScanNet + Scan2CAD data tree
(binary PLY with faces, full_annotations.json, split, segments pickle,
results_gt), holds the dataset's items bitwise against its own transform
and quantization of each PLY and the parsed ground truth against the planted
boxes (1e-5 m), then runs eval_joint.main over the three scans and
eval_separate.main over two on the card, with their default seeded weights:
exact conv launch counts, detections and backbone rows bitwise equal to the
pipelines' on the same items (the tails decode planted rows), a finite mAP
at both thresholds; host ms of the dataset's read, transform and quantize,
and each CLI loop's scenes/s.

The sparse phase builds the three scenes' coordinate pyramids with the
native manager, holds the dense backbone (bf16, kernels) and the
gather-form sparse backbone (bf16) of one state dict against the sparse
float32 backbone (the dense error at most twice the sparse one plus 1e-3
of the float32 peak; the joint model and separate category 0), then drives
the joint path (three scenes) and the separate path (two) with
backbone="sparse": planted rows with junk in their padding rows give the
dense args' detections bit for bit, and no dense-backbone kernel runs.
The sunrgbd phase runs BRNetCanonSampler (a seeded MinkUNet34C(3, 8), 60
rotations, 512 proposals) over four synthetic 20,000-point clouds with
1,024 vote seeds each: output contract, determinism under one generator
seed, frozen weights, and the 6-channel splat at its configuration against
its plain version.
The train phase holds the sparse conv's backward (the autograd Function of
ops/sparse_conv.py) on the card to its plain route at one conv per level of
the joint MinkUNet34C on scene 0's pyramid and a 1x1 (dX and dW within 1%
of each output's peak, the backward timed both ways, one call under the
sync debug mode), then times the joint train step at full width on the
three scenes (bf16, microbatch 0 and 1: step ms, host collate ms, peak
memory), holds its gradients to a float32 step's, checks that five steps
lower the loss and move the BN statistics, times the separate step (one
category, symmetry labels), and runs both training loops with process
workers on six smaller scenes: two validated epochs (the dense kernels'
launches counted), a checkpoint each, and a second call (thread workers)
that resumes.
The f32 phase runs rows 1-3, 6, 7 and 9 on float32 grids
(tpu.conv_dtype=float32): every configuration of the float32 joint path
(default and up_impl="into") and of the separate path's prefolded stem
against its plain version (1e-5 of each output's peak, TF32 off), a
bitwise repeat and exact zeros at unoccupied listed cells, timed as phase
1 times the bf16 rows (bounds at the float32 FFMA rate) and summed by
level (one by_level line, row 9 beside its two convs); the fused block at
each of the 23 BasicBlocks of a float32 joint pass, checked as phase 1
checks the bf16 one (1e-5 of the peak against its plain version, the two
float32 convs and a repeat bit for bit, launches_f32 exactly 23); the
float32 joint path and separate evaluator over the three scenes (exact
float32 launch counts, per-stage ms, scenes/s, peak memory); the float32
dense backbone
against the float32 sparse one; eval_joint and eval_separate at float32
over a ScanNet tree. The train_dense phase holds the dense training
route's float32 gradients to the gather step's (elementwise at a narrow
plan, by global relative L2 at full width), times the full-width bf16 dense step (three scenes,
microbatch 1) with and without remat beside a memory reckoning, checks a
falling loss and moving BN buffers, times a separate dense step and runs
one epoch of each loop on the dense route at float32 (validated on the
float32 kernels). The train_remat phase holds the gather step with remat
to the step without it (gradients, running statistics updated once, peak
memory) and runs one epoch of each loop with tpu.train_remat=true. The hough_backward phase holds the Hough backward on the card to
its CPU route at the joint scene's configuration, times it and checks it
for host syncs.
The parallel phase (last) runs the port's multi-device serving over
torch.distributed: on one rank of an NCCL group, the joint fan-out
(parallel/scene_parallel.py, the 6-channel tail, planted head rows) over
the three scenes bit for bit the single-process DetectionPipeline at the
run's shared shapes with the same launches, and the point-sharded vote
splat of scene 0 bit for bit hough_voting; then on two ranks that share
the card over gloo (spawned), the sharded splat of scene 0's 61,440 rows
(the int64 grid reduced through the host, its all-reduce timed), the joint
fan-out (rank 0 scenes 0 and 2, rank 1 scene 1), the separate fan-out over
two scenes and eval_joint.main fanned out over a ScanNet tree of the three
scenes: detections bit for bit the single-process pipelines' and CLI's,
the CLI's mAP, each rank's launches, scenes/s, phase timers and peak
memory. Two ranks on one card measure no speedup.

The last two lines are the kernels' summary (the nine bf16 rows, then the
six float32 rows as <name>_f32) and the status line. The script
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
# the 6-channel call over the categories adds 16 steps of the fixed point
# (2^-32 a corner weight) to each channel's limit: a point whose offset is
# 0 sums cos and sin to ~0 over its rotations, so a category with no
# planted box has cos and sin peaks near 1e-8, where a step or two of
# rounding is the whole error
FIXED_POINT_FLOOR = 16 * 2.0 ** -32
# the head rows after 47 bf16 convs on each side: 1% of their largest
# magnitude
HEAD_REL_TOL = 1e-2
# the default routes run none of the variant routes' kernels
NO_VARIANTS = {"tiled_up2_into": 0, "hv_splat_windowed": 0, "tiled_block3d": 0}
PER_SCENE = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 4,
             **NO_VARIANTS}
# one separate scene: 9 categories x (46 k=3 convs, the prefolded stem, 4
# downs, 4 ups), then one objectness splat over the 9 categories
SEPARATE_PER_SCENE = {"tiled_conv3d": 9 * 46, "tiled_conv3d_prefolded": 9,
                      "tiled_down2": 36, "tiled_up2": 36, "hv_splat": 1,
                      "hv_splat6": 0, **NO_VARIANTS}
# the categories of the batched splat check (the separate evaluator's)
SPLAT_CATEGORIES = 9
# one joint scene with up_impl="into" (the ups into L0 and L1) and
# hv_method="pallas_windowed"
VARIANT_PER_SCENE = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 2,
                     "tiled_up2_into": 2, "hv_splat_windowed": 1,
                     "hv_splat": 0, "tiled_block3d": 0}
N_SEPARATE_SCENES = 2
# the BasicBlocks of a MinkUNet34C pass (layers 2, 3, 4, 6, 2, 2, 2, 2)
N_BLOCKS = 23
# the sparse path (backbone="sparse") runs none of the dense backbone's
# kernels: one objectness splat a scene, joint or the nine categories
SPARSE_PER_SCENE = {"tiled_conv3d": 0, "tiled_conv3d_prefolded": 0,
                    "tiled_down2": 0, "tiled_up2": 0, "hv_splat": 1,
                    "hv_splat6": 0, **NO_VARIANTS}
# the dense backbone's error against the float32 sparse backbone may be at
# most SPARSE_RATIO x the bf16 sparse backbone's plus SPARSE_FLOOR of the
# float32 rows' peak (the dense CUDA wrappers take no float32 grids)
SPARSE_RATIO, SPARSE_FLOOR = 2.0, 1e-3
SPARSE_ROW_LIMIT = 0.05  # rows counted with an error above this
SPARSE_JUNK = 1e4        # the junk in planted padding rows (exp overflows)
# the SUN RGB-D sampler's batch: mmdetection3d's PointSample(num_points=
# 20000) of its SUN RGB-D configs, and VoteNet/BRNet's 1024 vote seeds
SUNRGBD_BATCH, SUNRGBD_POINTS, SUNRGBD_SEEDS = 4, 20000, 1024
# the card the sparse and sunrgbd phases run on
DEVICE = "cuda"
# wrapper: (source, the TPU kernel it replaces, the CUDA kernels it launches)
SOURCES = {
    "tiled_conv3d": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                     "canonicalvoting_tpu/ops/pallas/tiled_conv.py:444",
                     "compact_kernel, conv_rows_kernel, split_reduce_kernel, "
                     "dead_rows_kernel"),
    "tiled_conv3d_prefolded": (
        "canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
        "canonicalvoting_tpu/ops/pallas/tiled_conv.py:444 (prefolded=True)",
        "compact_kernel, conv_rows_kernel (x taps)"),
    "tiled_down2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                    "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1270",
                    "compact_kernel, conv_rows_kernel (down), "
                    "split_reduce_kernel"),
    "tiled_up2": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                  "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1609",
                  "compact_kernel, up_rows_kernel, skip_copy_kernel"),
    "hv_splat": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                 "canonicalvoting_tpu/ops/pallas/hv_splat.py:195",
                 "obj_vote_kernel, fixed_to_float_kernel"),
    "hv_splat6": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                  "canonicalvoting_tpu/ops/pallas/hv_splat.py:195 (channels=6)",
                  "vote6_kernel, fixed_to_float_kernel"),
    "tiled_up2_into": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                       "canonicalvoting_tpu/ops/pallas/tiled_conv.py:1961",
                       "compact_kernel, up_rows_kernel (into), up_dead_kernel"),
    "hv_splat_windowed": ("canonicalvoting_tpu_torch/csrc/hv_splat.cu",
                          "canonicalvoting_tpu/ops/pallas/hv_splat.py:404",
                          "windowed_vote_kernel, fixed_to_float_kernel"),
    "tiled_block3d": ("canonicalvoting_tpu_torch/csrc/tiled_conv.cu",
                      "canonicalvoting_tpu/ops/pallas/tiled_conv.py:977",
                      "compact_kernel (row map), conv_rows_kernel (conv1 into "
                      "the compact mid), conv_rows_kernel (conv2 through the "
                      "row map), split_reduce_kernel, dead_rows_kernel"),
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


@functools.cache
def sleep_cycles_per_ms() -> float:
    """torch.cuda._sleep's cycles a millisecond on this card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)  # warm-up
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int, host_ms: float) -> float:
    """The card's time for one call with the host ahead of it, as in a
    path whose queue holds earlier work: a sleep kernel holds the card
    while the host issues ``reps`` calls (``host_ms`` each), and events
    time the calls alone. ``time_ms`` of back-to-back calls reads the
    larger of this and the host's issue time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_cycles_per_ms() * (2.0 * host_ms * reps + 2.0)))
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


def build_pipeline(compute_dtype="bfloat16"):
    import torch

    from canonicalvoting_tpu_torch.data.geometry import NCLASSES
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C

    torch.manual_seed(0)
    model = DenseMinkUNet34C(3, 6 * NCLASSES + NCLASSES + 1,
                             compute_dtype=compute_dtype)
    return DetectionPipeline(model=model, res=RES, num_rots=NUM_ROTS,
                             peel=PeelConfig(res=RES, max_boxes=64, max_iters=96),
                             cap_multiple=4096, device="cuda")


def build_separate(**kw):
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.separate import (
        ALL_CATEGORIES, SeparateDetectionPipeline)
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

    model = DenseMinkUNet34C(3, 8, up_impl=kw.pop("up_impl", None),
                             compute_dtype=kw.pop("compute_dtype", "bfloat16"))
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
        if name.startswith("hv_splat"):  # points, obj (the categories), grid
            key = (name, tuple(a[0].shape), tuple(a[3].shape), kw["grid_shape"])
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


def record_calls(pipe, sep, args, rows, sep_args, sep_rows):
    """({config: record} of every kernel call one scene's passes make, the
    backbones' head rows {"joint", "separate"}): the joint path, the
    separate path's prefolded stem and its objectness splat over the
    categories, plane and windowed (its other calls have the joint path's
    configurations), the non-lazy tails' splats (joint, and over the
    separate path's categories) and the joint path's variant routes (the
    into-convs and the windowed splat)."""
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as hv

    records, heads = {}, {}
    with patched(du, **{n: recorder(records, du, n) for n in
                        ("tiled_conv3d", "tiled_down2", "tiled_up2")}), \
            patched(hv, hv_splat=recorder(records, hv, "hv_splat")):
        heads["joint"] = pipe.run_backbone(args)
        pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    with variants(pipe), \
            patched(du, tiled_up2_into=recorder(records, du, "tiled_up2_into")), \
            patched(hv, hv_splat_windowed=recorder(records, hv,
                                                   "hv_splat_windowed")):
        pipe.run_backbone(args)
        pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    with patched(du, tiled_conv3d_prefolded=recorder(
            records, du, "tiled_conv3d_prefolded")):
        heads["separate"] = sep.backbones(sep_args)
    sep_heads = torch.as_tensor(sep_rows, device=sep_args.valid.device)
    with patched(hv, hv_splat=recorder(records, hv, "hv_splat"),
                 hv_splat_windowed=recorder(records, hv, "hv_splat_windowed")):
        sep.vote(sep_heads, sep_args)
        method, sep.hv_method = sep.hv_method, "pallas_windowed"
        try:  # the separate variant's splat
            sep.vote(sep_heads, sep_args)
        finally:
            sep.hv_method = method
    pipe.lazy_rot_scale = sep.lazy_rot_scale = False
    try:
        with patched(hv, hv_splat6=recorder(records, hv, "hv_splat6")):
            pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
            sep.vote(sep_heads, sep_args)
    finally:
        pipe.lazy_rot_scale = sep.lazy_rot_scale = True
    return records, heads


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


def flops_rate(x):
    """The card's peak rate for a grid's products: bf16 on the tensor
    cores, float32 on the FFMA units (the float32 kernels take no TF32)."""
    import torch

    return BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS


def conv_bound(r, occ_of):
    """(bound_ms, bound_by): the listed cells' inputs, outputs, residual or
    skip and occupancy moved once, weights once, all at their element sizes;
    against the MACs (at the grid dtype's rate) of the occupied (output, tap) pairs, plus the
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
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_rate(x) * 1e3
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
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_rate(xf) * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), \
        {"listed_cells": int(cells.shape[0]), "occupied_cells": int(live.sum()),
         "window_cells": int(window.numel()), "occupied_pairs": pairs}


def splat_bound(r, channels=1):
    """Point rows in (points and valid once, xyz, scale and obj once a
    category), grids out (channels wide, one a category); f32 ops per vote:
    ~12 to place it, ~32 more per channel to weight its 8 corners when it
    lands in range."""
    import torch

    from canonicalvoting_tpu_torch.ops.hv_splat import rotation_table

    points, xyz, scale, obj, corner, dims, res = r["args"]
    valid = r["kw"]["valid"]
    gx, gy, gz = r["kw"]["grid_shape"]
    cosv, sinv = rotation_table(r["kw"]["num_rots"], points.device)
    corrs = (xyz * scale).reshape(-1, *points.shape)
    live = valid > 0
    in_range = 0
    for corr in corrs:
        for c, s in zip(cosv, sinv):
            u = torch.stack([points[:, 0] - c * corr[:, 0] + s * corr[:, 2],
                             points[:, 1] - corr[:, 1],
                             points[:, 2] - s * corr[:, 0] - c * corr[:, 2]], -1)
            u = (u - corner) / res
            ok = torch.all((u >= 0) & (u < dims.float() - 1), -1) & live
            in_range += int(ok.sum())
    n_cat = corrs.shape[0]
    votes = int(live.sum()) * len(cosv) * n_cat
    nbytes = (points.shape[0] * (4 + 7 * n_cat) * 4
              + n_cat * gx * gy * gz * channels * 4)
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


def splat_parts(name, got, want):
    """The parts of a splat's grid held to their own peaks: each channel of
    a 6-channel grid; each (category, channel) of a 6-channel call over
    categories, plus FIXED_POINT_FLOOR; each category of an objectness call
    over categories. None for one objectness grid."""
    if name == "hv_splat6" and got.dim() == 4:
        return "channels", [(got[..., c], want[..., c]) for c in range(6)], 0.0
    if name == "hv_splat6":
        return ("category_channels", [(got[k, ..., c], want[k, ..., c])
                                      for k in range(got.shape[0])
                                      for c in range(6)], FIXED_POINT_FLOOR)
    if got.dim() == 4:
        return "categories", list(zip(got, want)), 0.0
    return None


def part_errors(parts):
    """(label, [{max_abs_err, ref_max, tol}]) of ``splat_parts``' parts:
    each within SPLAT_REL_TOL of its own peak plus the floor."""
    label, pairs, floor = parts
    return label, [{"max_abs_err": e, "ref_max": m,
                    "tol": SPLAT_REL_TOL * m + floor}
                   for e, m in (rel_err(g, w) for g, w in pairs)]


def splat_plain_checks(phase, records):
    """Each recorded splat call against its plain version, part by part
    (``splat_parts``; one objectness grid within SPLAT_REL_TOL of its
    peak), with kernel and plain ms and the bound. Returns (the largest
    error, the failed configurations)."""
    import torch

    import canonicalvoting_tpu_torch.ops.hv_splat as hs

    kern = {"hv_splat": hs.hv_splat, "hv_splat6": hs.hv_splat6}
    plain = {"hv_splat": hs.hv_splat_plain,
             "hv_splat6": functools.partial(hs.hv_splat_plain, channels=6)}
    worst, failed = 0.0, []
    for key, r in records.items():
        name, a, kw = r["name"], r["args"], r["kw"]
        got, want = kern[name](*a, **kw), plain[name](*a, **kw)
        label, rows = part_errors(splat_parts(name, got, want)
                                  or ("grid", [(got, want)], 0.0))
        ok = all(p["max_abs_err"] <= p["tol"] for p in rows)
        (bound_ms, bound_by), in_range = splat_bound(
            r, 6 if name == "hv_splat6" else 1)
        emit({"phase": phase, "kernel": name,
              "config": [str(v) for v in key[1:]] + [str(kw["num_rots"])],
              label: rows, "ok": ok,
              "kernel_ms": time_ms(lambda: kern[name](*a, **kw), 5),
              "plain_ms": time_ms(lambda: plain[name](*a, **kw), 2),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "in_range_votes": in_range})
        worst = max([worst] + [p["max_abs_err"] for p in rows])
        if not ok:
            failed.append(key)
        del got, want
    torch.cuda.empty_cache()
    return worst, failed


def rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, float(want.float().abs().max())


def fresh(kw):
    """kw with a copy of the into-conv's dest, which it writes in place."""
    return {**kw, "dest": kw["dest"].clone()} if "dest" in kw else kw


def into_conv_rows(t, args, kw):
    """The into-conv's conv channels at its listed cells: what it computes
    (the skip channels and the unlisted cells are dest's, held apart)."""
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    flat = tc._flat(tc._row_cells(args[2], kw["tile_shape"]), t.shape)
    return t.reshape(-1, t.shape[3])[flat, kw["skip_c"]:]


def block_bound(x, w1, w2, tiles, ts, occ, res_w):
    """(bound_ms, bound_by) of one BasicBlock: the listed cells' input and
    output, both weights (and the 1x1 downsample's) and occupancy moved
    once, no mid (every occupied cell lies in a listed tile, so the halo
    around them holds zeros the block need not read); against the MACs,
    at the grid dtype's rate, of the occupied (output, tap) pairs of both
    convs (the mid is masked by the same occupancy as the input), plus the
    1x1 at occupied cells."""
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
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_rate(x) * 1e3
    return ((t_b, "bytes") if t_b >= t_f else (t_f, "operations")), \
        {"listed_cells": rows, "occupied_cells": n_live, "occupied_pairs": pairs}


def add_level(by_level, name, lvl, calls, **ms):
    """Add one configuration's times (ms a call, ``calls`` a scene) to its
    level's sums in ``by_level[name]``."""
    lv = by_level[name].setdefault(lvl, {k: 0.0 for k in ms} | {"calls": 0})
    for k, v in ms.items():
        lv[k] += (v or 0.0) * calls
    lv["calls"] += calls


def phase1_blocks(pipe, args, s, levels, by_level, failures,
                  rel_tol=CONV_REL_TOL, phase=1):
    """tiled_block3d, which no path runs, on the recorded input of each of
    the joint pass's N_BLOCKS BasicBlocks (``pipe``'s grid dtype): against
    its plain version within ``rel_tol`` of the output's largest magnitude,
    bitwise equal to the two-conv output of that block and to a repeated
    call, the dtype's launch counter exactly N_BLOCKS; one call a level
    under torch.cuda.set_sync_debug_mode("error"); at one L0 and one L1
    block of each residual (identity, fused 1x1) on unmasked random inputs
    against the plain version and the two convs (the identity residual's
    unoccupied listed cells hold relu(x), the 1x1's exact zeros); timed
    beside the two convs, each call folding its BN affines as
    ``BasicBlock.forward`` does, and summed by level into ``by_level``."""
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    blocks, two_conv = [], du.BasicBlock.forward

    def rec(blk, x, occ, tiles, ts, in_perm=None):
        out = two_conv(blk, x, occ, tiles, ts, in_perm)
        blocks.append((blk, x, occ, tiles, ts, out))
        return out

    with patched(du.BasicBlock, forward=rec):
        pipe.run_backbone(args)

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

    def bitwise(a, b):
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))

    # the checking calls alone, counted by the wrapper before any timing
    torch.cuda.synchronize()
    counter = "launches_f32" if blocks[0][1].dtype == torch.float32 else "launches"
    reset_counters()
    setattr(tc.tiled_block3d, counter, 0)
    checks = []
    for blk, x, occ, tiles, ts, out in blocks:
        a, kw = block_call(blk, x, occ, tiles, ts)
        got = tc.tiled_block3d(*a, **kw)
        checks.append((got, out))
    s["launches"] = getattr(tc.tiled_block3d, counter)
    if s["launches"] != N_BLOCKS or len(blocks) != N_BLOCKS:
        failures.append(("tiled_block3d", counter, s["launches"], len(blocks)))
    s["library_ms"] = None
    s["two_conv_ms"] = s["two_conv_device_ms"] = s["two_conv_host_ms"] = 0.0
    by_level["tiled_block3d"] = {}
    synced = set()
    for i, (blk, x, occ, tiles, ts, out) in enumerate(blocks):
        a, kw = block_call(blk, x, occ, tiles, ts)
        got = checks[i][0]
        err, scale = rel_err(got, tc.tiled_block3d_plain(*a, **kw))
        extra = {"bitwise_equal_two_conv": bitwise(got, out),
                 "bitwise_repeat": bitwise(got, tc.tiled_block3d(*a, **kw))}
        checks[i] = None
        del got
        lvl = levels[tuple(occ.shape)]
        if lvl not in synced:
            synced.add(lvl)
            extra["sync_free"], why = sync_free(lambda: tc.tiled_block3d(*a, **kw))
            if not extra["sync_free"]:
                failures.append(("tiled_block3d", i, "host sync inside the call", why))
        tol = rel_tol * scale
        if not (err <= tol and all(extra.values())):
            failures.append(("tiled_block3d", i, err, tol, extra))
        cout = a[2].shape[2]

        def routed():  # the BN folds in the call, as the two convs run them
            a_, kw_ = block_call(blk, x, occ, tiles, ts)
            return tc.tiled_block3d(*a_, **kw_)

        ms = time_ms(routed, 5)
        host = host_ms(routed, 2)
        dev_ms = device_ms(routed, 2, host)
        plain_ms = time_ms(lambda: tc.tiled_block3d_plain(*a, **kw), 2)
        fill_ms = time_ms(lambda: torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype,
                                              device=x.device), 5)
        two_ms = time_ms(lambda: two_conv(blk, x, occ, tiles, ts), 5)
        two_host = host_ms(lambda: two_conv(blk, x, occ, tiles, ts), 2)
        two_dev = device_ms(lambda: two_conv(blk, x, occ, tiles, ts), 2, two_host)
        (bound_ms, bound_by), work = block_bound(x, a[1], a[2], tiles, ts, occ,
                                                 kw.get("res_w"))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["fill_ms"] += fill_ms
        s["two_conv_ms"] += two_ms
        s["two_conv_host_ms"] += two_host
        s["two_conv_device_ms"] += two_dev
        s["host_ms"] += host
        s["device_ms"] += dev_ms
        s["bound_ms"] += bound_ms
        s[bound_by] += bound_ms
        add_level(by_level, "tiled_block3d", lvl, 1, ms=ms, device_ms=dev_ms,
                  host_ms=host, bound_ms=bound_ms, fill_ms=fill_ms,
                  two_conv_ms=two_ms, two_conv_device_ms=two_dev,
                  two_conv_host_ms=two_host)
        emit({"phase": phase, "kernel": "tiled_block3d", "block": i, "level": lvl,
              "config": [str(tuple(x.shape[3:])), str(tuple(a[1].shape)),
                         str(tuple(a[2].shape)), str(ts), str(int(tiles.shape[0])),
                         "1x1" if blk.downsample else "identity"],
              "max_abs_err": err, "ref_max": scale, "tol": tol, **extra,
              "kernel_ms": ms, "host_ms": host, "device_ms": dev_ms,
              "fill_ms": fill_ms, "plain_ms": plain_ms, "two_conv_ms": two_ms,
              "two_conv_host_ms": two_host, "two_conv_device_ms": two_dev,
              "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
              **work})
    block_unmasked_checks(blocks, levels, block_call, bitwise, failures,
                          rel_tol, phase)
    blocks.clear()


def block_unmasked_checks(blocks, levels, block_call, bitwise, failures,
                          rel_tol, phase):
    """The fused block at one L0 and one L1 block of each residual on
    random inputs that are non-zero at unoccupied cells too: within
    ``rel_tol`` of the plain version's peak, bitwise equal to the two convs
    and to a repeat; the identity residual's unoccupied listed cells hold
    relu(x) exactly, the fused 1x1's exact zeros. The model's inputs are zero
    there, so they cannot show a block that drops the dead rows."""
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    done = set()
    for i, (blk, x, occ, tiles, ts, _) in enumerate(blocks):
        lvl, kind = levels[tuple(occ.shape)], "1x1" if blk.downsample else "identity"
        if lvl not in (0, 1) or (lvl, kind) in done:
            continue
        done.add((lvl, kind))
        g = torch.Generator(device=x.device).manual_seed(1)
        xr = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
        a, kw = block_call(blk, xr, occ, tiles, ts)
        got = tc.tiled_block3d(*a, **kw)
        err, scale = rel_err(got, tc.tiled_block3d_plain(*a, **kw))
        cells = tc._row_cells(tiles, ts)
        flat = tc._flat(cells, occ.shape)
        unocc = flat[occ.reshape(-1)[flat] == 0]
        rows = got.reshape(-1, got.shape[3])[unocc]
        want = (torch.zeros_like(rows) if blk.downsample
                else torch.clamp_min(xr.reshape(-1, xr.shape[3])[unocc], 0))
        extra = {"bitwise_equal_two_conv": bitwise(
                     got, du.BasicBlock.forward(blk, xr, occ, tiles, ts)),
                 "bitwise_repeat": bitwise(got, tc.tiled_block3d(*a, **kw)),
                 "unoccupied_" + ("exact_zeros" if blk.downsample else "relu_x"):
                     bool(torch.equal(rows, want))}
        tol = rel_tol * scale
        if not (err <= tol and all(extra.values())):
            failures.append(("tiled_block3d", i, "unmasked inputs", err, tol, extra))
        emit({"phase": phase, "kernel": "tiled_block3d", "check": "unmasked_inputs",
              "block": i, "level": lvl, "residual": kind, "max_abs_err": err,
              "ref_max": scale, "tol": tol, "unoccupied_listed_cells": int(unocc.numel()),
              **extra})
        del got, xr, rows, want
    if len(done) != 4:
        failures.append(("tiled_block3d unmasked inputs: checked only", sorted(done)))


# the kernels whose rows are compacted to the occupied ones: their outputs
# must not depend on the row order the compaction's atomics give; the
# levels of their unmasked-input checks
ROW_KERNELS = {"tiled_conv3d": (0, 1), "tiled_conv3d_prefolded": (0,),
               "tiled_down2": (1, 2, 3, 4), "tiled_up2": (0, 1),
               "tiled_up2_into": (0, 1)}
# the occupied-row kernels that write exact zeros at an unoccupied listed
# cell (no residual or skip to write there; the into-conv in its conv
# channels, over a dest that holds junk there)
ZERO_AT_UNOCCUPIED = ("tiled_conv3d_prefolded", "tiled_down2", "tiled_up2_into")
# the into-conv's dest holds junk in its conv channels in the checks: a
# value the kernel writes nowhere
INTO_JUNK = 7.0
# the wrappers that zero-fill a fresh output grid, or the splat's scratch
FILLED = ("tiled_conv3d", "tiled_conv3d_prefolded", "tiled_down2", "tiled_up2",
          "hv_splat", "hv_splat6", "hv_splat_windowed", "tiled_block3d")
# the splats whose vote kernel and conversion are timed apart
SPLATS = ("hv_splat", "hv_splat6", "hv_splat_windowed")
# the wrappers held to no host sync inside a call
SYNC_FREE = ("tiled_conv3d_prefolded", "tiled_down2", "hv_splat", "hv_splat6",
             "hv_splat_windowed")


def fill_call(r):
    """The zero fill of the output grid that the wrapper allocates, or of
    the splat's int64 fixed-point scratch."""
    import torch

    name, (x, w), kw = r["name"], r["args"][:2], r["kw"]
    if name.startswith("hv_splat"):
        shape = (tuple(r["args"][3].shape[:-1]) + tuple(kw["grid_shape"])
                 + (6 if name == "hv_splat6" else 1,))
        return lambda: torch.zeros(shape, dtype=torch.int64, device=x.device)
    cout = w.shape[2]
    if name == "tiled_down2":
        shape = tuple(kw["occ"].shape) + (cout,)
    elif name == "tiled_up2":
        shape = tuple(kw["occ"].shape) + (cout + kw.get("skip_c", 0),)
    else:
        shape = tuple(x.shape[:3]) + (cout,)
    return lambda: torch.zeros(shape, dtype=x.dtype, device=x.device)


def host_ms(fn, reps: int) -> float:
    """The host's time to issue one call (no sync between the calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def sync_free(fn):
    """(True, None) when a call of fn makes no host sync: a warm call first
    (it caches the call's device constants), then one under
    torch.cuda.set_sync_debug_mode("error"); else (False, the error)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return True, None
    except RuntimeError as e:
        return False, repr(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def splat_checks(r, got, failures, extra):
    """A splat (objectness or 6-channel): bitwise equal to itself on a
    repeat, and its pieces timed apart (the vote kernel alone, the
    fixed-point conversion). The objectness splat's call of one category
    must also be bitwise equal to the windowed splat on the same inputs,
    and one call over SPLAT_CATEGORIES made-up categories (scaled offsets,
    half the points' objectness kept at random) to their single calls; a
    call over the separate path's categories must be bitwise equal to its
    single calls, both timed."""
    import torch

    import canonicalvoting_tpu_torch.ops.hv_splat as hs

    a, kw = r["args"], r["kw"]
    points, xyz, scale, obj = a[:4]
    fn, channels = (hs.hv_splat, 1) if r["name"] == "hv_splat" else (hs.hv_splat6, 6)
    checks = {"bitwise_repeat": torch.equal(got, fn(*a, **kw))}

    def singles(x, s, o):
        return [fn(points, x[c], s[c], o[c], *a[4:], **kw)
                for c in range(o.shape[0])]

    if obj.dim() == 2:
        checks["bitwise_equal_singles"] = all(
            torch.equal(b, s) for b, s in zip(got, singles(xyz, scale, obj)))
        extra["singles_ms"] = time_ms(lambda: singles(xyz, scale, obj), 3)
    elif channels == 1:
        checks["bitwise_equal_windowed"] = torch.equal(
            got, hs.hv_splat_windowed(*a, x_bucket=32, **kw))
        C = SPLAT_CATEGORIES
        g = torch.Generator(device=points.device).manual_seed(2)
        keep = torch.rand((C, obj.shape[0]), generator=g,
                          device=points.device) < 0.5
        made_up = (torch.stack([xyz * (1.0 + 0.05 * c) for c in range(C)]),
                   scale.expand(C, -1, -1).contiguous(), obj * keep.float())
        batched = hs.hv_splat(points, *made_up, *a[4:], **kw)
        checks["batched_bitwise_equal_singles"] = all(
            torch.equal(b, s) for b, s in zip(batched, singles(*made_up)))
        del batched
    extra.update(checks)
    failures.extend((r["name"], k) for k, ok in checks.items() if not ok)
    splat_part_times(r, channels, extra)


def splat_part_times(r, channels, extra, window=(0, 0)):
    """A splat's vote kernel (windowed with ``window``, (x_bucket, x_pad))
    and fixed-point conversion, each timed alone into ``extra``."""
    import torch

    import canonicalvoting_tpu_torch.ops.hv_splat as hs

    a, kw = r["args"], r["kw"]
    points, obj = a[0], a[3]
    num_rots, grid_shape = kw["num_rots"], kw["grid_shape"]
    f, v, d, tables = hs._kernel_args(*a[:6], kw.get("valid"), num_rots,
                                      grid_shape)
    acc = torch.zeros(tuple(obj.shape[:-1]) + tuple(grid_shape) + (channels,),
                      dtype=torch.int64, device=points.device)
    out = torch.empty(acc.shape, dtype=torch.float32, device=points.device)
    extra["vote_ms"] = time_ms(lambda: hs._votes(
        acc, f, v, d, tables, a[6], num_rots, grid_shape, channels, window), 5)
    extra["convert_ms"] = time_ms(lambda: hs._fixed_to_float(acc, out), 5)


def windowed_checks(r, got, heads, failures, extra):
    """The windowed splat: bitwise equal to itself on a repeat and to
    hv_splat on the recorded (planted) head rows and on the backbone's own
    head rows of the same path (the joint model's, or the nine category
    models' over the separate path's points); its vote kernel and
    conversion timed apart."""
    import inspect

    import torch

    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    from canonicalvoting_tpu_torch.eval.pipeline import (
        slice_joint_heads, slice_separate_heads)

    a, kw = r["args"], r["kw"]
    plane_kw = {k: v for k, v in kw.items() if k not in ("x_bucket", "x_pad")}
    if a[3].dim() == 2:
        xyz, scale, prob = slice_separate_heads(heads["separate"])
    else:
        xyz, scale, _, prob = slice_joint_heads(heads["joint"])
    bb = (a[0], xyz.contiguous(), torch.exp(scale).contiguous(),
          prob.contiguous()) + tuple(a[4:])
    checks = {"bitwise_repeat": torch.equal(got, hs.hv_splat_windowed(*a, **kw)),
              "bitwise_equal_hv_splat": torch.equal(got, hs.hv_splat(*a, **plane_kw)),
              "backbone_rows_bitwise_equal_hv_splat": torch.equal(
                  hs.hv_splat_windowed(*bb, **kw), hs.hv_splat(*bb, **plane_kw))}
    extra.update(checks)
    failures.extend((r["name"], k) for k, ok in checks.items() if not ok)
    pad = kw.get("x_pad", inspect.signature(hs.hv_splat_windowed)
                 .parameters["x_pad"].default)
    splat_part_times(r, 1, extra, window=(kw["x_bucket"], pad))


def drop_wt(plain):
    """A plain version that takes and drops the K-major weights ``wt`` its
    kernel reads (the prefolded stem's fold, the down's layout): the plain
    version folds or reads the kernel itself, so the kernel's weights are
    held against a layout of their own."""
    def call(*a, wt=None, **kw):
        del wt
        return plain(*a, **kw)
    return call


def unmasked_inputs(r):
    """(args, kw) of a recorded call with random inputs that are non-zero
    at unoccupied cells too: x, and the plain residual or the skip (the
    into-conv: its dest's skip channels, with INTO_JUNK in its conv
    channels at every cell). The model's own inputs are zero there, so they
    cannot show a compaction that drops the rows whose output is the
    residual alone, or an into-conv that leaves dest's values where its
    contract writes zeros."""
    import torch

    a, kw = r["args"], dict(r["kw"])
    g = torch.Generator(device=a[0].device).manual_seed(1)

    def rand_like(t):
        return torch.randn(t.shape, generator=g, device=t.device).to(t.dtype)

    for key in ("residual", "skip"):
        if kw.get(key) is not None:
            kw[key] = rand_like(kw[key])
    if kw.get("dest") is not None:
        kw["dest"] = rand_like(kw["dest"])
        kw["dest"][..., kw["skip_c"]:] = INTO_JUNK
    return (rand_like(a[0]),) + tuple(a[1:]), kw


def unmasked_checks(records, kern, plain, levels, failures,
                    rel_tol=CONV_REL_TOL, phase=1):
    """One configuration of each occupied-row kernel at each of its
    ROW_KERNELS levels (the conv with a plain residual) on unmasked random
    inputs, against the plain version, and a repeated call bitwise equal;
    the prefolded stem, the down and the into-conv also write exact zeros
    at their unoccupied listed cells (the into-conv: in its conv channels,
    at the children of live and of dead coarse parents, over a dest that
    holds INTO_JUNK there), and the into-conv keeps dest's skip channels
    and its unlisted cells bit for bit."""
    import torch
    import torch.nn.functional as F

    import canonicalvoting_tpu_torch.ops.tiled_conv as tc
    from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ

    done = set()
    for key, r in records.items():
        name = r["name"]
        lvl = levels.get(tuple(r["kw"]["occ"].shape)) if name in ROW_KERNELS else None
        if lvl not in ROW_KERNELS.get(name, ()) or (name, lvl) in done:
            continue
        if name == "tiled_conv3d" and (r["kw"].get("residual") is None
                                       or r["kw"].get("res_w") is not None):
            continue
        done.add((name, lvl))
        a, kw = unmasked_inputs(r)
        got, again = kern[name](*a, **fresh(kw)), kern[name](*a, **fresh(kw))
        want = plain[name](*a, **fresh(kw))
        err, scale = (rel_err(into_conv_rows(got, a, kw), into_conv_rows(want, a, kw))
                      if name == "tiled_up2_into" else rel_err(got, want))
        bitwise = bool(torch.equal(got, again))
        extra = {}
        if name in ZERO_AT_UNOCCUPIED:
            cells = tc._row_cells(a[2], kw["tile_shape"])
            flat = tc._flat(cells, got.shape)
            unocc = kw["occ"].reshape(-1)[flat] == 0
            c0 = kw.get("skip_c", 0) if name == "tiled_up2_into" else 0
            rows = got.reshape(-1, got.shape[3])
            extra["unoccupied_exact_zeros"] = bool((rows[flat[unocc], c0:] == 0).all())
            extra["unoccupied_listed_cells"] = int(unocc.sum())
        if name == "tiled_up2_into":
            occ = kw["occ"][MX:-MX, MY:-MY, MZ:-MZ]
            parent_live = F.max_pool3d(occ[None, None], 2)[0, 0] > 0
            p = cells >> 1
            extra["dead_parent_cells"] = int(
                (~parent_live[p[:, 0], p[:, 1], p[:, 2]]).sum())
            listed = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
            listed[flat] = True
            rows_in = kw["dest"].reshape(rows.shape)
            skc = kw["skip_c"]
            extra["skip_and_unlisted_kept"] = bool(
                torch.equal(rows[:, :skc], rows_in[:, :skc])
                and torch.equal(rows[~listed], rows_in[~listed]))
            extra["dead_parents_present"] = extra["dead_parent_cells"] > 0
        if not (err <= rel_tol * scale and bitwise and all(extra.values())):
            failures.append((key, "unmasked inputs", err, rel_tol * scale,
                             bitwise, extra))
        emit({"phase": phase, "kernel": name, "check": "unmasked_inputs",
              "level": lvl, "config": [str(v) for v in key[1:]],
              "max_abs_err": err, "ref_max": scale, "tol": rel_tol * scale,
              "bitwise_repeat": bitwise, **extra})
        del got, again, want, a, kw
    want_done = {(n, lvl) for n, lvls in ROW_KERNELS.items() for lvl in lvls}
    if done != want_done:
        failures.append(("unmasked inputs: checked only", sorted(done)))


def phase1(pipe, scene):
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hv_splat as hs
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    plain = {"tiled_conv3d": tc.tiled_conv3d_plain,
             "tiled_conv3d_prefolded": drop_wt(tc.tiled_conv3d_prefolded_plain),
             "tiled_down2": drop_wt(tc.tiled_down2_plain),
             "tiled_up2": tc.tiled_up2_plain, "hv_splat": hs.hv_splat_plain,
             "hv_splat6": functools.partial(hs.hv_splat_plain, channels=6),
             "tiled_up2_into": tc.tiled_up2_into_plain,
             "hv_splat_windowed": hs.hv_splat_windowed_plain}
    kern = counters()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    # the separate path's stem calls; the pipeline is dropped with the
    # records, so that phase 2 holds the joint path's memory alone
    sep = build_separate()
    sep_args = sep.prepare_quantized(*quantize(scene))
    records, heads = record_calls(
        pipe, sep, args, planted_rows(scene, args), sep_args,
        separate_rows(scene, sep_args, len(sep.categories)))
    del sep
    occ_of = {tuple(r["kw"]["occ"].shape): r["kw"]["occ"]
              for r in records.values() if r["name"] == "tiled_conv3d"}
    # level of each occupancy grid: L0 is the largest
    levels = {shape: i for i, shape in enumerate(sorted(
        occ_of, key=lambda sh: -sh[0] * sh[1] * sh[2]))}
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                   "operations": 0.0, "host_ms": 0.0, "device_ms": 0.0,
                   "fill_ms": 0.0 if n in FILLED else None,
                   "vote_ms": 0.0 if n in SPLATS else None,
                   "convert_ms": 0.0 if n in SPLATS else None}
               for n in kern}
    # the occupied-row kernels' kernel and bound ms a scene, by level
    by_level = {n: {} for n in ROW_KERNELS}
    failures = []
    for key, r in records.items():
        name, a, kw = r["name"], r["args"], r["kw"]
        got, want = kern[name](*a, **fresh(kw)), plain[name](*a, **fresh(kw))
        extra = {}
        if name in ROW_KERNELS:
            extra["level"] = levels[tuple(kw["occ"].shape)]
            extra["bitwise_repeat"] = bool(torch.equal(got, kern[name](*a, **fresh(kw))))
            if not extra["bitwise_repeat"]:
                failures.append((key, "a repeated call differs"))
        if name == "tiled_up2_into":  # the conv channels: tiled_up2's, bit for bit
            up = tc.tiled_up2(*a[:3], **{k: kw[k] for k in (
                "tile_shape", "scale", "bias", "occ", "relu_out")})
            extra["bitwise_equal_tiled_up2"] = bool(torch.equal(
                into_conv_rows(got, a, kw).view(torch.int16),
                into_conv_rows(up, a, {**kw, "skip_c": 0}).view(torch.int16)))
            del up
            if not extra["bitwise_equal_tiled_up2"]:
                failures.append((key, "conv channels differ from tiled_up2's"))
        if name == "tiled_down2":  # the weights laid out once by a caller
            wt = tc.down2_weights(a[1], dtype=a[0].dtype, device=a[0].device)
            extra["bitwise_equal_caller_layout"] = bool(torch.equal(
                got, kern[name](*a, **{**kw, "wt": wt})))
            if not extra["bitwise_equal_caller_layout"]:
                failures.append((key, "the caller's weight layout differs"))
        if name in ("hv_splat", "hv_splat6"):
            splat_checks(r, got, failures, extra)
        if name in SYNC_FREE:
            extra["sync_free"], why = sync_free(lambda: kern[name](*a, **fresh(kw)))
            if not extra["sync_free"]:
                failures.append((key, "host sync inside the call", why))
        if name == "hv_splat_windowed":
            windowed_checks(r, got, heads, failures, extra)
        parts = (splat_parts(name, got, want) if name.startswith("hv_splat")
                 else None)
        if parts is not None:
            label, rows = part_errors(parts)
            err = max(p["max_abs_err"] for p in rows)
            scale = max(p["ref_max"] for p in rows)
            tol = SPLAT_REL_TOL * scale
            extra[label] = rows
            if not all(p["max_abs_err"] <= p["tol"] for p in rows):
                failures.append((key, rows))
        else:
            err, scale = (rel_err(into_conv_rows(got, a, kw), into_conv_rows(want, a, kw))
                          if name == "tiled_up2_into" else rel_err(got, want))
            tol = (SPLAT_REL_TOL if name.startswith("hv_splat")
                   else CONV_REL_TOL) * scale
            if not err <= tol:
                failures.append((key, err, tol))
        del got, want
        # the into-conv rewrites the same values into its dest on each call
        kw_k, kw_p = fresh(kw), fresh(kw)
        ms = time_ms(lambda: kern[name](*a, **kw_k), 5)
        extra["host_ms"] = host_ms(lambda: kern[name](*a, **kw_k), 5)
        extra["device_ms"] = device_ms(lambda: kern[name](*a, **kw_k), 5,
                                       extra["host_ms"])
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
        s["host_ms"] += extra["host_ms"] * n
        s["device_ms"] += extra["device_ms"] * n
        if fill_ms is not None:
            s["fill_ms"] += fill_ms * n
        if s["vote_ms"] is not None:
            s["vote_ms"] += extra["vote_ms"] * n
            s["convert_ms"] += extra["convert_ms"] * n
        if name in ROW_KERNELS:
            add_level(by_level, name, extra["level"], n, ms=ms,
                      device_ms=extra["device_ms"], bound_ms=bound_ms,
                      fill_ms=fill_ms)
        emit({"phase": 1, "kernel": name, "config": [str(v) for v in key[1:]],
              "per_scene": n, "max_abs_err": err, "ref_max": scale,
              "tol": tol, "kernel_ms": ms, "fill_ms": fill_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, **extra})
    unmasked_checks(records, kern, plain, levels, failures)
    records.clear()
    heads.clear()
    occ_of.clear()
    torch.cuda.empty_cache()
    phase1_blocks(pipe, args, summary["tiled_block3d"], levels, by_level, failures)
    torch.cuda.empty_cache()
    emit({"phase": 1, "by_level": by_level})
    assert not failures, f"kernels disagree with their plain versions: {failures}"
    for n, s in summary.items():
        s["bound_by"] = "bytes" if s.pop("bytes") >= s.pop("operations") \
            else "operations"
    return summary


# ---------------------------------------------------------------------------
# phase 2

def run_planted(pipe, args, rows):
    out = pipe.run_backbone(args)
    res = pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    return out, res, pipe.postprocess(res)


def stage_times(pipe, scene):
    """Per-stage ms of one scene, synchronizing between stages."""
    import torch

    t = {}
    t0 = time.perf_counter()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    torch.cuda.synchronize()
    t["prep"] = (time.perf_counter() - t0) * 1e3
    rows = planted_rows(scene, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run_backbone(args)
    torch.cuda.synchronize()
    t["backbone"] = (time.perf_counter() - t0) * 1e3
    return {**t, **tail_stage_times(pipe, args, rows)}


def tail_stage_times(pipe, args, rows):
    """The lazy joint tail's splat, peel and NMS ms on ``rows``,
    synchronizing between stages."""
    import torch

    from canonicalvoting_tpu_torch.decode.peeling import peel_boxes
    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        clipped_grid_dims, compute_corners, hough_voting_obj,
        vote_stats_at_cell)

    t = {}
    torch.cuda.synchronize()
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
                 tiled_down2=drop_wt(tc.tiled_down2_plain),
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
                 tiled_conv3d_prefolded=drop_wt(
                     tc.tiled_conv3d_prefolded_plain),
                 tiled_down2=drop_wt(tc.tiled_down2_plain),
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
    evaluator (one splat of the nine categories), with each non-lazy pass's
    peak memory, and the separate evaluator with group_size=2 against
    group_size=1, on one scene each. Returns the two non-lazy runs'
    launches, each counted from 0."""
    import torch

    args = pipe.prepare_scene(scene.points, scene.rgb)
    rows = planted_rows(scene, args)
    _, lazy, _ = run_planted(pipe, args, rows)
    pipe.lazy_rot_scale = False
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        _, full, _ = run_planted(pipe, args, rows)
        torch.cuda.synchronize()
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
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
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        sfull = sep.run_scene(sargs, planted=srows)
        torch.cuda.synchronize()
        sep_launches = read_counters()
        sep_peak = torch.cuda.max_memory_allocated()
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
          "peak_mem_gib": peak / 2 ** 30,
          "separate": {"n_boxes": [sn, sfull["n_boxes"].tolist()],
                       "box_max_abs_err": sbox_err,
                       "launches": sep_launches,
                       "peak_mem_gib": sep_peak / 2 ** 30},
          "grouped": {"n_boxes": [out1["n_boxes"].tolist(),
                                  out2["n_boxes"].tolist()],
                      "detections": [len(dets1), len(dets2)],
                      "head_rows_max_abs_err": head_err,
                      "head_rows_max": head_max}})
    assert launches["hv_splat6"] == 1 and launches["hv_splat"] == 0, launches
    assert n >= 4 and int(full["n_boxes"]) == n, "box counts differ"
    assert torch.equal(full["classes"][:n], lazy["classes"][:n]), "classes differ"
    assert box_err <= RES + 1e-4, f"boxes differ by {box_err}"
    assert sep_launches["hv_splat6"] == 1 and sep_launches["hv_splat"] == 0, \
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
                pipe.run_backbone(a)
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


# ---------------------------------------------------------------------------
# the scannet phase: the CLIs over a ScanNet + Scan2CAD data tree

@contextlib.contextmanager
def cli_hooks(rows_by_id):
    """The CLIs' hooks, restored on exit: each dataset item is timed and
    names the scan whose planted rows (``rows_by_id``, built beforehand)
    the tails decode; the backbones still run, their rows kept on the
    card; compute_map records what it is handed."""
    import canonicalvoting_tpu_torch.data.scannet as sc
    import canonicalvoting_tpu_torch.metrics.ap as ap
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.eval.separate import (
        SeparateDetectionPipeline)

    rec = {"id": None, "heads": [], "map": [], "getitem_ms": [], "t0": None,
           "t_map": None}
    base = sc.ScanNetXYZProbMultiDataset
    joint, sep = DetectionPipeline.run_backbone, SeparateDetectionPipeline.backbones
    compute_map = ap.compute_map

    class Timed(base):
        def __getitem__(self, index):
            t0 = time.perf_counter()
            rec["t0"] = rec["t0"] or t0
            item = base.__getitem__(self, index)
            rec["getitem_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["id"] = item[0]
            return item

    def run_backbone(self, args):
        rec["heads"].append(joint(self, args).clone())
        return rows_by_id[rec["id"]]

    def backbones(self, args, shared=None):
        rec["heads"].append(sep(self, args, shared).clone())
        return rows_by_id[rec["id"]]

    def recorded_map(pred, gt, **kw):
        rec["t_map"] = rec["t_map"] or time.perf_counter()
        rec["map"].append((pred, gt))
        return compute_map(pred, gt, **kw)

    with patched(sc, ScanNetXYZProbMultiDataset=Timed), \
            patched(DetectionPipeline, run_backbone=run_backbone), \
            patched(SeparateDetectionPipeline, backbones=backbones), \
            patched(ap, compute_map=recorded_map):
        yield rec


@contextlib.contextmanager
def peel_of(pipe, peel):
    old = pipe.peel
    pipe.peel = peel
    try:
        yield pipe
    finally:
        pipe.peel = old


def same_detections(got, want) -> bool:
    return len(got) == len(want) and all(
        c == wc and s == ws and np_equal(b, wb)
        for (c, b, s), (wc, wb, ws) in zip(got, want))


def np_equal(a, b) -> bool:
    import numpy as np

    return a.dtype == b.dtype and np.array_equal(a, b)


def scannet_items(ds, root, n):
    """The dataset's first ``n`` items, each held bitwise against the
    phase's own read, transform and quantization of the scan's PLY, and
    the host ms of each piece."""
    import os

    import numpy as np

    from canonicalvoting_tpu_torch.data.geometry import make_M_from_tqs
    from canonicalvoting_tpu_torch.data.ply import read_ply_vertices
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    items, ms, equal = [], {"getitem": [], "ply_read": [], "transform": [],
                            "quantize": []}, []
    for i in range(n):
        t0 = time.perf_counter()
        item = ds[i]
        ms["getitem"].append((time.perf_counter() - t0) * 1e3)
        ann = ds.annotations[i]
        id_scan, trs = ann["id_scan"], ann["trs"]
        t0 = time.perf_counter()
        v = read_ply_vertices(os.path.join(root, "scans", id_scan,
                                           f"{id_scan}_vh_clean_2.ply"))
        t1 = time.perf_counter()
        M = make_M_from_tqs(trs["translation"], trs["rotation"], trs["scale"])
        pcd = np.stack([v["x"], v["y"], v["z"]], -1)
        hom = np.concatenate([pcd, np.ones((len(pcd), 1))], -1)
        points = (M @ hom.T).T[:, :3].astype(np.float32)
        t2 = time.perf_counter()
        coords, idx = sparse_quantize(points, RES)
        t3 = time.perf_counter()
        rgb = np.stack([v["red"], v["green"], v["blue"]], -1)
        feats = (rgb / 255.0).astype(np.float32)[idx]
        ms["ply_read"].append((t1 - t0) * 1e3)
        ms["transform"].append((t2 - t1) * 1e3)
        ms["quantize"].append((t3 - t2) * 1e3)
        equal.append(item[0] == id_scan and np_equal(item[1], coords)
                     and np_equal(item[2], feats))
        items.append(item[:3])
    return items, ms, equal


def phase_scannet(pipe, sep, scenes, card):
    """The real-data path: the scenes written as a ScanNet + Scan2CAD tree
    (binary PLY with faces, full_annotations.json, split, segments, ground
    truth), read back by the dataset (items bitwise equal to the phase's
    own transform and quantization of each PLY) and the ground-truth
    parser (the planted boxes' corners within 1e-5 m), then both CLIs on
    the card with their default seeded weights, eval_joint over the three
    scans and eval_separate over two: exact conv launch counts, their
    detections and backbone rows bitwise equal to the pipelines' on the
    same items with the same weights (the tails decode planted rows), a
    finite mAP at both thresholds. Returns both runs' launches."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from canonicalvoting_tpu_torch import eval_joint, eval_separate
    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.data.geometry import NAME2CATNAME
    from canonicalvoting_tpu_torch.data.scannet import (
        ScanNetXYZProbMultiDataset)
    from canonicalvoting_tpu_torch.data.synthetic_tree import (
        wnid_of, write_scannet_tree)
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.gt import load_gt_scene

    root = tempfile.mkdtemp(prefix="chip_smoke_scannet_")
    try:
        ids = [f"scene{i:04d}_00" for i in range(len(scenes))]
        overrides = write_scannet_tree(root, scenes, ids) + [f"scannet_res={RES}"]
        with open(os.path.join(root, "split_separate.txt"), "w") as f:
            f.write("\n".join(ids[:N_SEPARATE_SCENES]) + "\n")
        cfg = load_config(None, overrides)
        ds = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)
        items, host_ms, items_equal = scannet_items(ds, root, len(scenes))
        gt_err, gt_names = 0.0, True
        for id_scan, scene in zip(ids, scenes):
            gt = load_gt_scene(cfg.data.gt_path, id_scan)
            want = scene.gt_corners()
            gt_names &= [c for c, _ in gt] == [
                NAME2CATNAME.get(wnid_of(ci), wnid_of(ci)) for ci, _ in want]
            gt_err = max([gt_err] + [float(np.abs(b - w).max())
                                     for (_, b), (_, w) in zip(gt, want)])
        # the planted rows of each scan, at the rows the CLIs' prep gives
        rows = {"joint": {}, "separate": {}}
        for (id_scan, coords, feats), scene in zip(items, scenes):
            rows["joint"][id_scan] = planted_rows(
                scene, pipe.prepare_quantized(coords, feats))
            rows["separate"][id_scan] = torch.as_tensor(separate_rows(
                scene, sep.prepare_quantized(coords, feats),
                len(sep.categories)), device=sep.device)

        runs = {}
        for name, main, argv, ref, peel, n in (
                ("joint", eval_joint.main, overrides, pipe,
                 PeelConfig(res=RES, max_boxes=64), len(scenes)),
                ("separate", eval_separate.main, overrides + [
                    f"data.val_split={root}/split_separate.txt"], sep,
                 PeelConfig(res=RES, elimination_inclusive=False,
                            max_boxes=64), N_SEPARATE_SCENES)):
            with cli_hooks(rows[name]) as rec:
                torch.cuda.synchronize()
                reset_counters()
                results = main(argv)
                torch.cuda.synchronize()
                launches = read_counters()
                pred, gt = rec["map"][0]
                loop_s = rec["t_map"] - rec["t0"]
                cli_heads = rec["heads"][:]
                # the pipelines on the same items, with the CLIs' peel
                with peel_of(ref, peel):
                    want = {}
                    for id_scan, coords, feats in items[:n]:
                        rec["id"] = id_scan
                        if name == "joint":
                            want[id_scan] = ref.postprocess(
                                ref.run_scene_with_retry(
                                    ref.prepare_quantized(coords, feats)))
                        else:
                            want[id_scan] = ref.detect(coords, feats)
                ref_heads = rec["heads"][len(cli_heads):]
            runs[name] = {
                "scenes": n, "scenes_per_s": n / loop_s,
                "getitem_ms": rec["getitem_ms"][:n], "launches": launches,
                "detections": [len(pred.get(i, ())) for i in ids[:n]],
                "detections_equal": list(pred) == ids[:n] and all(
                    same_detections(pred[i], want[i]) for i in ids[:n]),
                "heads_equal": len(cli_heads) == len(ref_heads) == n and all(
                    torch.equal(a, b) for a, b in zip(cli_heads, ref_heads)),
                "gt_boxes": [len(gt[i]) for i in ids[:n]],
                "mAP": {str(t): float(d["mAP"]) for t, d in results.items()},
                "AR": {str(t): float(d.get("AR", float("nan")))
                       for t, d in results.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    emit({"phase": "scannet", "scenes": len(scenes),
          "voxels": [len(c) for _, c, _ in items],
          "points": [len(s.points) for s in scenes],
          "host_ms": host_ms, "items_bitwise_equal": items_equal,
          "gt_max_abs_err_m": gt_err, "gt_names_ok": gt_names,
          "joint": runs["joint"], "separate": runs["separate"],
          "scenenn": "not run: no h5py", "card": card})
    assert all(items_equal), f"dataset items differ: {items_equal}"
    assert gt_err <= 1e-5 and gt_names, f"ground truth off by {gt_err} m"
    for name, per_scene in (("joint", PER_SCENE),
                            ("separate", SEPARATE_PER_SCENE)):
        r = runs[name]
        for k, per in per_scene.items():
            if k in ("hv_splat", "hv_splat6"):
                continue  # a budget exit reruns a tail: >= below
            assert r["launches"][k] == per * r["scenes"], (name, k, r["launches"])
        assert r["launches"]["hv_splat"] >= r["scenes"], (name, r["launches"])
        assert r["launches"]["hv_splat6"] == 0, (name, r["launches"])
        assert r["detections_equal"], f"{name} CLI detections differ"
        assert r["heads_equal"], f"{name} CLI backbone rows differ"
        assert sum(r["detections"]) >= r["scenes"], (name, r["detections"])
        assert all(np.isfinite(v) for v in r["mAP"].values()), (name, r["mAP"])
    assert runs["joint"]["launches"]["tiled_conv3d_prefolded"] == 0
    return {k: runs["joint"]["launches"][k] + runs["separate"]["launches"][k]
            for k in runs["joint"]["launches"]}


# ---------------------------------------------------------------------------
# the sparse phase: the gather-form backbone on both evaluators

def junk_rows(rows, valid):
    """``rows`` with junk in the padding rows (``valid`` 0): normal draws
    times SPARSE_JUNK, so exp of a scale overflows. The tails must drop
    those rows."""
    import torch

    g = torch.Generator(device=rows.device).manual_seed(5)
    noise = torch.randn(rows.shape, generator=g, device=rows.device) * SPARSE_JUNK
    return torch.where((valid == 0)[:, None], noise, rows)


def backbone_errors(ref, got, n):
    """Max and mean |got - ref| over the n valid rows, and the rows with an
    error above SPARSE_ROW_LIMIT."""
    d = (got[:n].float() - ref[:n]).abs()
    return {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
            "rows_above": int((d.max(1).values > SPARSE_ROW_LIMIT).sum())}


def sparse_models(plan, state):
    """The gather-form twins of ``plan`` (a DenseMinkUNet) in bfloat16 and in
    float32, with the weights ``state``, on the card."""
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase, sparse_plan

    bf = sparse_plan(plan)
    f32 = MinkUNetBase(**{**bf.config(), "compute_dtype": "float32"})
    for m in (bf, f32):
        m.load_state_dict(state, strict=True)
    return bf.to(DEVICE).eval(), f32.to(DEVICE).eval()


def backbone_check(model, dense_fn, dargs, sargs, plan, state):
    """The dense backbone (bf16, kernels) and the sparse one (bf16) against
    the sparse float32 backbone, one state dict, over the valid rows: the
    dense error at most SPARSE_RATIO x the sparse bf16 error plus
    SPARSE_FLOOR of the float32 rows' peak."""
    bf, f32 = sparse_models(plan, state)
    n = sargs.pyramid["nvalid"][0]
    ref = f32(sargs.feats, sargs.pyramid)
    rows = {"sparse_bf16": bf(sargs.feats, sargs.pyramid),
            "dense_bf16": dense_fn(dargs)}
    peak = float(ref[:n].abs().max())
    errs = {k: backbone_errors(ref, v, n) for k, v in rows.items()}
    limit = SPARSE_RATIO * errs["sparse_bf16"]["max_abs_err"] + SPARSE_FLOOR * peak
    ms = {"sparse_bf16": time_ms(lambda: bf(sargs.feats, sargs.pyramid), 3),
          "sparse_f32": time_ms(lambda: f32(sargs.feats, sargs.pyramid), 3),
          "dense_bf16": time_ms(lambda: dense_fn(dargs), 3)}
    ok = errs["dense_bf16"]["max_abs_err"] <= limit
    emit({"phase": "sparse", "check": "backbones", "model": model,
          "valid_rows": n, "f32_peak": peak, **errs, "dense_limit": limit,
          "ok": ok, "ms": ms})
    del bf, f32, ref, rows
    return ok


def sync_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = fn()
    torch.cuda.synchronize()
    return v, (time.perf_counter() - t0) * 1e3


def sparse_prep(scene, pipe):
    """(dense args, sparse args, host ms) of a scene: quantize, then the
    sparse host prep (the pyramid timed apart) and its upload."""
    from canonicalvoting_tpu_torch.eval.pipeline import sparse_scene_host

    t0 = time.perf_counter()
    coords, feats = quantize(scene)
    t_q = (time.perf_counter() - t0) * 1e3
    host, t_h = sync_ms(lambda: sparse_scene_host(
        coords, feats, res=RES, cap_multiple=pipe.cap_multiple,
        grid_multiple=pipe.grid_multiple))
    sargs, t_u = sync_ms(lambda: host.upload(DEVICE))
    dargs = pipe.prepare_quantized(coords, feats)
    return dargs, sargs, {"quantize": t_q, "prep": t_h,
                          "pyramid": host.pyramid_ms, "upload": t_u}


def phase_sparse(pipe, sep, scenes):
    """The gather-form sparse backbone (backbone="sparse") on the joint
    path (three scenes) and the separate path (two), against the dense
    path: pyramids, the dense-against-sparse backbone check (joint model
    and separate category 0), planted rows with junk in the padding rows
    through the sparse args' tails (detections bitwise equal to the dense
    args' on clean rows), launch counts (no dense-backbone kernel), stage
    ms and peak memory; rows 4 and 5 (lazy and non-lazy tails, joint and
    nine categories) on the sparse args against their plain versions.
    Returns the launches of the two timed passes."""
    import numpy as np
    import torch
    from torch.func import functional_call

    import canonicalvoting_tpu_torch.ops.hough_voting as hv
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.eval.separate import SeparateDetectionPipeline

    failures = []
    preps = [sparse_prep(s, pipe) for s in scenes]
    emit({"phase": "sparse", "pyramids": {
        "host_ms": [p[2] for p in preps],
        "table_bytes": [p[1].table_bytes for p in preps],
        "nvalid": [list(p[1].pyramid["nvalid"]) for p in preps]}})

    # the backbones: joint model, then separate category 0 (prefolded stem)
    dargs, sargs, _ = preps[0]
    if not backbone_check("joint", pipe.run_backbone, dargs, sargs, pipe.model,
                          pipe.model.state_dict()):
        failures.append("joint backbones")
    state0 = {k: v[0] for k, v in sep.stacked.items()}

    def dense_category0(a):
        kw = {"shared": sep.shared_grids(a), "down_wt": sep.down_wt[0],
              "stem_wt": sep.stem_wt[0]}
        return functional_call(sep.net, state0, (
            a.feats, a.flat, a.valid, a.dense_dims, a.tiles, a.tile_shapes), kw)

    if not backbone_check("separate category 0", dense_category0, dargs, sargs,
                          sep.plan, state0):
        failures.append("separate backbones")
    torch.cuda.empty_cache()

    # the joint path, backbone="sparse", timed
    spipe = DetectionPipeline(model=pipe.model, backbone="sparse", res=RES,
                              num_rots=NUM_ROTS, peel=pipe.peel,
                              cap_multiple=pipe.cap_multiple, device=DEVICE)
    clean = [planted_rows(s, p[1]) for s, p in zip(scenes, preps)]
    junked = [junk_rows(r, p[1].valid) for r, p in zip(clean, preps)]
    want = [pipe.tail(r, p[0].coords_w, p[0].valid, p[0].grid_shape)
            for r, p in zip(clean, preps)]
    for p, r in zip(preps, junked):  # warm-up
        spipe.run_backbone(p[1])
        spipe.tail(r, p[1].coords_w, p[1].valid, p[1].grid_shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    outs = []
    for p, r in zip(preps, junked):
        spipe.run_backbone(p[1])
        outs.append(spipe.tail(r, p[1].coords_w, p[1].valid, p[1].grid_shape))
        spipe.postprocess(outs[-1])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    equal = [all(torch.equal(o[k], w[k]) for k in w) for o, w in zip(outs, want)]
    stages = []
    for s, p, r in zip(scenes, preps, junked):
        _, _, host = sparse_prep(s, pipe)
        _, t_b = sync_ms(lambda: spipe.run_backbone(p[1]))
        stages.append({**host, "backbone": t_b,
                       **tail_stage_times(spipe, p[1], r)})
    joint = {"scenes_per_s": len(scenes) / elapsed, "launches": launches,
             "n_boxes": [int(o["n_boxes"]) for o in outs],
             "truncated": [bool(o["truncated"]) for o in outs],
             "bitwise_equal_dense_args": equal,
             "stage_ms": {k: float(np.median([s[k] for s in stages]))
                          for k in stages[0]},
             "peak_mem_gib": peak / 2 ** 30}
    emit({"phase": "sparse", "path": "joint", "scenes": len(scenes), **joint})
    if not all(equal):
        failures.append(f"joint detections on sparse args differ: {equal}")
    if min(joint["n_boxes"]) < 4:
        failures.append(f"joint planted scenes lost boxes: {joint['n_boxes']}")
    for n, per in SPARSE_PER_SCENE.items():
        if launches[n] != per * len(scenes):
            failures.append(("joint launches", n, launches[n]))
    # rows 4 (the lazy tail) and 5 (lazy_rot_scale=False) on the sparse
    # args, far-padded rows with junk heads, against their plain versions
    records = {}
    p, r = preps[0][1], junked[0]
    with patched(hv, hv_splat=recorder(records, hv, "hv_splat"),
                 hv_splat6=recorder(records, hv, "hv_splat6")):
        for lazy in (True, False):
            spipe.lazy_rot_scale = lazy
            spipe.tail(r, p.coords_w, p.valid, p.grid_shape)
    del spipe
    torch.cuda.empty_cache()

    # the separate path, backbone="sparse", timed
    C = len(sep.categories)
    ssep = SeparateDetectionPipeline(
        model=sep.plan, categories=sep.categories, res=RES, num_rots=NUM_ROTS,
        peel=sep.peel, backbone="sparse", device=DEVICE,
        state_dicts=[{k: v[c] for k, v in sep.stacked.items()} for c in range(C)])
    two = preps[:N_SEPARATE_SCENES]
    clean = [torch.as_tensor(separate_rows(s, p[1], C), device=DEVICE)
             for s, p in zip(scenes, two)]
    junked = [junk_rows(r, p[1].valid) for r, p in zip(clean, two)]
    want = [sep.tail(r, p[0]) for r, p in zip(clean, two)]
    ssep.postprocess(ssep.run_scene(two[0][1], planted=junked[0]))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    outs = [ssep.run_scene(p[1], planted=r) for p, r in zip(two, junked)]
    dets = [ssep.postprocess(o) for o in outs]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    s_launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    equal = [all(torch.equal(o[k], w[k]) for k in w) for o, w in zip(outs, want)]
    with patched(hv, hv_splat=recorder(records, hv, "hv_splat"),
                 hv_splat6=recorder(records, hv, "hv_splat6")):
        for lazy in (True, False):
            ssep.lazy_rot_scale = lazy
            ssep.vote(junked[0], two[0][1])
    ssep.lazy_rot_scale = True
    stages = []
    for p, r in zip(two, junked):
        _, t_b = sync_ms(lambda: ssep.backbones(p[1]))
        votes, t_s = sync_ms(lambda: ssep.vote(r, p[1]))
        _, t_p = sync_ms(lambda: ssep.peel_votes(votes, p[1]))
        stages.append({**p[2], "backbones": t_b, "splats": t_s,
                       "batched_peel": t_p})
    emit({"phase": "sparse", "path": "separate", "scenes": len(two),
          "categories": C, "scenes_per_s": len(two) / elapsed,
          "launches": s_launches, "n_boxes": [o["n_boxes"].tolist() for o in outs],
          "detections": [len(d) for d in dets],
          "bitwise_equal_dense_args": equal,
          "stage_ms": {k: float(np.median([s[k] for s in stages]))
                       for k in stages[0]},
          "peak_mem_gib": peak / 2 ** 30})
    if not all(equal):
        failures.append(f"separate detections on sparse args differ: {equal}")
    if sum(len(d) for d in dets) < len(two):
        failures.append(f"separate planted scenes found nothing: {dets}")
    for n, per in SPARSE_PER_SCENE.items():
        if s_launches[n] != per * len(two):
            failures.append(("separate launches", n, s_launches[n]))
    del ssep
    torch.cuda.empty_cache()
    _, failed = splat_plain_checks("sparse", records)
    if failed:
        failures.append(("splats differ from their plain versions", failed))
    assert not failures, failures
    return {k: launches[k] + s_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# the sunrgbd phase: the SUN RGB-D proposal sampler

def sunrgbd_clouds():
    """SUNRGBD_BATCH synthetic indoor clouds of SUNRGBD_POINTS points in
    mmdet3d's z-up axes (the y-up scenes of make_scene, 4 x 2.5 x 4.5 m,
    permuted) and SUNRGBD_SEEDS vote seeds a cloud, drawn from its points."""
    import numpy as np

    from canonicalvoting_tpu_torch.data.synthetic import make_scene

    rng = np.random.RandomState(1)
    clouds, seeds = [], []
    for _ in range(SUNRGBD_BATCH):
        s = make_scene(rng, extent=(4.0, 2.5, 4.5), n_background=17000,
                       n_boxes=4, pts_per_box=1000)
        pts = s.points[rng.choice(len(s.points), SUNRGBD_POINTS, replace=False)]
        pts = np.ascontiguousarray(pts[:, [0, 2, 1]], np.float32)
        clouds.append(pts)
        seeds.append(pts[rng.choice(len(pts), SUNRGBD_SEEDS, replace=False)])
    return clouds, np.stack(seeds)


def phase_sunrgbd():
    """BRNetCanonSampler with a seeded MinkUNet34C(3, 8) in its defaults
    over a batch of synthetic clouds: keys and shapes, zero probs,
    proposals inside each cloud's box, bitwise equal under one generator
    seed, weights unchanged, one 6-channel splat a sample; row 5 at this
    configuration against its plain version (each channel within 1e-4 of
    its peak), timed with its bound. Returns the timed call's launches and
    that splat's largest error."""
    import torch

    import canonicalvoting_tpu_torch.ops.hough_voting as hv
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C
    from canonicalvoting_tpu_torch.sunrgbd.brnetcanon import BRNetCanonSampler

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    model = MinkUNet34C(3, 8, generator=torch.Generator().manual_seed(0))
    sampler = BRNetCanonSampler(model=model, device=DEVICE)
    clouds, seeds = sunrgbd_clouds()
    before = {k: v.clone() for k, v in sampler.model.state_dict().items()}
    sampler.propose(clouds[:1], seeds[:1], gen(0))  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    out, ms = sync_ms(lambda: sampler.propose(clouds, seeds, gen(1)))
    launches = read_counters()
    again = sampler.propose(clouds, seeds, gen(1))
    B, P = SUNRGBD_BATCH, sampler.num_proposal
    checks = {
        "shapes": (set(out) == {"proposals", "probs", "scales"}
                   and out["proposals"].shape == (B, P, 3)
                   and out["probs"].shape == (B, P)
                   and out["scales"].shape == (B, P, 3)),
        "probs_zero": bool((out["probs"] == 0).all()),
        "inside_boxes": all(
            bool(((out["proposals"][b].cpu().numpy() >= c.min(0) - 0.1)
                  & (out["proposals"][b].cpu().numpy() <= c.max(0) + 0.1)).all())
            for b, c in enumerate(clouds)),
        "finite_scales": bool(torch.isfinite(out["scales"]).all()),
        "bitwise_repeat": all(torch.equal(out[k], again[k]) for k in out),
        "weights_unchanged": all(torch.equal(v, before[k]) for k, v in
                                 sampler.model.state_dict().items()),
        "one_splat6_a_sample": launches["hv_splat6"] == B and all(
            v == 0 for k, v in launches.items() if k != "hv_splat6")}
    records = {}
    with patched(hv, hv_splat6=recorder(records, hv, "hv_splat6")):
        sampler.propose(clouds[:1], seeds[:1], gen(1))
    worst, failed = splat_plain_checks("sunrgbd", records)
    checks["splat6_matches_plain"] = not failed
    emit({"phase": "sunrgbd", "batch": B, "points": [len(c) for c in clouds],
          "seeds": seeds.shape[1], "proposals": P, "ms_per_sample": ms / B,
          "voxels": [sampler.prepare(c)[0].nvalid[0] for c in clouds],
          "launches": launches, "checks": checks, "max_abs_err": worst})
    assert all(checks.values()), checks
    return launches, worst


# ---------------------------------------------------------------------------
# the train phase: the sparse conv's backward, the train steps and loops

# the card route's dX and dW against the plain route's, of each output's
# peak: both round d_gathered and dW to bf16 after float32 sums (the card's
# route rounds dY to bf16 first)
TRAIN_CONV_TOL = 1e-2
# the bf16 step's gradients against the float32 step's on one batch and
# weights: each parameter tensor's relative L2 error at most
# TRAIN_GRAD_WORST, all of them together at most TRAIN_GRAD_GLOBAL, and the
# head's (final.kernel) at most TRAIN_HEAD_GRAD (PERF.md gives their grounds)
TRAIN_GRAD_WORST, TRAIN_GRAD_GLOBAL, TRAIN_HEAD_GRAD = 2.0, 0.9, 0.05
TRAIN_REPS = 3        # timed steps, after one warm-up
TRAIN_DESCENT = 5     # steps on the fixed batch that must lower the loss
# the loops' scenes: the JAX train_joint.py --synthetic recipe's size
LOOP_SCENES, LOOP_VAL = 6, 1
# the launches of one validation scene: joint (rows 1-4) and one category
# of the separate evaluator (rows 1-4 and 6); the objectness splat runs
# once a tail, and a budget exit re-runs the tail
VAL_JOINT = {"tiled_conv3d": 47, "tiled_down2": 4, "tiled_up2": 4,
             "tiled_conv3d_prefolded": 0, "hv_splat6": 0, **NO_VARIANTS}
VAL_SEPARATE = {"tiled_conv3d": 46, "tiled_conv3d_prefolded": 1,
                "tiled_down2": 4, "tiled_up2": 4, "hv_splat6": 0, **NO_VARIANTS}


def train_items(scenes, res=RES):
    """(joint items, separate items) of synthetic scenes: quantized points,
    rgb and labels; the separate items add object ids (points inside a
    box) and a symmetry code a box, as the JAX package's
    train_separate.py --synthetic builds them."""
    import numpy as np

    from canonicalvoting_tpu_torch.data.geometry import NCLASSES, rotmat_y
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    joint, separate = [], []
    for i, s in enumerate(scenes):
        coords, idx = sparse_quantize(s.points, res)
        cls = s.class_labels[idx]
        joint.append((f"scene{i}", coords, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], cls))
        pw = coords.astype(np.float32) * res
        oid = np.full(len(coords), -1, np.int32)
        for bi, b in enumerate(s.boxes):
            inv = ((pw - b.center) @ rotmat_y(b.yaw)) / b.scale
            oid[np.all(np.abs(inv) < 1, -1)] = bi
        sym = np.array([bi % 4 for bi in range(len(s.boxes))], np.int32)
        separate.append(joint[-1][:5] + ((cls < NCLASSES).astype(np.int32),
                                         cls, oid, sym))
    return joint, separate


def train_conv_configs(pyr):
    """One conv per level of the joint MinkUNet34C at a pyramid's tables:
    (name, table or None for the 1x1, input rows, Cin, Cout)."""
    n = [c.shape[0] for c in pyr.coords]
    return [("stem L0 k=5", pyr.nbr_stem, n[0], 3, 32),
            ("block8 L0 k=3", pyr.nbr_conv[0], n[0], 96, 96),
            ("block7 L1 k=3", pyr.nbr_conv[1], n[1], 96, 96),
            ("block6 L2 k=3", pyr.nbr_conv[2], n[2], 128, 128),
            ("block5 L3 k=3", pyr.nbr_conv[3], n[3], 256, 256),
            ("block4 L4 k=3", pyr.nbr_conv[4], n[4], 256, 256),
            ("conv1p1s2 L0->L1 k=2", pyr.nbr_down[0], n[0], 32, 32),
            ("convtr7p2s2 L1->L0 k=2", pyr.nbr_up[0], n[1], 96, 96),
            ("final L0 1x1", None, n[0], 96, 64)]


def train_conv_check(i, name, nbr, n_in, cin, cout):
    """The sparse conv's card route (forward, then the Function's backward)
    against its plain route (the float32 products of the same backward) on
    random inputs at one configuration; the backward timed both ways."""
    import torch

    from canonicalvoting_tpu_torch.ops import sparse_conv as sc

    g = torch.Generator(device=DEVICE).manual_seed(100 + i)
    k = 1 if nbr is None else nbr.shape[1]
    n_out = n_in if nbr is None else nbr.shape[0]
    x = torch.randn(n_in, cin, device=DEVICE, generator=g).requires_grad_()
    w = (torch.randn(k, cin, cout, device=DEVICE, generator=g)
         * (2.0 / (k * cout)) ** 0.5).requires_grad_()
    dy = torch.randn(n_out, cout, device=DEVICE, generator=g)
    w2 = w.detach().bfloat16().reshape(k * cin, cout)

    def forward():
        if nbr is None:
            return sc.sparse_conv1x1(x, w)
        return sc.sparse_conv_apply(x, nbr, w)

    forward().backward(dy)
    if nbr is None:
        a = x.detach().bfloat16()

        def grads(plain):
            return (sc.grad_matmul(dy, w2.t(), plain).bfloat16().float(),
                    sc.grad_matmul(a.t(), dy, plain).bfloat16())
    else:
        src = torch.cat([x.detach().bfloat16(),
                         x.new_zeros(1, cin, dtype=torch.bfloat16)])
        idx = sc.conv_index(nbr, n_in)

        def grads(plain):
            return sc.gather_matmul_grads(src, idx, w2, dy, plain=plain)

    pdx, pdw = grads(True)
    errs = {}
    for part, got, want in (("dx", x.grad, pdx),
                            ("dw", w.grad, pdw.float().reshape(k, cin, cout))):
        peak = float(want.abs().max())
        err = float((got - want).abs().max())
        errs[part] = {"max_abs_err": err, "peak": peak, "ok": err <= TRAIN_CONV_TOL * peak}
    with torch.no_grad():
        ms = {"forward": time_ms(forward, 5),
              "backward_card": time_ms(lambda: grads(False), 5),
              "backward_plain": time_ms(lambda: grads(True), 5)}
    x.grad = w.grad = None
    return {"conv": name, "rows_out": n_out, "rows_in": n_in, "k": k,
            "cin": cin, "cout": cout, **errs, "ms": ms}


def train_step_run(step, state, batch, reps=TRAIN_REPS):
    """(losses of the first call, median step ms, peak GiB) of one warm-up
    step and ``reps`` timed ones on ``batch``, each synchronized."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses = step(state, batch, 1e-3, 0.5)
    times = []
    for _ in range(reps):
        _, t = sync_ms(lambda: step(state, batch, 1e-3, 0.5))
        times.append(t)
    return ({k: float(v) for k, v in losses.items()}, float(np.median(times)),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def step_profile(step, state, batch):
    """One step under torch.profiler: wall ms, the card's busy ms (kernels'
    self time), the idle share, and the kernels that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):  # the attribute's name before torch 2.4: self_cuda_*
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, 1e-3, 0.5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the kernels alone: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"name": e.key[:90], "ms": device_us(e) / 1e3,
                     "calls": e.count} for e in top]}


def allocated_gib():
    import torch

    return torch.cuda.memory_allocated() / 2 ** 30


def grad_errors(ref_model, model):
    """Each parameter tensor's relative L2 error of ``model``'s gradient
    against ``ref_model``'s, and all of them together."""
    import torch

    ref = dict(ref_model.named_parameters())
    per = {n: float((p.grad - ref[n].grad).norm() / ref[n].grad.norm())
           for n, p in model.named_parameters()}
    a = torch.cat([p.grad.flatten() for _, p in model.named_parameters()])
    b = torch.cat([ref[n].grad.flatten() for n, _ in model.named_parameters()])
    return per, float((a - b).norm() / b.norm()), float(a @ b / (a.norm() * b.norm()))


def loop_checks(name, state, ret, launches, per_scene, n_val, validations,
                workdir, epochs):
    """The loop's result: every epoch trained and checkpointed, a finite mAP
    at both thresholds, and the validations on the dense kernels."""
    import math
    import os

    ckpts = sorted(f for f in os.listdir(workdir) if f.endswith(".ckpt"))
    checks = {
        "checkpoints": ckpts == sorted(f"epoch{e}.ckpt" for e in epochs),
        "finite_map": ret is not None and all(
            math.isfinite(ret[t]["mAP"]) and math.isfinite(ret[t]["AR"])
            for t in (0.25, 0.5)),
        "kernel_launches": all(launches[k] == v * n_val * validations
                               for k, v in per_scene.items()),
        "splats": launches["hv_splat"] >= n_val * validations}
    assert all(checks.values()), (name, checks, launches)
    return checks


def phase_train(scenes):
    """Training on the card: the sparse conv's Function against its plain
    route at one conv per level of the joint MinkUNet34C (scene 0's
    pyramid, and one call under the sync debug mode); the joint step at
    full width on the three scenes (bf16, microbatch 0 and 1: step ms,
    host collate ms, peak memory; the bf16 gradients against a float32
    step; five steps lowering the loss, the BN statistics moving and
    finite); the separate step (MinkUNet34C(3, 8), symmetry labels); both
    training loops with validation on the dense kernels, a checkpoint a
    validated epoch and a resumed second call. Returns the loops' kernel
    launches (their validations)."""
    import tempfile

    import numpy as np
    import torch

    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME
    from canonicalvoting_tpu_torch.data.collate import (
        collate_joint, collate_separate)
    from canonicalvoting_tpu_torch.data.loader import ListDataset
    from canonicalvoting_tpu_torch.data.synthetic import make_scene
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C
    from canonicalvoting_tpu_torch.ops.coords import PyramidSpec, build_pyramid
    from canonicalvoting_tpu_torch.ops.voxelize import batched_coordinates
    from canonicalvoting_tpu_torch.train import steps
    from canonicalvoting_tpu_torch.train.joint_loop import run_joint_training
    from canonicalvoting_tpu_torch.train.separate_loop import run_separate_training

    t_phase = time.perf_counter()
    failures = []
    joint_items, sep_items = train_items(scenes)
    cfg = load_config(None, [])

    with torch.enable_grad():
        # 1. the Function, card route against the plain route
        pyr = build_pyramid(batched_coordinates([joint_items[0][1]]),
                            PyramidSpec(cap_multiple=4096))
        tabs, _ = pyr.to(DEVICE)
        # the device tables in train_conv_configs' order (the 1x1 has none)
        tabs = [tabs["nbr_stem"], *tabs["nbr_conv"], tabs["nbr_down"][0],
                tabs["nbr_up"][0], None]
        configs = train_conv_configs(pyr)
        convs = []
        for i, ((name, _, n_in, cin, cout), nbr) in enumerate(zip(configs, tabs)):
            convs.append(train_conv_check(i, name, nbr, n_in, cin, cout))
            emit({"phase": "train", "check": "conv", **convs[-1]})
            if not (convs[-1]["dx"]["ok"] and convs[-1]["dw"]["ok"]):
                failures.append(("conv grads", name))
        n0 = configs[1][2]
        x = torch.randn(n0, 96, device=DEVICE, requires_grad=True)
        w = torch.randn(27, 96, 96, device=DEVICE, requires_grad=True)
        dy = torch.randn(tabs[1].shape[0], 96, device=DEVICE)

        from canonicalvoting_tpu_torch.ops.sparse_conv import sparse_conv_apply

        free, err = sync_free(
            lambda: sparse_conv_apply(x, tabs[1], w).backward(dy))
        emit({"phase": "train", "check": "sync_free", "conv": configs[1][0],
              "ok": free, "error": err})
        if not free:
            failures.append(("host sync in the conv's backward", err))
        del x, w, dy, tabs
        torch.cuda.empty_cache()

        # 2. the joint step at full width, whole batch and microbatch 1
        def joint_model(dtype):
            return MinkUNet34C(3, 64, compute_dtype=dtype,
                               generator=torch.Generator().manual_seed(0))

        joint = {}
        for mb in (0, 1):
            batch, t_c = sync_ms(lambda: collate_joint(
                joint_items, cap_multiple=4096, microbatch=mb))
            base = allocated_gib()  # the earlier phases' models and scenes
            state = steps.create_train_state(joint_model("bfloat16"), 0.0, DEVICE)
            step = steps.make_joint_train_step(state.model, cfg)
            losses, ms, peak = train_step_run(step, state, batch)
            joint[mb] = {"step_ms": ms, "collate_ms": t_c, "peak_gib": peak,
                         "peak_above_base_gib": peak - base, "losses": losses}
            if mb == 0:
                joint[mb]["profile"] = step_profile(step, state, batch)
            del state, step
            torch.cuda.empty_cache()
        whole = collate_joint(joint_items, cap_multiple=4096)
        emit({"phase": "train", "step": "joint", "scenes": len(joint_items),
              "voxels": [int(len(it[1])) for it in joint_items],
              "rows_l0": int(whole["feats"].shape[0]),
              **{f"microbatch_{k}": v for k, v in joint.items()}})

        # the bf16 step's gradients against a float32 step's
        models = {}
        for dtype in ("bfloat16", "float32"):
            state = steps.create_train_state(joint_model(dtype), 0.0, DEVICE)
            steps.make_joint_train_step(state.model, cfg)(state, whole, 1e-3, 0.5)
            models[dtype] = state
        per, glob, cos = grad_errors(models["float32"].model,
                                     models["bfloat16"].model)
        worst = max(per, key=per.get)
        vals = sorted(per.values())
        grads_ok = (per[worst] <= TRAIN_GRAD_WORST and glob <= TRAIN_GRAD_GLOBAL
                    and per["final.kernel"] <= TRAIN_HEAD_GRAD)
        emit({"phase": "train", "check": "bf16_grads_vs_f32", "tensors": len(per),
              "worst": {"tensor": worst, "rel_l2": per[worst]},
              "median_rel_l2": float(np.median(vals)), "global_rel_l2": glob,
              "cosine": cos, "head_rel_l2": per["final.kernel"],
              "bounds": [TRAIN_GRAD_WORST, TRAIN_GRAD_GLOBAL, TRAIN_HEAD_GRAD],
              "ok": grads_ok, "rel_l2": per})
        if not grads_ok:
            failures.append(("bf16 gradients", worst, per[worst], glob))
        del models
        torch.cuda.empty_cache()

        # five steps on the fixed batch lower the loss; BN statistics move
        state = steps.create_train_state(joint_model("bfloat16"), 0.0, DEVICE)
        step = steps.make_joint_train_step(state.model, cfg)
        before = {n: b.clone() for n, b in state.model.named_buffers()}
        curve = [float(step(state, whole, 1e-3, 0.5)[1]["loss"])
                 for _ in range(TRAIN_DESCENT + 1)]
        moved = sum(not torch.equal(b, before[n])
                    for n, b in state.model.named_buffers())
        finite = all(bool(torch.isfinite(b).all())
                     for b in state.model.buffers())
        descent_ok = (curve[-1] < curve[0] and moved == len(before) and finite
                      and all(np.isfinite(curve)))
        emit({"phase": "train", "check": "descent", "losses": curve,
              "bn_buffers_moved": moved, "bn_buffers": len(before),
              "finite": finite, "ok": descent_ok})
        if not descent_ok:
            failures.append(("loss did not fall", curve, moved, finite))
        del state, step, whole
        torch.cuda.empty_cache()

        # 3. the separate step, one category
        sbatch, t_c = sync_ms(lambda: collate_separate(
            sep_items, cap_multiple=4096, max_objects=cfg.tpu.max_objects))
        base = allocated_gib()
        state = steps.create_train_state(
            MinkUNet34C(3, 8, generator=torch.Generator().manual_seed(1)), 0.0,
            DEVICE)
        sstep = steps.make_separate_train_step(state.model, cfg,
                                               cfg.tpu.max_objects)
        losses, ms, peak = train_step_run(sstep, state, sbatch)
        emit({"phase": "train", "step": "separate", "scenes": len(sep_items),
              "objects": int(sbatch["num_objects"]), "step_ms": ms,
              "collate_ms": t_c, "peak_gib": peak,
              "peak_above_base_gib": peak - base, "losses": losses})
        if not all(np.isfinite(list(losses.values()))):
            failures.append(("separate losses", losses))
        del state, sstep, sbatch
        torch.cuda.empty_cache()

    # 4. the loops: LOOP_SCENES synthetic scenes (the JAX --synthetic
    # recipe's 4 x 2 x 4 m rooms), batch 3, process workers, two epochs
    # validated, then a second call that resumes and trains a third
    rng = np.random.RandomState(11)
    loop_scenes = [make_scene(rng, extent=(4.0, 2.0, 4.0), n_background=15000,
                              n_boxes=3, pts_per_box=2000)
                   for _ in range(LOOP_SCENES + LOOP_VAL)]
    lj, ls = train_items(loop_scenes)
    gts = {it[0]: [(NAME2CATNAME[IDX2NAME[ci]], c) for ci, c in s.gt_corners()]
           for it, s in zip(lj, loop_scenes)}
    cfg = load_config(None, ["batch_size=3", "num_workers=3",
                             "category=03001627"])
    # the resumed call collates in threads: no second worker pool to start
    cfg_resume = load_config(None, ["batch_size=3", "num_workers=1",
                                    "category=03001627"])
    runs, launches_sum = {}, {n: 0 for n in SOURCES}
    for name, run, items, per in (
            ("joint", run_joint_training, lj, VAL_JOINT),
            ("separate", run_separate_training, ls, VAL_SEPARATE)):
        with tempfile.TemporaryDirectory() as workdir:
            train_ds = ListDataset(items[:LOOP_SCENES])
            val_ds = ListDataset(items[LOOP_SCENES:])
            reset_counters()
            state, ret = run(cfg, train_ds, val_ds, workdir=workdir,
                             gt_lookup=gts.get, eval_every=1, max_epoch=1,
                             device=DEVICE)
            launches = read_counters()
            checks = loop_checks(name, state, ret, launches, per, LOOP_VAL, 2,
                                 workdir, (0, 1))
            first = list(state.history)
            reset_counters()
            state2, ret2 = run(cfg_resume, train_ds, val_ds, workdir=workdir,
                               gt_lookup=gts.get, eval_every=1, max_epoch=2,
                               device=DEVICE)
            launches2 = read_counters()
            loop_checks(name, state2, ret2, launches2, per, LOOP_VAL, 1,
                        workdir, (0, 1, 2))
            resumed = ([h["epoch"] for h in state2.history] == [2]
                       and state2.step
                       == state.step + state2.history[0]["batches"])
            for n in SOURCES:
                launches_sum[n] += launches[n] + launches2[n]
            runs[name] = {
                "epochs": first + state2.history,
                "scenes_per_s": [h["scenes"] / h["seconds"]
                                 for h in first + state2.history],
                "map": {str(t): ret2[t]["mAP"] for t in (0.25, 0.5)},
                "launches": launches, "resume_launches": launches2,
                "checks": checks, "resumed": resumed}
            emit({"phase": "train", "loop": name, "train_scenes": LOOP_SCENES,
                  "val_scenes": LOOP_VAL, "batch_size": cfg.batch_size,
                  "workers": cfg.num_workers,
                  "resume_workers": cfg_resume.num_workers, **runs[name]})
            if not resumed:
                failures.append((name, "loop did not resume",
                                 state2.history, state2.step))
            del state, state2
            torch.cuda.empty_cache()
    emit({"phase": "train", "total_s": time.perf_counter() - t_phase,
          "failures": failures})
    assert not failures, failures
    return launches_sum


# ---------------------------------------------------------------------------
# float32 grids: rows 1-3, 6 and 7 at conv_dtype=float32

# the float32 kernels (exact float32 products, no TF32) against their plain
# versions on the card (float32 matmuls, TF32 off): float32 sums in another
# order, 1e-5 of each output's peak
F32_REL_TOL = 1e-5
# the float32 dense backbone against the float32 sparse one (cuBLAS
# without TF32): float32 sums in another order through 47 convs and their
# norms, 1e-4 of the float32 rows' peak
F32_BACKBONE_TOL = 1e-4
# the float32 rows: the wrappers whose float32 launches count apart
F32_ROWS = ("tiled_conv3d", "tiled_conv3d_prefolded", "tiled_down2",
            "tiled_up2", "tiled_up2_into", "tiled_block3d")
# one float32 pass of each path: the joint (47 convs, 4 downs, 4 ups) and
# the nine categories (46 convs and the prefolded stem, 4 downs, 4 ups
# each); no path runs the fused block
F32_JOINT = {"tiled_conv3d": 47, "tiled_conv3d_prefolded": 0,
             "tiled_down2": 4, "tiled_up2": 4, "tiled_up2_into": 0,
             "tiled_block3d": 0}
F32_SEPARATE = {"tiled_conv3d": 9 * 46, "tiled_conv3d_prefolded": 9,
                "tiled_down2": 36, "tiled_up2": 36, "tiled_up2_into": 0,
                "tiled_block3d": 0}
# the joint pass with up_impl="into": the ups into L1 and L0 write into
# their skip's grid (row 7)
F32_JOINT_INTO = {**F32_JOINT, "tiled_up2": 2, "tiled_up2_into": 2}


# the CUDA kernels of each float32 row
F32_KERNELS = {
    "tiled_conv3d": "compact_kernel, conv_rows_f32_kernel, split_reduce_f32_kernel, "
                    "dead_rows_kernel<float>",
    "tiled_conv3d_prefolded": "compact_kernel, conv_rows_f32_kernel (x taps)",
    "tiled_down2": "compact_kernel, conv_rows_f32_kernel (down), "
                   "split_reduce_f32_kernel",
    "tiled_up2": "compact_kernel, up_rows_f32_kernel, skip_copy_kernel<float>",
    "tiled_up2_into": "compact_kernel, up_rows_f32_kernel (into), "
                      "up_dead_kernel<float>",
    "tiled_block3d": "compact_kernel (row map), conv_rows_f32_kernel (conv1 into "
                     "the compact mid), conv_rows_f32_kernel (conv2 through the "
                     "row map), split_reduce_f32_kernel, dead_rows_kernel<float>"}


def read_f32():
    return {n: counters()[n].launches_f32 for n in F32_ROWS}


def reset_f32():
    for n in F32_ROWS:
        counters()[n].launches_f32 = 0


def f32_unoccupied_zeros(name, got, a, kw):
    """Exact zeros at the unoccupied listed cells of a call whose output
    there is zero (no residual, or the into-conv's conv channels)."""
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    if name == "tiled_conv3d" and kw.get("residual") is not None \
            and kw.get("res_w") is None:
        return None  # the plain residual is written there
    if name in ("tiled_up2", "tiled_conv3d") and kw.get("occ") is None:
        return None
    flat = tc._flat(tc._row_cells(a[2], kw["tile_shape"]), got.shape)
    unocc = kw["occ"].reshape(-1)[flat] == 0
    c0 = kw.get("skip_c", 0) if name == "tiled_up2_into" else 0
    c1 = got.shape[3] - (kw.get("skip_c", 0) if name == "tiled_up2" else 0)
    return bool((got.reshape(-1, got.shape[3])[flat[unocc], c0:c1] == 0).all())


def phase_f32(scenes):
    """Float32 grids through rows 1-3, 6, 7 and 9 (tpu.conv_dtype=float32):
    every configuration of the float32 joint path (default and
    up_impl="into") and the separate path's prefolded stem, recorded on
    scene 0, against its plain version (F32_REL_TOL of each output's
    peak), a repeat (bitwise) and exact zeros at its unoccupied listed
    cells, timed as phase 1 times the bf16 rows and summed by level; the
    unmasked checks at float32; the fused block on the recorded input of
    each of the float32 joint pass's 23 BasicBlocks, as phase 1 holds the
    bf16 block (its plain version within F32_REL_TOL, the two float32 convs
    and a repeat bit for bit, launches_f32 exactly 23); the float32 joint
    path (three scenes, default and up_impl="into") and the separate
    evaluator (three scenes, nine categories) with planted tails: exact
    float32 launch counts, no bf16 launch, per-stage ms (default routes),
    scenes/s and peak memory; the float32 dense backbone against the
    float32 sparse one; eval_joint (three scans) and eval_separate (two) with
    tpu.conv_dtype=float32 over the scenes written as a ScanNet tree:
    exact float32 launch counts, no bf16 launch, a finite mAP. Returns
    (summary by row, launches)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc
    from canonicalvoting_tpu_torch import eval_joint, eval_separate
    from canonicalvoting_tpu_torch.data.synthetic_tree import write_scannet_tree

    t_phase = time.perf_counter()
    failures = []
    plain = {"tiled_conv3d": tc.tiled_conv3d_plain,
             "tiled_conv3d_prefolded": drop_wt(tc.tiled_conv3d_prefolded_plain),
             "tiled_down2": drop_wt(tc.tiled_down2_plain),
             "tiled_up2": tc.tiled_up2_plain,
             "tiled_up2_into": tc.tiled_up2_into_plain}
    kern = counters()
    pipe = build_pipeline("float32")
    sep = build_separate(compute_dtype="float32")
    scene = scenes[0]
    args = pipe.prepare_scene(scene.points, scene.rgb)
    sep_args = sep.prepare_quantized(*quantize(scene))
    records = {}
    with patched(du, **{n: recorder(records, du, n) for n in
                        ("tiled_conv3d", "tiled_down2", "tiled_up2")}):
        pipe.run_backbone(args)
    with variants(pipe), patched(
            du, tiled_up2_into=recorder(records, du, "tiled_up2_into")):
        pipe.run_backbone(args)
    with patched(du, tiled_conv3d_prefolded=recorder(
            records, du, "tiled_conv3d_prefolded")):
        sep.backbones(sep_args)
    occ_of = {tuple(r["kw"]["occ"].shape): r["kw"]["occ"]
              for r in records.values() if r["name"] == "tiled_conv3d"}
    levels = {shape: i for i, shape in enumerate(sorted(
        occ_of, key=lambda sh: -sh[0] * sh[1] * sh[2]))}
    summary = {n: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
                   "operations": 0.0, "host_ms": 0.0, "device_ms": 0.0,
                   "fill_ms": 0.0 if n in FILLED else None}
               for n in F32_ROWS}
    by_level = {n: {} for n in (*ROW_KERNELS, "tiled_block3d")}
    for key, r in records.items():
        name, a, kw = r["name"], r["args"], r["kw"]
        assert a[0].dtype == torch.float32, (key, a[0].dtype)
        got, again = kern[name](*a, **fresh(kw)), kern[name](*a, **fresh(kw))
        want = plain[name](*a, **fresh(kw))
        err, scale = (rel_err(into_conv_rows(got, a, kw), into_conv_rows(want, a, kw))
                      if name == "tiled_up2_into" else rel_err(got, want))
        extra = {"level": levels[tuple(kw["occ"].shape)],
                 "bitwise_repeat": bool(torch.equal(got, again))}
        zeros = f32_unoccupied_zeros(name, got, a, kw)
        if zeros is not None:
            extra["unoccupied_exact_zeros"] = zeros
        if not (err <= F32_REL_TOL * scale and extra["bitwise_repeat"]
                and zeros is not False):
            failures.append((key, err, F32_REL_TOL * scale, extra))
        del got, again, want
        kw_k, kw_p = fresh(kw), fresh(kw)
        ms = time_ms(lambda: kern[name](*a, **kw_k), 5)
        extra["host_ms"] = host_ms(lambda: kern[name](*a, **kw_k), 5)
        extra["device_ms"] = device_ms(lambda: kern[name](*a, **kw_k), 5,
                                       extra["host_ms"])
        plain_ms = time_ms(lambda: plain[name](*a, **kw_p), 2)
        del kw_k, kw_p
        fill_ms = time_ms(fill_call(r), 5) if name in FILLED else None
        lib_ms = time_ms(library_call(r), 3)
        (bound_ms, bound_by), work = (prefold_bound(r)
                                      if name == "tiled_conv3d_prefolded"
                                      else conv_bound(r, occ_of))
        extra.update(work)
        n, s = r["count"], summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                     (bound_by, bound_ms), ("library_ms", lib_ms),
                     ("host_ms", extra["host_ms"]),
                     ("device_ms", extra["device_ms"])):
            s[k] += v * n
        if fill_ms is not None:
            s["fill_ms"] += fill_ms * n
        add_level(by_level, name, extra["level"], n, ms=ms,
                  device_ms=extra["device_ms"], bound_ms=bound_ms, fill_ms=fill_ms)
        emit({"phase": "f32", "kernel": name, "config": [str(v) for v in key[1:]],
              "per_scene": n, "max_abs_err": err, "ref_max": scale,
              "tol": F32_REL_TOL * scale, "kernel_ms": ms, "fill_ms": fill_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, **extra})
    unmasked_checks(records, kern, plain, levels, failures,
                    rel_tol=F32_REL_TOL, phase="f32")
    records.clear()
    occ_of.clear()
    torch.cuda.empty_cache()
    phase1_blocks(pipe, args, summary["tiled_block3d"], levels, by_level,
                  failures, rel_tol=F32_REL_TOL, phase="f32")
    torch.cuda.empty_cache()
    emit({"phase": "f32", "by_level": by_level})
    for s in summary.values():
        s["bound_by"] = "bytes" if s.pop("bytes") >= s.pop("operations") \
            else "operations"

    # the paths at float32, planted tails
    launches = {n: 0 for n in F32_ROWS}
    paths = {}
    for path, per in (("joint", F32_JOINT), ("joint_into", F32_JOINT_INTO),
                      ("separate", F32_SEPARATE)):
        if path.startswith("joint"):
            prepped = [pipe.prepare_scene(s.points, s.rgb) for s in scenes]
            planted = [planted_rows(s, p) for s, p in zip(scenes, prepped)]
            up_impl = "into" if path == "joint_into" else "concat"

            def run(p, r):
                with variants(pipe, up_impl=up_impl, hv_method=pipe.hv_method):
                    return run_planted(pipe, p, r)[1]["n_boxes"]
        else:
            prepped = [sep.prepare_quantized(*quantize(s)) for s in scenes]
            planted = [separate_rows(s, p, len(sep.categories))
                       for s, p in zip(scenes, prepped)]

            def run(p, r):
                return sep.run_scene(p, planted=r)["n_boxes"]
        for p, r in zip(prepped, planted):  # warm-up
            run(p, r)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        reset_f32()
        t0 = time.perf_counter()
        boxes = [run(p, r) for p, r in zip(prepped, planted)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        got, bf16 = read_f32(), read_counters()
        stages = ([stage_times(pipe, s) for s in scenes] if path == "joint"
                  else [separate_stage_times(sep, p, r)
                        for p, r in zip(prepped, planted)]
                  if path == "separate" else [{}])
        paths[path] = {
            "scenes": len(scenes), "scenes_per_s": len(scenes) / elapsed,
            "n_boxes": [b.tolist() if b.dim() else int(b) for b in boxes],
            "launches_f32": got,
            "stage_ms": {k: float(np.median([s[k] for s in stages]))
                         for k in stages[0]},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        for k in F32_ROWS:
            launches[k] += got[k]
        if got != {k: v * len(scenes) for k, v in per.items()} or any(
                bf16[k] for k in F32_ROWS):
            failures.append((path, "launches", got, bf16))
        if sum(int(np.sum(b.tolist())) for b in boxes) < len(scenes):
            failures.append((path, "planted boxes lost", paths[path]["n_boxes"]))
        del prepped, planted
        torch.cuda.empty_cache()
    emit({"phase": "f32", "paths": paths})

    # the float32 dense backbone against the float32 sparse one
    dargs, sargs, _ = sparse_prep(scene, pipe)
    _, f32 = sparse_models(pipe.model, pipe.model.state_dict())
    n = sargs.pyramid["nvalid"][0]
    ref = f32(sargs.feats, sargs.pyramid)
    peak = float(ref[:n].abs().max())
    errs = backbone_errors(ref, pipe.run_backbone(dargs), n)
    backbone = {**errs, "f32_peak": peak, "limit": F32_BACKBONE_TOL * peak,
                "ms": {"dense_f32": time_ms(lambda: pipe.run_backbone(dargs), 3),
                       "sparse_f32": time_ms(lambda: f32(sargs.feats,
                                                         sargs.pyramid), 3)}}
    emit({"phase": "f32", "check": "dense_vs_sparse_backbone", **backbone})
    if errs["max_abs_err"] > F32_BACKBONE_TOL * peak:
        failures.append(("dense f32 backbone against sparse f32", errs))
    del dargs, sargs, f32, ref
    torch.cuda.empty_cache()

    # eval_joint (three scans) and eval_separate (two) with
    # tpu.conv_dtype=float32 over a ScanNet tree
    root = tempfile.mkdtemp(prefix="chip_smoke_f32_")
    try:
        ids = [f"scene{i:04d}_00" for i in range(len(scenes))]
        overrides = write_scannet_tree(root, scenes, ids) + [
            f"scannet_res={RES}", "tpu.conv_dtype=float32"]
        split = os.path.join(root, "split_separate.txt")
        with open(split, "w") as f:
            f.write("\n".join(ids[:N_SEPARATE_SCENES]) + "\n")
        for name, main, argv, per, n in (
                ("eval_joint", eval_joint.main, overrides, F32_JOINT, len(ids)),
                ("eval_separate", eval_separate.main,
                 overrides + [f"data.val_split={split}"], F32_SEPARATE,
                 N_SEPARATE_SCENES)):
            torch.cuda.synchronize()
            reset_counters()
            reset_f32()
            t0 = time.perf_counter()
            results = main(argv)
            cli_s = time.perf_counter() - t0
            got, bf16 = read_f32(), read_counters()
            cli = {"scenes": n, "seconds": cli_s, "launches_f32": got,
                   "mAP": {str(t): float(d["mAP"]) for t, d in results.items()}}
            emit({"phase": "f32", "cli": name, **cli})
            for k in F32_ROWS:
                launches[k] += got[k]
            if got != {k: v * n for k, v in per.items()} or any(
                    bf16[k] for k in F32_ROWS) or not all(
                    np.isfinite(v) for v in cli["mAP"].values()):
                failures.append((f"{name} at float32", cli, bf16))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del pipe, sep
    torch.cuda.empty_cache()
    emit({"phase": "f32", "total_s": time.perf_counter() - t_phase,
          "failures": [str(f)[:400] for f in failures]})
    assert not failures, failures
    return summary, launches


# ---------------------------------------------------------------------------
# the dense training route, remat, the Hough backward

# the dense step's gradients against the gather step's, float32, TF32 off:
# the JAX package's tolerance and plan for that comparison
# (tests/test_train.py:144-226); full width is printed beside the
# gradient's own sensitivity to a 1e-6 perturbation of the weights
DENSE_GRAD_ATOL, DENSE_GRAD_RTOL = 5e-4, 5e-3
DENSE_PARITY_PLAN = dict(layers=(1,) * 8, planes=(8, 16, 32, 32, 32, 32, 16, 16),
                         init_dim=8)
# at full width the step's gradients, all tensors as one vector, within
# this relative L2 of the gather step's: between the dense route's 2.3e-3
# and the 1.25e-2 by which a 1e-6 weight perturbation moves the gather
# step itself (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
DENSE_GRAD_FULL_L2 = 6e-3
# the Hough backward on the card against its CPU route, of each
# gradient's peak: float32 sums over the rotations in another order
HOUGH_GRAD_TOL = 1e-4


def dense_memory_reckoning(prepped_dims):
    """The bytes one bf16 grid of the L0 level holds at 96 channels, and a
    scene's saved activations without remat by the count of L0/L1 grids
    the backward keeps (the printout's reckoning; PERF.md)."""
    from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ

    x, y, z = prepped_dims
    cells = (x + 2 * MX) * (y + 2 * MY) * (z + 2 * MZ)
    grid = cells * 96 * 2
    # L0: stem output and its norm (32 ch), the up's output and norm (96),
    # the concat (128), two blocks of four 96-channel grids; L1 an eighth
    l0 = cells * 2 * (2 * 32 + 2 * 96 + 128 + 8 * 96)
    return {"l0_cells": cells, "grid_96ch_gb": grid / 1e9,
            "saved_per_scene_gb": l0 * (1 + 1 / 8 + 1 / 64) / 1e9}


def loop_scene_items(n):
    """n of the loops' 4 x 2 x 4 m synthetic scenes as (joint, separate)
    items, and their ground truth."""
    import numpy as np

    from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME
    from canonicalvoting_tpu_torch.data.synthetic import make_scene

    rng = np.random.RandomState(11)
    scenes = [make_scene(rng, extent=(4.0, 2.0, 4.0), n_background=15000,
                         n_boxes=3, pts_per_box=2000) for _ in range(n)]
    lj, ls = train_items(scenes)
    gts = {it[0]: [(NAME2CATNAME[IDX2NAME[ci]], c) for ci, c in s.gt_corners()]
           for it, s in zip(lj, scenes)}
    return lj, ls, gts


def phase_train_dense(scenes):
    """The dense training route (tpu.train_backbone=dense) on the card:
    float32 parity of the dense step's gradients with the gather step's
    on the loops' scenes (TF32 off); the joint dense step at full width
    (MinkUNet34C(3 -> 64), bf16, the three bench scenes, microbatch 1)
    with and without remat: step ms, peak memory beside the reckoning,
    five steps lowering the loss, every BN buffer moved and finite; one
    separate dense step; one epoch of each loop with
    tpu.conv_dtype=float32, validated on the float32 kernels. Returns the
    loops' float32 launches."""
    import tempfile

    import numpy as np
    import torch

    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.data.collate import (
        collate_joint, collate_joint_dense, collate_separate)
    from canonicalvoting_tpu_torch.data.loader import ListDataset
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C, MinkUNetBase
    from canonicalvoting_tpu_torch.train import steps
    from canonicalvoting_tpu_torch.train.joint_loop import run_joint_training
    from canonicalvoting_tpu_torch.train.separate_loop import run_separate_training

    t_phase = time.perf_counter()
    failures = []
    cfg = load_config(None, [])
    lj, ls, gts = loop_scene_items(LOOP_SCENES + LOOP_VAL)

    def joint_model(dtype, seed=0):
        return MinkUNet34C(3, 64, compute_dtype=dtype,
                           generator=torch.Generator().manual_seed(seed))

    with torch.enable_grad():
        # 1. parity, float32, one loop scene a step: the JAX package's own
        # plan for this comparison at its tolerance; then full width within
        # DENSE_GRAD_FULL_L2, beside the gradient's sensitivity (a 1e-6
        # relative weight perturbation)
        items = lj[:1]
        grads = {}
        for run, plan, backbone, perturb in (
                ("plan_gather", DENSE_PARITY_PLAN, "gather", 0.0),
                ("plan_dense", DENSE_PARITY_PLAN, "dense", 0.0),
                ("full_gather", {}, "gather", 0.0),
                ("full_dense", {}, "dense", 0.0),
                ("full_gather_perturbed", {}, "gather", 1e-6)):
            model = (MinkUNetBase(3, 64, compute_dtype="float32",
                                  generator=torch.Generator().manual_seed(0),
                                  **plan) if plan else joint_model("float32"))
            if perturb:
                g = torch.Generator().manual_seed(3)
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
            state = (steps.create_train_state_dense(model, 0.0, DEVICE)
                     if backbone == "dense"
                     else steps.create_train_state(model, 0.0, DEVICE))
            batch = (collate_joint_dense if backbone == "dense"
                     else collate_joint)(items, cap_multiple=4096)
            step = steps.make_joint_train_step(state.model, cfg, backbone=backbone)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                _, losses = step(state, batch, 0.0, 0.5)
            grads[run] = ({n: p.grad.clone() for n, p in
                           state.model.named_parameters()},
                          float(losses["loss"]))
            del state, step, model
            torch.cuda.empty_cache()

        def compare(ref, got):
            (gg, lg), (gd, ld) = grads[ref], grads[got]
            worst, n_bad = ("", 0.0), 0
            for name, want in gg.items():
                d = (gd[name] - want).abs()
                n_bad += int((d > DENSE_GRAD_ATOL
                              + DENSE_GRAD_RTOL * want.abs()).sum())
                rel = float(d.max()) / max(float(want.abs().max()), 1e-30)
                worst = max(worst, (name, rel), key=lambda t: t[1])
            a = torch.cat([gd[n].flatten() for n in gg])
            b = torch.cat([gg[n].flatten() for n in gg])
            return {"loss": [lg, ld], "loss_rel_err": abs(ld - lg) / abs(lg),
                    "elements": int(b.numel()), "elements_outside_tol": n_bad,
                    "worst_tensor": {"name": worst[0], "peak_rel_err": worst[1]},
                    "global_rel_l2": float((a - b).norm() / b.norm())}

        parity = {"plan": compare("plan_gather", "plan_dense"),
                  "full_width": compare("full_gather", "full_dense"),
                  "full_width_sensitivity": compare("full_gather",
                                                    "full_gather_perturbed"),
                  "tol": [DENSE_GRAD_ATOL, DENSE_GRAD_RTOL],
                  "full_width_l2_limit": DENSE_GRAD_FULL_L2,
                  "plan_planes": DENSE_PARITY_PLAN["planes"],
                  "voxels": int(len(items[0][1]))}
        emit({"phase": "train_dense", "check": "grads_vs_gather_f32", **parity})
        if parity["plan"]["elements_outside_tol"] or \
                parity["plan"]["loss_rel_err"] > 1e-4:
            failures.append(("dense grads against gather", parity["plan"]))
        if parity["full_width"]["global_rel_l2"] > DENSE_GRAD_FULL_L2 or \
                parity["full_width"]["loss_rel_err"] > 1e-4:
            failures.append(("dense grads against gather at full width",
                             parity["full_width"]))
        del grads

        # 2. full width, bf16, the three bench scenes, microbatch 1
        joint_items, sep_items = train_items(scenes)
        batch, t_c = sync_ms(lambda: collate_joint_dense(
            joint_items, cap_multiple=4096, microbatch=1))
        dims = batch["meta"]["grid_dims"]
        reckon = dense_memory_reckoning(dims)
        full = {}
        for remat in (False, True):
            base = allocated_gib()
            state = steps.create_train_state_dense(joint_model("bfloat16"), 0.0,
                                                   DEVICE, remat=remat)
            step = steps.make_joint_train_step(state.model, cfg, backbone="dense")
            losses, ms, peak = train_step_run(step, state, batch, reps=2)
            full[f"remat_{remat}"] = {"step_ms": ms, "peak_gib": peak,
                                      "peak_above_base_gib": peak - base,
                                      "losses": losses}
            if not remat:  # five more steps lower the loss
                before = {n: b.clone() for n, b in state.model.named_buffers()}
                curve = [losses["loss"]] + [
                    float(step(state, batch, 1e-3, 0.5)[1]["loss"])
                    for _ in range(TRAIN_DESCENT)]
                moved = sum(not torch.equal(b, before[n])
                            for n, b in state.model.named_buffers())
                finite = all(bool(torch.isfinite(b).all())
                             for b in state.model.buffers())
                full["descent"] = {"losses": curve, "bn_buffers_moved": moved,
                                   "bn_buffers": len(before), "finite": finite}
                if not (curve[-1] < curve[0] and moved == len(before)
                        and finite and all(np.isfinite(curve))):
                    failures.append(("dense loss did not fall", full["descent"]))
            del state, step
            torch.cuda.empty_cache()
        emit({"phase": "train_dense", "step": "joint", "scenes": len(joint_items),
              "microbatch": 1, "grid_dims": list(dims), "collate_ms": t_c,
              "reckoning": reckon, **full})
        del batch

        # 3. one separate dense step (MinkUNet34C(3, 8))
        sbatch = collate_separate(sep_items, cap_multiple=4096,
                                  max_objects=cfg.tpu.max_objects, dense=True,
                                  microbatch=1)
        base = allocated_gib()
        state = steps.create_train_state_dense(
            MinkUNet34C(3, 8, generator=torch.Generator().manual_seed(1)), 0.0,
            DEVICE)
        sstep = steps.make_separate_train_step(state.model, cfg,
                                               cfg.tpu.max_objects,
                                               backbone="dense")
        losses, ms, peak = train_step_run(sstep, state, sbatch, reps=1)
        emit({"phase": "train_dense", "step": "separate", "step_ms": ms,
              "peak_gib": peak, "peak_above_base_gib": peak - base,
              "losses": losses})
        if not all(np.isfinite(list(losses.values()))):
            failures.append(("separate dense losses", losses))
        del state, sstep, sbatch
        torch.cuda.empty_cache()

    # 4. one epoch of each loop, dense and float32, validated on the
    # float32 kernels
    loops_cfg = load_config(None, ["batch_size=3", "num_workers=0",
                                   "category=03001627",
                                   "tpu.train_backbone=dense",
                                   "tpu.conv_dtype=float32"])
    launches = {n: 0 for n in F32_ROWS}
    for name, run, items, per in (
            ("joint", run_joint_training, lj, F32_JOINT),
            ("separate", run_separate_training, ls,
             {k: v // 9 for k, v in F32_SEPARATE.items()})):
        with tempfile.TemporaryDirectory() as workdir:
            reset_f32()
            t0 = time.perf_counter()
            state, ret = run(loops_cfg, ListDataset(items[:LOOP_SCENES]),
                             ListDataset(items[LOOP_SCENES:]), workdir=workdir,
                             gt_lookup=gts.get, eval_every=1, max_epoch=0,
                             device=DEVICE)
            got = read_f32()
            ok = (type(state.model).__name__ == "DenseMinkUNet"
                  and state.model.compute_dtype == "float32"
                  and state.step == LOOP_SCENES // loops_cfg.batch_size
                  and got == {k: v * LOOP_VAL for k, v in per.items()}
                  and ret is not None and all(np.isfinite(ret[t]["mAP"])
                                              for t in (0.25, 0.5)))
            emit({"phase": "train_dense", "loop": name,
                  "seconds": time.perf_counter() - t0, "epochs": state.history,
                  "launches_f32": got, "ok": ok,
                  "map": None if ret is None else {
                      str(t): ret[t]["mAP"] for t in (0.25, 0.5)}})
            if not ok:
                failures.append((name, "dense loop", got, state.step))
            for k in F32_ROWS:
                launches[k] += got[k]
            del state
            torch.cuda.empty_cache()
    emit({"phase": "train_dense", "total_s": time.perf_counter() - t_phase,
          "failures": [str(f)[:400] for f in failures]})
    assert not failures, failures
    return launches


def phase_train_remat(scenes):
    """Block remat on the gather step at full width (MinkUNet34C(3 -> 64),
    bf16): step ms and peak memory with and without it on the three bench
    scenes as one batch (the default mode: the card's index_add_ sums in
    no fixed order, so the two differ by that order); then, with the
    deterministic algorithms on (index_add_ in a fixed order, ~50x slower)
    on scene 0, the step with remat equals the step without it bit for bit
    (loss, gradients, running statistics). Each running statistic is
    updated once a step (two in-place ops a buffer). Then one epoch of
    each loop with tpu.train_remat=true: every block of every step
    recomputed once, a checkpoint, the validation on the dense kernels
    and a finite mAP. Returns the loops' kernel launches."""
    import tempfile

    import torch

    import canonicalvoting_tpu_torch.models.norm as norm
    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.data.collate import collate_joint
    from canonicalvoting_tpu_torch.data.loader import ListDataset
    from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C, MinkUNetBase
    from canonicalvoting_tpu_torch.train import steps
    from canonicalvoting_tpu_torch.train.joint_loop import run_joint_training
    from canonicalvoting_tpu_torch.train.separate_loop import run_separate_training

    t_phase = time.perf_counter()
    cfg = load_config(None, [])
    joint_items, _ = train_items(scenes)

    def one_step(remat, batch, again=True):
        model = MinkUNet34C(3, 64, generator=torch.Generator().manual_seed(0))
        state = steps.create_train_state(model, 0.0, DEVICE, remat=remat)
        step = steps.make_joint_train_step(state.model, cfg)
        versions = {n: b._version for n, b in state.model.named_buffers()}
        torch.cuda.synchronize()
        base = allocated_gib()
        torch.cuda.reset_peak_memory_stats()
        (_, losses), ms = sync_ms(lambda: step(state, batch, 0.0, 0.5))
        out = {"loss": losses["loss"].clone(), "step_ms": ms,
               "peak_above_base_gib": torch.cuda.max_memory_allocated() / 2 ** 30
               - base,
               "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
               "stats": {n: b.clone() for n, b in state.model.named_buffers()},
               "bumps": {n: b._version - versions[n]
                         for n, b in state.model.named_buffers()}}
        if again:  # a second step, the allocator warm
            out["timed_ms"] = sync_ms(lambda: step(state, batch, 0.0, 0.5))[1]
        del state, step, model
        torch.cuda.empty_cache()
        return out

    with torch.enable_grad():
        batch = collate_joint(joint_items, cap_multiple=4096)
        timed = {r: one_step(r, batch) for r in (False, True)}
        batch = collate_joint(joint_items[:1], cap_multiple=4096)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = {r: one_step(r, batch, again=False) for r in (False, True)}
        finally:
            torch.use_deterministic_algorithms(False)
    a, b = det[False], det[True]
    equal = {"loss": bool(torch.equal(a["loss"], b["loss"])),
             "grads": all(torch.equal(a["grads"][n], g)
                          for n, g in b["grads"].items()),
             "stats": all(torch.equal(a["stats"][n], v)
                          for n, v in b["stats"].items())}
    once = all(set(r["bumps"].values()) == {2}
               for r in (a, b, timed[False], timed[True]))
    # in the default mode the two steps differ by index_add_'s order
    d_worst = max((float((timed[True]["grads"][n] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30), n)
                  for n, g in timed[False]["grads"].items())
    out = {"deterministic_bitwise_equal": equal, "stats_updated_once": once,
           "default_mode_grad_worst_peak_rel": d_worst[0],
           "default_mode_grad_worst_tensor": d_worst[1],
           "step_ms": {"plain": timed[False]["timed_ms"],
                       "remat": timed[True]["timed_ms"],
                       "plain_deterministic_scene0": a["step_ms"],
                       "remat_deterministic_scene0": b["step_ms"]},
           "peak_above_base_gib": {"plain": timed[False]["peak_above_base_gib"],
                                   "remat": timed[True]["peak_above_base_gib"]},
           "total_s": time.perf_counter() - t_phase}
    emit({"phase": "train_remat", **out})
    assert all(equal.values()) and once, out

    # one epoch of each loop with remat, validated on the dense kernels
    lj, ls, gts = loop_scene_items(LOOP_SCENES + LOOP_VAL)
    loops_cfg = load_config(None, ["batch_size=3", "num_workers=0",
                                   "category=03001627", "tpu.train_remat=true"])
    frozen, recomputed = norm.frozen_running_stats, []

    @contextlib.contextmanager
    def counted():  # entered when the backward recomputes a block
        recomputed.append(1)
        with frozen():
            yield

    launches_sum, failures = {n: 0 for n in SOURCES}, []
    for name, run, items, per in (
            ("joint", run_joint_training, lj, VAL_JOINT),
            ("separate", run_separate_training, ls, VAL_SEPARATE)):
        with tempfile.TemporaryDirectory() as workdir, \
                patched(norm, frozen_running_stats=counted):
            del recomputed[:]
            reset_counters()
            t0 = time.perf_counter()
            state, ret = run(loops_cfg, ListDataset(items[:LOOP_SCENES]),
                             ListDataset(items[LOOP_SCENES:]), workdir=workdir,
                             gt_lookup=gts.get, eval_every=1, max_epoch=0,
                             device=DEVICE)
            launches = read_counters()
            checks = loop_checks(name, state, ret, launches, per, LOOP_VAL, 1,
                                 workdir, (0,))
            model = state.model
            blocks = sum(model.layers) * state.step
            loop = {"seconds": time.perf_counter() - t0, "epochs": state.history,
                    "steps": state.step, "blocks_recomputed": len(recomputed),
                    "blocks_expected": blocks, "launches": launches,
                    "checks": checks,
                    "map": {str(t): ret[t]["mAP"] for t in (0.25, 0.5)}}
            emit({"phase": "train_remat", "loop": name, **loop})
            if not (type(model) is MinkUNetBase and model.remat
                    and state.step == LOOP_SCENES // loops_cfg.batch_size
                    and len(recomputed) == blocks):
                failures.append((name, "remat loop", loop))
            for n in SOURCES:
                launches_sum[n] += launches[n]
            del state, model
            torch.cuda.empty_cache()
    emit({"phase": "train_remat", "loops_total_s": time.perf_counter() - t_phase,
          "failures": [str(f)[:400] for f in failures]})
    assert not failures, failures
    return launches_sum


def phase_hough_backward(pipe, scenes):
    """The Hough-voting backward (hough_backward_obj) at the joint scene's
    configuration: 61,440 rows, 120 rotations, scene 0's vote grid, its
    planted head rows and a random cotangent; the card's gradients against
    the CPU route's within HOUGH_GRAD_TOL of each gradient's peak, the
    call timed, and no host sync inside; through the autograd Function
    too."""
    import torch

    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import (
        clipped_grid_dims, compute_corners, hough_backward_obj, hough_voting)

    scene = scenes[0]
    args = pipe.prepare_scene(scene.points, scene.rgb)
    xyz, scale, _, prob = slice_joint_heads(planted_rows(scene, args))
    scale = torch.exp(scale)
    corners = compute_corners(args.coords_w, args.valid)
    dims = clipped_grid_dims(corners, RES, args.grid_shape)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    g_obj = torch.rand(args.grid_shape, generator=g, device=DEVICE) * 2 - 1
    inputs = (args.coords_w, xyz, scale, prob, corners[0], dims)

    def call(dev):
        t = [x.to(dev) for x in inputs]
        return hough_backward_obj(*t, RES, NUM_ROTS, args.grid_shape,
                                  g_obj.to(dev), args.valid.to(dev))

    card, cpu = call(DEVICE), call("cpu")
    errs = {}
    for name, a, b in zip(("d_xyz", "d_scale", "d_obj"), card, cpu):
        peak = float(b.abs().max())
        errs[name] = {"max_abs_err": float((a.cpu() - b).abs().max()),
                      "peak": peak, "tol": HOUGH_GRAD_TOL * peak}
    free, why = sync_free(lambda: call(DEVICE))
    ms = time_ms(lambda: call(DEVICE), 5)
    # the Function: grid_obj's cotangent, the others discarded
    x, s, o = (t.detach().clone().requires_grad_() for t in (xyz, scale, prob))
    with torch.enable_grad():
        go, gr, gs = hough_voting(args.coords_w, x, s, o, res=RES,
                                  num_rots=NUM_ROTS, grid_shape=args.grid_shape,
                                  corners=corners, valid=args.valid)
        ((go * g_obj).sum() + gr.sum() + gs.sum()).backward()
    function_equal = all(torch.equal(a, b) for a, b in
                         zip((x.grad, s.grad, o.grad), card))
    out = {"rows": int(args.coords_w.shape[0]), "valid_rows": int(args.valid.sum()),
           "rotations": NUM_ROTS, "grid_shape": list(args.grid_shape),
           "errors": errs, "sync_free": free, "sync_error": why, "ms": ms,
           "function_equal": function_equal}
    emit({"phase": "hough_backward", **out})
    assert all(e["max_abs_err"] <= e["tol"] and e["peak"] > 0
               for e in errs.values()), errs
    assert free, why
    assert function_equal, "the Function's gradients differ from the call's"


# ---------------------------------------------------------------------------
# the parallel phase: scene-parallel evaluation and point-sharded voting over
# torch.distributed ranks

PARALLEL_DIR = "build/parallel"
# timed all-reduces of the 6-channel int64 vote grid between the two ranks
REDUCE_REPS = 3


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def planted_heads(joint=None, separate=None, record=None):
    """The pipelines' backbones run (and count their launches); the tails
    decode the planted head rows (host arrays) of the scene with as many
    voxels, ``joint`` (cap, 64) and ``separate`` (C, cap, 8) by voxel
    count. ``record`` (a dict) gets the backbones' own rows, as host
    arrays by voxel count under "joint" and "separate". Restored on
    exit."""
    import torch

    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.eval.separate import (
        SeparateDetectionPipeline)

    run_backbone = DetectionPipeline.run_backbone
    backbones = SeparateDetectionPipeline.backbones

    def rows(table, pipe, args, own, kind):
        n = int(args.valid.sum())
        if record is not None:
            record.setdefault(kind, {})[n] = own.cpu().numpy()
        return torch.as_tensor(table[n], device=pipe.device)

    def joint_backbone(self, args):
        return rows(joint, self, args, run_backbone(self, args), "joint")

    def separate_backbones(self, args, shared=None):
        return rows(separate, self, args, backbones(self, args, shared),
                    "separate")

    with patched(DetectionPipeline, run_backbone=joint_backbone), \
            patched(SeparateDetectionPipeline, backbones=separate_backbones):
        yield


@contextlib.contextmanager
def recorded_map(rec):
    """compute_map records what it is handed in ``rec``; restored on exit."""
    import canonicalvoting_tpu_torch.metrics.ap as ap

    compute_map = ap.compute_map

    def record(pred, gt, **kw):
        rec.append(pred)
        return compute_map(pred, gt, **kw)

    with patched(ap, compute_map=record):
        yield rec


@contextlib.contextmanager
def tail_lazy(pipe, lazy: bool):
    old = pipe.lazy_rot_scale
    pipe.lazy_rot_scale = lazy
    try:
        yield pipe
    finally:
        pipe.lazy_rot_scale = old


def vote_inputs(args, rows):
    """(points, xyz, scale, obj, corners, valid) of the joint tail's
    6-channel splat on planted head rows."""
    import torch

    from canonicalvoting_tpu_torch.eval.pipeline import slice_joint_heads
    from canonicalvoting_tpu_torch.ops.hough_voting import compute_corners

    xyz, scale, _, prob = slice_joint_heads(rows)
    return (args.coords_w, xyz, torch.exp(scale), prob,
            compute_corners(args.coords_w, args.valid), args.valid)


def path_launches(stats):
    """The kernels' launches summed over the ranks' stats."""
    return {n: sum(st["launches"][n] for st in stats) for n in SOURCES}


def detections_equal(got, want) -> bool:
    return list(got) == list(want) and all(
        same_detections(got[i], want[i]) for i in want)


def row_digests(record):
    """SHA-1 of each recorded backbone output (planted_heads' record)."""
    import hashlib

    return {kind: {n: hashlib.sha1(a.tobytes()).hexdigest()
                   for n, a in rows.items()} for kind, rows in record.items()}


def rows_differ(got, want):
    """The largest absolute difference of two recorded backbone outputs
    over their valid rows (the first ``n``) and the largest absolute value
    of ``want``'s, by voxel count: 0.0 where bitwise equal."""
    import numpy as np

    return {n: {"max_abs": float(np.abs(got[n][:n].astype(np.float64)
                                        - want[n][:n]).max()),
                "peak": float(np.abs(want[n][:n]).max())} for n in want}


def parallel_rank(job):
    """One of the parallel phase's two ranks (spawned by
    ``parallel.launch.run_ranks``; it imports the port only): the sharded
    vote splat of scene 0, the joint fan-out over the three scenes, the
    separate fan-out over two and eval_joint.main fanned out over the
    tree. Returns what rank 0 checks and prints."""
    import torch
    import torch.distributed as dist

    from canonicalvoting_tpu_torch import eval_joint
    from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
    from canonicalvoting_tpu_torch.ops.hough_voting import hough_voting
    from canonicalvoting_tpu_torch.parallel import scene_parallel as sp
    from canonicalvoting_tpu_torch.parallel.hv_sharded import (
        hough_voting_sharded)
    from canonicalvoting_tpu_torch.parallel.mesh import make_mesh

    torch.set_grad_enabled(False)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(data=2, device=dev)
    out = {"rank": mesh.rank}

    # point-sharded voting: each rank splats half the rows, one all-reduce
    # of the int64 grid
    hv = {k: torch.as_tensor(v).to(dev) for k, v in job["hv"].items()}
    kw = dict(res=RES, num_rots=NUM_ROTS, grid_shape=job["grid_shape"])
    got = hough_voting_sharded(hv["points"], hv["xyz"], hv["scale"],
                               hv["obj"], hv["corners"], mesh=mesh,
                               valid=hv["valid"], **kw)
    if mesh.rank == 0:
        want = hough_voting(hv["points"], hv["xyz"], hv["scale"], hv["obj"],
                            corners=hv["corners"], valid=hv["valid"], **kw)
        out["hv_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
    sums = torch.zeros(tuple(job["grid_shape"]) + (6,), dtype=torch.int64,
                       device=dev)
    dist.all_reduce(sums)  # warm-up
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(REDUCE_REPS):
        dist.all_reduce(sums)
    sync(dev)
    out["reduce_ms"] = (time.perf_counter() - t0) * 1e3 / REDUCE_REPS
    out["reduce_bytes"] = sums.numel() * sums.element_size()
    del got, sums
    if mesh.rank == 0:
        del want

    def timed(name, fn):
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        out[name + "_call_s"] = time.perf_counter() - t0
        return res

    model = DenseMinkUNet(**job["joint_cfg"])
    model.load_state_dict(job["joint_sd"])
    plan = DenseMinkUNet(**job["sep_cfg"])
    stats, sep_stats, rec = [], [], []
    rows, cli_rows = {}, {}
    with planted_heads(job["joint_rows"], job["sep_rows"], rows):
        out["joint"] = timed("joint", lambda: sp.evaluate_scenes_sharded(
            model, None, job["items"], mesh=mesh, res=RES, num_rots=NUM_ROTS,
            peel=job["peel"], backbone="dense", stats=stats))
        out["separate"] = timed("separate", lambda: (
            sp.evaluate_scenes_sharded_separate(
                plan, job["sep_stacked"], job["items"][:N_SEPARATE_SCENES],
                job["categories"], mesh=mesh, res=RES, num_rots=NUM_ROTS,
                peel=job["sep_peel"], stats=sep_stats)))
    with planted_heads(job["joint_rows"], record=cli_rows):
        before = sp.launch_counts()
        with recorded_map(rec):
            out["cli"] = timed("cli", lambda: eval_joint.main(job["cli_argv"]))
        after = sp.launch_counts()
    out.update(stats=stats, sep_stats=sep_stats, cli_pred=rec[0] if rec else None,
               cli_launches={n: after[n] - before[n] for n in SOURCES},
               rows=row_digests(rows), cli_rows=cli_rows.get("joint", {}))
    return out


def phase_parallel(pipe, sep, scenes, card):
    """Scene-parallel evaluation and point-sharded voting on the card. (a)
    One rank of an NCCL group: the joint fan-out over the three scenes
    (planted head rows, the 6-channel tail) bit for bit the single-process
    DetectionPipeline at the run's shared shapes, with the same launches,
    and the sharded vote splat of scene 0 bit for bit hough_voting (an
    int64 all-reduce and an all_gather_object through NCCL). (b) Two ranks
    sharing the card over gloo: the sharded splat of scene 0's 61,440
    rows bit for bit hough_voting (the int64 grid crosses the host), the
    joint fan-out (rank 0: scenes 0 and 2, rank 1: scene 1) and the
    separate fan-out over two scenes bit for bit the single-process
    pipelines, each rank's launches, and eval_joint.main fanned out over a
    ScanNet tree of the three scenes with the single-process CLI's
    detections and mAP. The tails decode planted rows, so the backbones'
    own rows are checked apart: on every rank (one NCCL rank, two gloo
    ranks) bit for bit the single-process backbone's at the run's shared
    row cap and dense dims, and the fanned-out CLI's rows (shared shapes)
    bit for bit the single-process CLI's (each scene's own; their largest
    difference printed). Returns the fan-outs' launches."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from canonicalvoting_tpu_torch import eval_joint
    from canonicalvoting_tpu_torch.data.synthetic_tree import write_scannet_tree
    from canonicalvoting_tpu_torch.ops.hough_voting import hough_voting
    from canonicalvoting_tpu_torch.parallel import scene_parallel as sp
    from canonicalvoting_tpu_torch.parallel.hv_sharded import (
        hough_voting_sharded)
    from canonicalvoting_tpu_torch.parallel.launch import run_ranks
    from canonicalvoting_tpu_torch.parallel.mesh import make_mesh

    ids = [f"scene{i:04d}_00" for i in range(len(scenes))]
    items = [(i, *quantize(s)) for i, s in zip(ids, scenes)]
    n_sep = N_SEPARATE_SCENES
    device = "cuda:0" if DEVICE == "cuda" else DEVICE  # every rank's
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(PARALLEL_DIR, "store_one"))
    if os.path.exists(store):
        os.remove(store)
    # NCCL on the card (gloo where chip_smoke is rehearsed on the CPU)
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device=device)
        shapes, sep_shapes = (sp.shared_shapes(
            mesh, [c for _, c, _ in items[:n]], cap_multiple=pipe.cap_multiple,
            grid_multiple=pipe.grid_multiple, dense=True)
            for n in (len(items), n_sep))
        args = sp.collate_eval_scenes_dense(
            [(c, f) for _, c, f in items], shapes["cap"], shapes["dense_dims"],
            grid_shape=shapes["grid_shape"], res=RES, device=DEVICE)
        sargs = sp.collate_eval_scenes_dense(
            [(c, f) for _, c, f in items[:n_sep]], sep_shapes["cap"],
            sep_shapes["dense_dims"], grid_shape=sep_shapes["grid_shape"],
            res=RES, device=DEVICE)
        joint_rows = {int(a.valid.sum()): planted_rows(s, a).cpu().numpy()
                      for s, a in zip(scenes, args)}
        sep_rows = {int(a.valid.sum()): separate_rows(s, a, len(sep.categories))
                    for s, a in zip(scenes, sargs)}
        assert len(joint_rows) == len(scenes), "voxel counts must differ"
        rec = {}
        with planted_heads(joint_rows, sep_rows, rec), \
                tail_lazy(pipe, False), tail_lazy(sep, False):
            # the single-process references at the shared shapes, and
            # their backbones' rows
            reset_counters()
            want = {i: pipe.postprocess(pipe.run_scene_with_retry(a))
                    for i, a in zip(ids, args)}
            want_launches = read_counters()
            reset_counters()
            sep_want = {i: sep.postprocess(sep.run_scene_with_retry(a))
                        for i, a in zip(ids, sargs)}
            sep_want_launches = read_counters()
            want_rows, sep_want_rows = rec.pop("joint"), rec.pop("separate")
            # (a) the fan-out on one rank
            one_stats = []
            sync(DEVICE)
            reset_counters()
            t0 = time.perf_counter()
            one = sp.evaluate_scenes_sharded(
                pipe.model, None, items, mesh=mesh, res=RES,
                num_rots=NUM_ROTS, peel=pipe.peel, backbone="dense",
                stats=one_stats)
            sync(DEVICE)
            one_s = time.perf_counter() - t0
            one_launches = read_counters()
            one_rows = rec.pop("joint")
        vin = vote_inputs(args[0], torch.as_tensor(
            joint_rows[int(args[0].valid.sum())], device=DEVICE))
        kw = dict(res=RES, num_rots=NUM_ROTS, grid_shape=shapes["grid_shape"])
        hv_one = hough_voting_sharded(*vin[:5], mesh=mesh, valid=vin[5], **kw)
        hv_want = hough_voting(*vin[:4], corners=vin[4], valid=vin[5], **kw)
        hv_one_equal = all(torch.equal(a, b) for a, b in zip(hv_one, hv_want))
        del hv_one, hv_want
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        overrides = write_scannet_tree(root, scenes, ids) + [f"scannet_res={RES}"]
        if DEVICE == "cpu":
            overrides.append("--cpu")
        cli_rec, cli_own = [], {}
        with planted_heads(joint_rows, record=cli_own), recorded_map(cli_rec):
            cli_want = eval_joint.main(overrides)
        cli_own = cli_own["joint"]  # each scene at its own shapes
        job = {
            "device": device, "grid_shape": shapes["grid_shape"],
            "hv": {k: v.cpu() for k, v in zip(
                ("points", "xyz", "scale", "obj", "corners", "valid"), vin)},
            "items": items, "peel": pipe.peel, "joint_rows": joint_rows,
            "joint_cfg": pipe.model.config(),
            "joint_sd": {k: v.cpu() for k, v in pipe.model.state_dict().items()},
            "sep_cfg": sep.plan.config(), "sep_peel": sep.peel,
            "sep_stacked": {k: v.cpu() for k, v in sep.stacked.items()},
            "sep_rows": sep_rows, "categories": list(sep.categories),
            "cli_argv": overrides}
        del vin
        t0 = time.perf_counter()
        ranks = run_ranks([functools.partial(parallel_rank, job)], 2,
                          os.path.join(PARALLEL_DIR, "two"))
        two_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, r1 = (r[0] for r in ranks)
    # the backbones' rows on the ranks against the single-process rows at
    # the run's shared shapes (SHA-1); the fanned-out CLI's rows (shared
    # shapes) against the single-process CLI's (each scene's own shapes)
    want_digests = row_digests({"joint": want_rows,
                                "separate": sep_want_rows})
    rank_rows = {kind: {**r0["rows"].get(kind, {}), **r1["rows"].get(kind, {})}
                 for kind in ("joint", "separate")}
    rows_equal = {"one_rank_nccl": all(np_equal(one_rows[n], want_rows[n])
                                       for n in want_rows),
                  "joint": rank_rows["joint"] == want_digests["joint"],
                  "separate": rank_rows["separate"] == want_digests["separate"]}
    own_vs_shared = rows_differ({**r0["cli_rows"], **r1["cli_rows"]}, cli_own)
    rows_equal["cli_shared_vs_own"] = all(d["max_abs"] == 0.0
                                          for d in own_vs_shared.values())
    stats = r0["stats"]
    sep_stats = r0["sep_stats"]
    joint_two = path_launches(stats)
    sep_two = path_launches(sep_stats)
    cli_two = {n: r0["cli_launches"][n] + r1["cli_launches"][n] for n in SOURCES}

    def busy_s(st):
        return sum(row["total_s"] for row in st["timer"].values())

    def scenes_per_s(st):
        return {"rank": st["rank"], "scenes": st["scenes"],
                "scenes_per_s": len(st["scenes"]) / busy_s(st)}

    emit({"phase": "parallel", "card": card,
          "one_rank_nccl": {
              "scenes_per_s": len(items) / one_s, "launches": one_launches,
              "detections_equal": detections_equal(one, want),
              "launches_equal": one_launches == want_launches,
              "hv_bitwise_equal": hv_one_equal, "timer": one_stats[0]["timer"]},
          "two_ranks_share_one_card": {
              "spawn_and_run_s": two_s,
              # each call builds its pipeline in each rank
              "joint_call_scenes_per_s": len(items) / r0["joint_call_s"],
              "separate_call_scenes_per_s": n_sep / r0["separate_call_s"],
              "cli_call_s": r0["cli_call_s"],
              # the scenes over the slower rank's timed phases
              "total_scenes_per_s": len(items) / max(map(busy_s, stats)),
              "separate_total_scenes_per_s": n_sep / max(map(busy_s,
                                                             sep_stats)),
              "per_rank": [scenes_per_s(st) for st in stats],
              "separate_per_rank": [scenes_per_s(st) for st in sep_stats],
              "timers": [st["timer"] for st in stats],
              "separate_timers": [st["timer"] for st in sep_stats],
              # each fan-out's peak, its statistics reset at its start
              "peak_mem_gib": [st["peak_mem_bytes"] / 2 ** 30
                               if st["peak_mem_bytes"] is not None else None
                               for st in stats],
              "separate_peak_mem_gib": [
                  st["peak_mem_bytes"] / 2 ** 30
                  if st["peak_mem_bytes"] is not None else None
                  for st in sep_stats],
              "backbone_rows_bitwise_equal": rows_equal,
              # the single-process CLI runs each scene at its own row cap
              # and dense dims, the fanned-out one at the run's shared ones
              "cli_rows_shared_vs_own_max_abs": own_vs_shared,
              "hv_bitwise_equal": r0["hv_equal"],
              "hv_reduce_ms": [r0["reduce_ms"], r1["reduce_ms"]],
              "hv_reduce_bytes": r0["reduce_bytes"],
              "launches": {"joint": [st["launches"] for st in stats],
                           "separate": [st["launches"] for st in sep_stats],
                           "cli": [r0["cli_launches"], r1["cli_launches"]]},
              "joint_equal": detections_equal(r0["joint"], want),
              "separate_equal": detections_equal(r0["separate"], sep_want),
              "cli_mAP": {str(t): float(d["mAP"]) for t, d in r0["cli"].items()},
              "cli_single_mAP": {str(t): float(d["mAP"])
                                 for t, d in cli_want.items()}}})
    assert all(rows_equal.values()), rows_equal
    assert len(one_stats) == 1 and one_stats[0]["scenes"] == ids
    assert detections_equal(one, want), "one-rank fan-out detections differ"
    assert one_launches == want_launches, (one_launches, want_launches)
    for n, per in PER_SCENE.items():
        assert one_launches[n] == per * len(items), (n, one_launches)
    assert one_launches["hv_splat6"] >= len(items) and \
        one_launches["hv_splat"] == 0, one_launches
    assert hv_one_equal, "one-rank sharded vote grids differ from hough_voting"
    assert r0["hv_equal"], "two-rank sharded vote grids differ from hough_voting"
    assert [st["scenes"] for st in stats] == [ids[0::2], ids[1::2]], stats
    assert [st["scenes"] for st in sep_stats] == [ids[:1], ids[1:n_sep]]
    for r in (r0, r1):
        assert detections_equal(r["joint"], want), "joint fan-out differs"
        assert detections_equal(r["separate"], sep_want), \
            "separate fan-out differs"
    assert joint_two == {n: want_launches[n] for n in SOURCES}, \
        (joint_two, want_launches)
    for st in stats:  # each rank's own launches
        for n, per in PER_SCENE.items():
            assert st["launches"][n] == per * len(st["scenes"]), (n, st)
    assert sep_two == {n: sep_want_launches[n] for n in SOURCES}, \
        (sep_two, sep_want_launches)
    for st in sep_stats:
        for n, per in SEPARATE_PER_SCENE.items():
            if n in ("hv_splat", "hv_splat6"):
                continue  # the non-lazy tail: one 6-channel splat a tail
            assert st["launches"][n] == per * len(st["scenes"]), (n, st)
        assert st["launches"]["hv_splat6"] >= len(st["scenes"]) and \
            st["launches"]["hv_splat"] == 0, st
    assert r1["cli"] == {} and r1["cli_pred"] is None
    assert detections_equal(r0["cli_pred"], cli_rec[0]), "CLI fan-out differs"
    assert {t: float(d["mAP"]) for t, d in r0["cli"].items()} == \
        {t: float(d["mAP"]) for t, d in cli_want.items()}, "CLI mAP differs"
    for n, per in PER_SCENE.items():
        assert cli_two[n] == per * len(items), (n, cli_two)
    return {n: one_launches[n] + joint_two[n] + sep_two[n] + cli_two[n]
            for n in SOURCES}


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
              ("variants", lambda: phase_variants(pipe, sep(), scenes)),
              ("scannet", lambda: phase_scannet(pipe, sep(), scenes, smi)),
              ("sparse", lambda: phase_sparse(pipe, sep(), scenes)),
              ("sunrgbd", phase_sunrgbd),
              ("f32", lambda: phase_f32(scenes)),
              ("train", lambda: phase_train(scenes)),
              ("train_dense", lambda: phase_train_dense(scenes)),
              ("train_remat", lambda: phase_train_remat(scenes)),
              ("hough_backward", lambda: phase_hough_backward(pipe, scenes)),
              ("parallel", lambda: phase_parallel(pipe, sep(), scenes, smi)))
    for name, run in phases:
        try:
            done[name] = run()
        except Exception as e:  # reported; the run then exits 1
            failed.append(name)
            print(f"chip_smoke: {name} FAILED: {e!r}", file=sys.stderr)
    emit({"total_s": time.perf_counter() - t_start, "failed": failed})
    if failed:
        return 1
    # launches: the sum over the runs of the paths (phase 2, the separate
    # phase, the non-lazy phase, the variants phase, the two CLIs of the
    # scannet phase, the sparse phase's joint and separate passes, the
    # sampler's batch, the training loops' validations, with and without
    # remat, the parallel phase's fan-outs on one rank and on two), each
    # counted from 0; the fused block, which no path runs, counts phase 1's
    # checks
    summary = done["phase1"]
    launches = {n: done["phase2"][0][n] + done["separate"][n]
                + done["nonlazy"][n] + done["variants"][n] + done["scannet"][n]
                + done["sparse"][n] + done["sunrgbd"][0][n] + done["train"][n]
                + done["train_remat"][n] + done["parallel"][n]
                for n in SOURCES}
    # row 5's largest error includes the sampler's configuration
    summary["hv_splat6"]["max_abs_err"] = max(
        summary["hv_splat6"]["max_abs_err"], done["sunrgbd"][1])
    launches["tiled_block3d"] = summary["tiled_block3d"]["launches"]
    kernels = []
    for name, (source, replaces, cuda_kernels) in SOURCES.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "cuda_kernels": cuda_kernels,
                        "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        "fill_ms": s["fill_ms"], "host_ms": s["host_ms"],
                        "device_ms": s["device_ms"]})
        if s["vote_ms"] is not None:
            kernels[-1].update(vote_ms=s["vote_ms"], convert_ms=s["convert_ms"])
        if name == "tiled_block3d":
            kernels[-1]["launches_from"] = (
                "phase 1: one check a BasicBlock of a joint pass; no path "
                "runs the fused block")
            kernels[-1].update({k: s[k] for k in (
                "two_conv_ms", "two_conv_device_ms", "two_conv_host_ms")})
    # the float32 rows: phase f32's checks and times; launches from the
    # float32 paths (the f32 phase's joint and separate passes and its CLI
    # run, the dense loops' validations)
    f32_summary, f32_launches = done["f32"]
    for name in F32_ROWS:
        s = f32_summary[name]
        source, replaces, cuda_kernels = SOURCES[name]
        kernels.append({
            "name": f"{name}_f32", "route": "cuda", "source": source,
            "replaces": f"{replaces} (float32 grids)",
            "cuda_kernels": F32_KERNELS[name],
            "launches": f32_launches[name] + done["train_dense"][name],
            **{k: s[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "fill_ms",
                                 "host_ms", "device_ms")}})
        if name == "tiled_block3d":  # no path runs it: the f32 phase's checks
            kernels[-1]["launches"] = s["launches"]
            kernels[-1]["launches_from"] = (
                "phase f32: one check a BasicBlock of a float32 joint pass; "
                "no path runs the fused block")
            kernels[-1].update({k: s[k] for k in (
                "two_conv_ms", "two_conv_device_ms", "two_conv_host_ms")})
    print(smi)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
