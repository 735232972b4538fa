"""Measure the float32 rows (``tpu.conv_dtype=float32``) of the port in the
current directory against another checkout's port, in one process on one
GPU.

    cd <checkout root> && python3 <path>/tools/f32_probe.py --parent DIR
        [--reps N]

It imports ``canonicalvoting_tpu_torch`` from the working directory, the
workload and timers from the ``chip_smoke.py`` of the checkout that holds
the script, and DIR's ``ops/tiled_conv.py`` with its own ``cuda_build``
(``tools/block_probe.py:load_port``). Every call of rows 1f, 2f, 3f, 6f
and 7f that one scene's float32 passes make (the joint pass, default and
``up_impl="into"``, and the separate path's prefolded stem, recorded as
``chip_smoke.py``'s f32 phase records them) runs on both ports. Prints one
JSON line with:

- ``rows``: each name's summed ``call_ms`` a scene in turns (parent,
  current, current, parent; CUDA events over ``reps`` calls, the wrapper's
  zero fill included), its bound (``chip_smoke.py``'s ``conv_bound`` /
  ``prefold_bound`` at the float32 FFMA rate) and the largest difference
  between the two ports' outputs relative to the output's peak
  (``max_rel_diff``; two ports that sum in other orders differ) and
  whether every call's outputs are equal bit for bit (``bitwise_equal``);
- ``by_level``: the same for ``tiled_conv3d`` (row 1f) at each level L0-L4;
- ``ups``: rows 3f (``tiled_up2``, L0-L3) and 7f (``tiled_up2_into``, L0
  and L1) by level: the listed coarse parents (``listed``: a padded tile
  list repeats its last tile; ``repeats``: the listed parents that a
  repeated tile lists again, recomputed by both ports), the live ones
  (``live``, repeats included, as the kernel counts them) and the live
  repeats; whether both ports' outputs are equal bit for bit; and in turns
  the device ms of one call by piece (``torch.profiler`` over ``reps``
  calls: ``memset``, ``compaction``, ``gemm``, ``skip_copy``, ``up_dead``,
  ``fill``, ``other``). ``kernel_part_3f_ms`` sums row 3f's pieces but the
  fill a scene, ``device_7f_ms`` row 7f's, in the same turns;
- ``paths``: the float32 joint backbone (ms a scene, chip_smoke's scene 0)
  and the joint path over chip_smoke's three scenes with planted tails
  (scenes/s), and the nine separate backbones of a scene (ms), each with
  the dense model's kernel names bound to either port, in the same turns.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from block_probe import load_port  # noqa: E402
from splat_probe import load_chip_smoke  # noqa: E402

ROWS = ("tiled_conv3d", "tiled_down2", "tiled_up2", "tiled_conv3d_prefolded",
        "tiled_up2_into")
UPS = ("tiled_up2", "tiled_up2_into")
TURNS = ("parent", "current", "current", "parent")
# a profiler kernel name's piece of an up call
UP_PIECES = (("compact_kernel", "compaction"), ("up_rows_f32_kernel", "gemm"),
             ("skip_copy_kernel", "skip_copy"), ("up_dead_kernel", "up_dead"),
             ("FillFunctor", "fill"), ("emset", "memset"))


def record(cs, du, pipe, sep, args, sep_args):
    """{config: record} of the float32 passes' calls of the five rows."""
    records = {}
    with cs.patched(du, **{n: cs.recorder(records, du, n) for n in
                           ("tiled_conv3d", "tiled_down2", "tiled_up2")}):
        pipe.run_backbone(args)
    with cs.variants(pipe), cs.patched(
            du, tiled_up2_into=cs.recorder(records, du, "tiled_up2_into")):
        pipe.run_backbone(args)
    with cs.patched(du, tiled_conv3d_prefolded=cs.recorder(
            records, du, "tiled_conv3d_prefolded")):
        sep.backbones(sep_args)
    return records


def turns(cs, fns, reps):
    """ms of fns["parent"] and fns["current"] in TURNS order:
    {"parent": [a, b], "current": [a, b]}."""
    out = {"parent": [], "current": []}
    for who in TURNS:
        out[who].append(cs.time_ms(fns[who], reps))
    return out


def up_pieces_ms(fn, reps):
    """{piece: device ms} of one call of an up wrapper, from
    ``torch.profiler`` over ``reps`` calls after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if not str(e.device_type).endswith("CUDA") or us <= 0:
            continue
        piece = next((label for key, label in UP_PIECES if key in e.key), "other")
        out[piece] = out.get(piece, 0.0) + us / 1e3 / reps
    return out


def parent_counts(tiles, tile_shape, occ):
    """The listed coarse parents of an up call, as compact_kernel lists
    them: listed, repeats (listed again by a repeated tile), live (an
    occupied child; repeats included) and live repeats."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ

    hs = [t // 2 for t in tile_shape]
    local = torch.stack(torch.meshgrid(
        *[torch.arange(h, device=tiles.device) for h in hs], indexing="ij"),
        -1).reshape(-1, 3)
    par = tiles.long()[:, None] * torch.tensor(hs, device=tiles.device) + local[None]
    pooled = F.max_pool3d(occ[MX:-MX, MY:-MY, MZ:-MZ][None, None], 2)[0, 0] > 0
    live = pooled[par[..., 0], par[..., 1], par[..., 2]].cpu().numpy()
    _, first = np.unique(tiles.cpu().numpy(), axis=0, return_index=True)
    rep = np.ones(tiles.shape[0], bool)
    rep[first] = False
    return {"listed": int(live.size), "repeats": int(rep.sum()) * local.shape[0],
            "live": int(live.sum()), "live_repeats": int(live[rep].sum())}


def wall_turns(cs, fns):
    """Host-clock seconds of one synchronized run of each side in TURNS."""
    import torch

    out = {"parent": [], "current": []}
    for who in TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[who]()
        torch.cuda.synchronize()
        out[who].append(time.perf_counter() - t0)
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True)
    parser.add_argument("--reps", type=int, default=5)
    opt = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc
    from canonicalvoting_tpu_torch.ops.cuda_build import build_all

    build_all()
    ptc = load_port(opt.parent)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scenes = cs.make_scenes()
    pipe = cs.build_pipeline("float32")
    sep = cs.build_separate(compute_dtype="float32")
    args = pipe.prepare_scene(scenes[0].points, scenes[0].rgb)
    sep_args = sep.prepare_quantized(*cs.quantize(scenes[0]))
    records = record(cs, du, pipe, sep, args, sep_args)
    occ_of = {tuple(r["kw"]["occ"].shape): r["kw"]["occ"]
              for r in records.values() if r["name"] == "tiled_conv3d"}
    levels = {shape: i for i, shape in enumerate(sorted(
        occ_of, key=lambda sh: -sh[0] * sh[1] * sh[2]))}

    def zero():
        return {"calls": 0, "parent_ms": [0.0, 0.0], "current_ms": [0.0, 0.0],
                "bound_ms": 0.0, "max_rel_diff": 0.0, "bitwise_equal": True}

    rows = {n: zero() for n in ROWS}
    by_level = {}
    ups = []
    for r in records.values():
        name, a, kw, n = r["name"], r["args"], r["kw"], r["count"]
        fc, fp = getattr(tc, name), getattr(ptc, name)
        got, want = fc(*a, **cs.fresh(kw)), fp(*a, **cs.fresh(kw))
        if name == "tiled_up2_into":
            got, want = cs.into_conv_rows(got, a, kw), cs.into_conv_rows(want, a, kw)
        diff, peak = cs.rel_err(got, want)
        same = bool(torch.equal(cs.bits(got), cs.bits(want)))
        del got, want
        kc, kp = cs.fresh(kw), cs.fresh(kw)
        t = turns(cs, {"parent": lambda: fp(*a, **kp),
                       "current": lambda: fc(*a, **kc)}, opt.reps)
        (bound, _), _ = (cs.prefold_bound(r) if name == "tiled_conv3d_prefolded"
                         else cs.conv_bound(r, occ_of))
        sums = [rows[name]]
        if name == "tiled_conv3d":
            sums.append(by_level.setdefault(levels[tuple(kw["occ"].shape)], zero()))
        for s in sums:
            s["calls"] += n
            s["bound_ms"] += bound * n
            s["max_rel_diff"] = max(s["max_rel_diff"], diff / peak if peak else 0.0)
            s["bitwise_equal"] = s["bitwise_equal"] and same
            for who in ("parent", "current"):
                for i in range(2):
                    s[f"{who}_ms"][i] += t[who][i] * n
        if name in UPS:
            ups.append({
                "name": name, "level": levels[tuple(kw["occ"].shape)],
                "per_scene": n, "bitwise_equal": same,
                "max_rel_diff": diff / peak if peak else 0.0,
                "parents": parent_counts(a[2], kw["tile_shape"], kw["occ"]),
                "pieces_ms": {who: [] for who in ("parent", "current")},
                "fns": {"parent": functools.partial(fp, *a, **kp),
                        "current": functools.partial(fc, *a, **kc)}})
    for who in TURNS:
        for u in ups:
            u["pieces_ms"][who].append(up_pieces_ms(u["fns"][who], opt.reps))
    part_3f = {who: [0.0, 0.0] for who in ("parent", "current")}
    device_7f = {who: [0.0, 0.0] for who in ("parent", "current")}
    for u in ups:
        del u["fns"]
        for who, per_turn in u["pieces_ms"].items():
            for i, pieces in enumerate(per_turn):
                ms = sum(v for k, v in pieces.items() if k != "fill") * u["per_scene"]
                (part_3f if u["name"] == "tiled_up2" else device_7f)[who][i] += ms
    records.clear()
    torch.cuda.empty_cache()

    def bound_to(m):
        """The dense model's kernel names bound to the port ``m``."""
        return cs.patched(du, **{n: getattr(m, n) for n in ROWS})

    def on(m, fn):
        def run():
            with bound_to(m):
                return fn()
        return run

    backbone = turns(cs, {"parent": on(ptc, lambda: pipe.run_backbone(args)),
                          "current": on(tc, lambda: pipe.run_backbone(args))},
                     opt.reps)
    separate = turns(cs, {"parent": on(ptc, lambda: sep.backbones(sep_args)),
                          "current": on(tc, lambda: sep.backbones(sep_args))}, 2)
    prepped = [pipe.prepare_scene(s.points, s.rgb) for s in scenes]
    planted = [cs.planted_rows(s, p) for s, p in zip(scenes, prepped)]

    def joint():
        for p, r in zip(prepped, planted):
            cs.run_planted(pipe, p, r)

    for m in (ptc, tc):  # warm-up
        on(m, joint)()
    secs = wall_turns(cs, {"parent": on(ptc, joint), "current": on(tc, joint)})
    report = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
        "reps": opt.reps, "rows": rows,
        "by_level": {str(k): v for k, v in sorted(by_level.items())},
        "ups": {"levels": ups, "kernel_part_3f_ms": part_3f,
                "device_7f_ms": device_7f},
        "paths": {"joint_backbone_ms": backbone,
                  "separate_backbones_ms": separate,
                  "joint_scenes_per_s": {k: [len(scenes) / s for s in v]
                                         for k, v in secs.items()}}}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
