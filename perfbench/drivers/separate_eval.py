"""The nine-category evaluator under a closed loop of scans.

Set-up makes the pool of scans (laid out by the traffic, coloured from the
seed), quantizes them, plants each category's confident head rows (the
detection-bearing rows the tail decodes, so the boxes are known), makes
the nine detectors' weights on the card, builds
``SeparateDetectionPipeline`` and runs every pool member once. The window
then cycles through the members in an order drawn from the seed, one scan
at a time as the separate CLI does: ``prepare_quantized`` (host prep and upload),
``run_scene_with_retry(args, planted)`` (the shared grids, the nine
backbones, whose rows are kept, one splat of the nine categories, the
batched peel) and ``postprocess`` (host NMS). A scan's time runs from the
start of its prep to its NMS output.

After the window the program is freed and the reference (``reference/``)
works every visited member out again: its boxes and detections are held
against every scan of the window, its nine backbones' head rows and its
vote grids against the two scans whose rows and grids the window kept
(drawn from the seed).
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

from harness import scenes, trace, weights
from harness.scenes import sub_seed
from harness.work import backbone_work
from reference import minkunet, tail

SPANS = ("prep", "backbones", "splat", "peel", "nms")
NUMBERS = ("head_rel_err", "grid_rel_err", "box_gap_m", "det_gap_m")
MISMATCH = 1e9   # the gap a box count that differs reads
PROFILED = 3     # scans the traced run profiles


class Inputs:
    """What the benchmark makes for both sides: the pool of scans with
    their planted rows, and the recipe of the nine detectors' weights."""

    def __init__(self, torch, cell, seed: int, device, rehearse: bool = False):
        self.torch, self.cell, self.seed, self.device = torch, cell, seed, device
        cfg, tr = dict(cell.config), dict(cell.traffic)
        if rehearse:
            cfg.update(cfg.get("rehearsal", {}))
            tr.update(tr.get("rehearsal", {}))
        self.cfg, self.tr = cfg, tr
        self.res = float(cfg["res"])
        self.C = len(cfg["categories"])
        self.sites = minkunet.conv_sites(cfg["in_channels"], cfg["out_channels"],
                                         cfg["layers"], cfg["planes"],
                                         cfg["init_dim"], cfg["stem_kernel"])
        self.specs = minkunet.param_specs(self.sites)
        self.pool = []
        mult = int(cfg["cap_multiple"])
        for k in range(int(tr["pool"])):
            s, rows = scenes.member_scan(tr, seed, k, self.res)
            coords, rgb = rows[:2]
            cap = -(-len(coords) // mult) * mult
            planted = scenes.planted_separate_rows(s, coords, self.res, cap, self.C)
            self.pool.append({
                "room": scenes.scan_spec(tr, k)["room"],
                "coords": coords, "rgb": rgb,
                "grid": tuple(scenes.scan_spec(tr, k)["grid"]),
                "planted": torch.from_numpy(planted).to(device),
                "planted_boxes": [sum(b.class_idx == c for b in s.boxes)
                                  for c in range(self.C)]})

    def weights(self):
        return weights.make(self.torch, self.specs, self.C, self.seed, self.device)


class Driver:

    def __init__(self, torch, cell, seed: int, device, traced: bool,
                 fault: str = "", rehearse: bool = False):
        from canonicalvoting_tpu_torch.eval import separate
        from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet

        self.torch, self.device, self.traced, self.fault = torch, device, traced, fault
        self.inp = inp = Inputs(torch, cell, seed, device, rehearse)
        cfg = inp.cfg
        with torch.device("meta"):
            plan = DenseMinkUNet(cfg["in_channels"], cfg["out_channels"],
                                 layers=cfg["layers"], planes=cfg["planes"],
                                 init_dim=cfg["init_dim"],
                                 stem_kernel=cfg["stem_kernel"],
                                 compute_dtype=cfg["compute_dtype"],
                                 stem_impl=cfg["stem_impl"],
                                 up_impl=cfg["up_impl"])
        self.pipe = separate.SeparateDetectionPipeline(
            model=plan, categories=list(cfg["categories"]), res=inp.res,
            num_rots=int(cfg["num_rots"]), log_scale=bool(cfg["log_scale"]),
            nms_iou=float(cfg["nms_iou"]), cap_multiple=int(cfg["cap_multiple"]),
            backbone=cfg["backbone"], stem_impl=cfg["stem_impl"],
            lazy_rot_scale=bool(cfg["lazy_rot_scale"]), device=str(device))
        self.pipe.set_state_dicts(inp.weights())
        self._instrument(separate)

        # the window's scans (counted after the warm-up's) whose head rows
        # and vote grids are kept for the comparison
        P = len(inp.pool)
        rng = np.random.RandomState(sub_seed(seed, 3))
        self.keep_at = {int(i) for i in rng.choice(P, min(2, P), replace=False)}
        self.kept: Dict[int, Dict[str, object]] = {}
        self.scan_index = -1
        for k in range(P):       # the warm-up: every member once
            self._scene(k)
        self.sync()
        gc.collect()
        gc.freeze()              # the collector no longer walks set-up's objects
        self.scans: List[Dict[str, object]] = []

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _instrument(self, separate):
        """Counters, the kept rows and grids, the faults of the fault
        tests and (traced) a synchronized span around each call into a
        layer: wrappers on the pipeline instance, and on the separate
        module's name for the peel's sampler (one call an iteration)."""
        pipe, torch = self.pipe, self.torch
        self.count = defaultdict(int)
        self.span_ms = defaultdict(float)
        self.profiling = False

        def spanned(name, fn, device_work=True):
            def call(*a, **kw):
                if not self.traced:
                    return fn(*a, **kw)
                if device_work:
                    self.sync()
                t0 = time.perf_counter()
                with (torch.profiler.record_function(name) if self.profiling
                      else contextlib.nullcontext()):
                    out = fn(*a, **kw)
                    if device_work:
                        self.sync()
                self.span_ms[name] += (time.perf_counter() - t0) * 1e3
                return out
            return call

        backbones, vote, tail_fn = pipe.backbones, pipe.vote, pipe.tail

        def kept_backbones(args, shared=None):
            heads = backbones(args, shared)
            if self.fault == "half":     # half of the rows left out
                heads = heads.clone()
                heads[:, heads.shape[1] // 2:] = 0
            if self.scan_index in self.keep_at:
                kept = self.kept.setdefault(self.scan_index, {})
                if "heads" not in kept:
                    kept["heads"] = heads.clone()
            return heads

        def kept_vote(heads, args):
            votes = vote(heads, args)
            if self.scan_index in self.keep_at:
                kept = self.kept.setdefault(self.scan_index, {})
                if "grids" not in kept:
                    kept["grids"] = votes["grids"][0].clone()
            return votes

        def counted_tail(*a, **kw):
            self.count["tail"] += 1
            return tail_fn(*a, **kw)

        stats = separate.vote_stats_at_cell

        def counted_stats(*a, **kw):
            self.count["peel_iters"] += 1
            return stats(*a, **kw)

        self.patched = (separate, stats)
        separate.vote_stats_at_cell = counted_stats
        pipe.prepare_quantized = spanned("prep", pipe.prepare_quantized, False)
        pipe.backbones = spanned("backbones", kept_backbones)
        pipe.vote = spanned("splat", kept_vote)
        pipe.peel_votes = spanned("peel", pipe.peel_votes)
        pipe.tail = counted_tail
        post = spanned("nms", pipe.postprocess, False)

        def moved(out):                  # a detection moved where it is made
            dets = post(out)
            if dets:
                c, box, score = dets[0]
                dets[0] = (c, box + 0.1, score)
            return dets

        pipe.postprocess = moved if self.fault == "answer" else post

    def _scene(self, k: int) -> Dict[str, object]:
        m = self.inp.pool[k]
        self.count.clear()
        self.span_ms.clear()
        t0 = time.perf_counter()
        args = self.pipe.prepare_quantized(m["coords"], m["rgb"])
        out = self.pipe.run_scene_with_retry(args, planted=m["planted"])
        dets = self.pipe.postprocess(out)
        t1 = time.perf_counter()
        return {"member": k, "s": t1 - t0, "out": out, "dets": dets,
                "retries": self.count["tail"] - 1,
                "peel_iters": self.count["peel_iters"],
                "spans": dict(self.span_ms)}

    # ------------------------------------------------------------------
    def run_window(self, seconds: float) -> float:
        """Scans back to back until ``seconds`` have passed; returns the
        window's length, to the end of its last scan."""
        P = len(self.inp.pool)
        order = scenes.cycle_order(P, self.inp.seed)
        t0 = time.perf_counter()
        i = 0
        while True:
            self.scan_index = i
            self.scans.append(self._scene(int(order[i % P])))
            i += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                self.scan_index = -1
                return elapsed

    def run_profiled(self):
        """``PROFILED`` more scans under the profiler; their trace summary."""
        torch, P, n = self.torch, len(self.inp.pool), PROFILED
        self.profiling = True
        self.sync()
        with trace.profile(torch) as prof:
            with torch.profiler.record_function("window"):
                for i in range(n):
                    self._scene(i % P)
                self.sync()
        self.profiling = False
        self.profiled_members = [i % P for i in range(n)]
        return trace.read(prof, SPANS)

    def attempted(self) -> int:
        return len(self.scans)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        from harness.stats import percentile, rate
        lat = [s["s"] * 1e3 for s in self.scans]
        return {"scenes_per_s": rate(len(self.scans), window_s),
                "scene_ms_p90": percentile(lat, 90)}

    def info(self) -> Dict[str, object]:
        """What a run prints before its result: the work each scan did."""
        P = len(self.inp.pool)
        fifth = max(1, len(self.scans) // 5)
        peeled = defaultdict(set)
        for s in self.scans:
            peeled[s["member"]].add(tuple(int(v) for v in s["out"]["n_boxes"].tolist()))
        return {"scans": len(self.scans),
                "ms_by_fifth": [1e3 * float(np.mean([s["s"] for s in
                                                    self.scans[i:i + fifth]]))
                                for i in range(0, len(self.scans) - fifth + 1,
                                               fifth)][:5],
                "ms_by_member": [1e3 * float(np.median([s["s"] for s in self.scans
                                                        if s["member"] == k]))
                                 for k in range(P) if k in peeled],
                "retries": sum(s["retries"] for s in self.scans),
                "peel_iters": sorted({s["peel_iters"] for s in self.scans}),
                "planted_boxes_by_category": [m["planted_boxes"] for m in self.inp.pool],
                "peeled_boxes_by_category": [sorted(peeled[k]) for k in range(P)],
                "scans_peeling_the_planted_boxes": sum(
                    tuple(int(v) for v in s["out"]["n_boxes"].tolist())
                    == tuple(self.inp.pool[s["member"]]["planted_boxes"])
                    for s in self.scans),
                "voxels": [len(m["coords"]) for m in self.inp.pool]}

    def layer_record(self, window_s: float) -> Dict[str, object]:
        """What the per-layer readers read (traced runs)."""
        torch, inp = self.torch, self.inp
        work = {}
        for k in set(s["member"] for s in self.scans) | set(self.profiled_members):
            c = torch.from_numpy(inp.pool[k]["coords"]).to(self.device).long()
            w = backbone_work(minkunet.geometry(torch.nn.functional.pad(c, (1, 0))),
                              inp.sites)
            work[k] = (inp.C * w.flops, inp.C * w.conv_least_s)
        return {"spans_ms": {n: [s["spans"].get(n, 0.0) for s in self.scans]
                             for n in SPANS},
                "units": len(self.scans), "window_s": window_s,
                "unit_s": [s["s"] for s in self.scans],
                "unit_flops": [work[s["member"]][0] for s in self.scans],
                "profiled_conv_least_s": sum(work[k][1] for k in self.profiled_members),
                "profiled_units": len(self.profiled_members)}

    def release(self):
        """Free the program's state; keep what the comparison reads."""
        module, stats = self.patched
        module.vote_stats_at_cell = stats
        for s in self.scans:
            s["out"] = {k: v.cpu().numpy() for k, v in s["out"].items()}
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, limits: Dict[str, float]) -> Dict[str, float]:
        """The widest gaps between what the window produced and the
        reference; ``self.failed`` counts the scans past a limit."""
        inp = self.inp
        nums = dict.fromkeys(NUMBERS, 0.0)
        kept = {self.scans[i]["member"]: v for i, v in self.kept.items()
                if i < len(self.scans)}
        self.failed = 0
        for k in sorted({s["member"] for s in self.scans}):
            ref = reference_member(inp, k, None, self.torch.float64,
                                   backbones=k in kept)
            if k in kept:
                n = len(inp.pool[k]["coords"])
                h, g = rows_and_grids(kept[k]["heads"][:, :n], kept[k]["grids"], ref)
                nums["head_rel_err"] = max(nums["head_rel_err"], h)
                nums["grid_rel_err"] = max(nums["grid_rel_err"], g)
            for s in self.scans:
                if s["member"] != k:
                    continue
                b, d = boxes_and_dets(inp, s["out"], s["dets"], ref)
                nums["box_gap_m"] = max(nums["box_gap_m"], b)
                nums["det_gap_m"] = max(nums["det_gap_m"], d)
                if b > limits["box_gap_m"] or d > limits["det_gap_m"]:
                    self.failed += 1
        return nums


# ---------------------------------------------------------------- reference
def reference_member(inp: Inputs, k: int, quant, tail_dtype,
                     backbones: bool) -> Dict[str, object]:
    """The reference's outputs for pool member ``k``: per category its vote
    grid, boxes and detections, and (``backbones``) the nine backbones'
    head rows. The reference forms the tail's positions in float32 and sums
    in float64; the control (``tail_dtype`` bfloat16, ``quant`` its
    products' rounding) does both in its own precision."""
    torch, cfg, dev = inp.torch, inp.cfg, inp.device
    m = inp.pool[k]
    n = len(m["coords"])
    pos = torch.float32 if tail_dtype == torch.float64 else tail_dtype
    pts32 = torch.from_numpy(m["coords"].astype(np.float32)
                             * np.float32(inp.res)).to(dev)
    grid_shape = m["grid"]
    corner, dims = tail.corners_and_dims(pts32, inp.res, grid_shape)
    xyz, scale, prob = tail.heads_of(m["planted"][:, :n].to(pos),
                                     bool(cfg["log_scale"]))
    pts, corner = pts32.to(pos), corner.to(pos)
    settings = tail.PeelSettings(res=inp.res)
    out = {"grids": [], "boxes": [], "dets": []}
    for c in range(inp.C):
        args = (pts, xyz[c], scale[c], prob[c], corner, dims)
        g = tail.splat(*args, inp.res, int(cfg["num_rots"]), grid_shape,
                       acc=tail_dtype)
        p = tail.peel(g, *args, int(cfg["num_rots"]), settings, acc=tail_dtype)
        boxes = p["boxes"].double().cpu().numpy()
        keep = tail.nms(boxes, p["scores"].numpy(), float(cfg["nms_iou"]))
        out["grids"].append(g.float())
        out["boxes"].append(boxes)
        out["dets"].append([boxes[j] for j in keep])
    if backbones:
        sds = inp.weights()
        geo = minkunet.geometry(torch.nn.functional.pad(
            torch.from_numpy(m["coords"]).to(dev).long(), (1, 0)))
        feats = torch.from_numpy(m["rgb"]).to(dev) * 2.0 - 1.0
        with torch.no_grad(), minkunet.exact_float32():
            out["heads"] = torch.stack([
                minkunet.forward(sds[c], feats, geo, cfg["layers"], quant=quant)
                for c in range(inp.C)])
    return out


def rows_and_grids(heads, grids, ref):
    """(the head rows' widest gap over each category's largest row value,
    worst category; the vote grids' widest gap over the scan's largest cell
    of the nine grids)."""
    h = g = 0.0
    peak = max(float(gw.max()) for gw in ref["grids"])
    for c in range(len(ref["grids"])):
        want = ref["heads"][c]
        h = max(h, float((heads[c].float() - want).abs().max()
                         / want.abs().max()))
        g = max(g, float((grids[c].float() - ref["grids"][c]).abs().max()) / peak)
    return h, g


def _box_gap(got, want) -> float:
    """The widest corner gap between boxes matched in order; ``MISMATCH``
    when their counts differ."""
    if len(got) != len(want):
        return MISMATCH
    if not len(got):
        return 0.0
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max())


def _det_gap(got, want) -> float:
    """As :func:`_box_gap` for detections, each matched to its nearest."""
    if len(got) != len(want):
        return MISMATCH
    left, gap = list(range(len(want))), 0.0
    for b in got:
        d = [float(np.abs(np.asarray(b, np.float64) - want[j]).max()) for j in left]
        j = int(np.argmin(d))
        gap = max(gap, d[j])
        left.pop(j)
    return gap


def boxes_and_dets(inp: Inputs, out, dets, ref):
    """(peeled boxes' widest gap, detections' widest gap) of one scan."""
    cats = inp.cfg["categories"]
    b = d = 0.0
    for c in range(inp.C):
        nb = int(out["n_boxes"][c])
        b = max(b, _box_gap(out["boxes"][c, :nb], ref["boxes"][c]))
        got = [box for cat, box, _ in dets if cat == cats[c]]
        d = max(d, _det_gap(got, ref["dets"][c]))
    return b, d


def control(inp: Inputs) -> Dict[str, float]:
    """The control's numbers: the reference at the precision below the
    configuration's (float8 products, a bfloat16 tail) in the program's
    place, held against the reference, over two pool members."""
    torch = inp.torch
    nums = dict.fromkeys(NUMBERS, 0.0)
    for k in range(min(2, len(inp.pool))):
        ref = reference_member(inp, k, None, torch.float64, backbones=True)
        low = reference_member(inp, k, minkunet.fp8, torch.bfloat16,
                               backbones=True)
        h, g = rows_and_grids(low["heads"], low["grids"], ref)
        nums["head_rel_err"] = max(nums["head_rel_err"], h)
        nums["grid_rel_err"] = max(nums["grid_rel_err"], g)
        for c in range(inp.C):
            nums["box_gap_m"] = max(nums["box_gap_m"],
                                    _box_gap(low["boxes"][c], ref["boxes"][c]))
            nums["det_gap_m"] = max(nums["det_gap_m"],
                                    _det_gap(low["dets"][c], ref["dets"][c]))
    return nums
