"""Measure the fused BasicBlock (``tiled_block3d``) by level on one GPU, for
the port in the current directory, beside the model's two convs of each
block, and, with ``--parent DIR``, beside another checkout's port in the
same process.

    cd <checkout root> && python3 <path>/tools/block_probe.py [--reps N]
        [--parent DIR] [--rows] [--ptxas]

It imports ``canonicalvoting_tpu_torch`` from the working directory and the
workload and timers from the ``chip_smoke.py`` of the checkout that holds
the script (as ``tools/splat_probe.py`` does): the 23 BasicBlocks of one
joint pass over ``chip_smoke.py``'s first scene, each on its recorded
input. ``--parent DIR`` loads DIR's ``ops/tiled_conv.py`` with its own
``cuda_build`` (its sources, its ``build/``) beside the current one, so
both ports run in one process on the same inputs, timed in turns (parent,
current, current, parent).

Prints one JSON line with, for each block:

- ``config``: channels in, mid and out, tile shape, listed tiles, listed
  and occupied cells, the residual (identity or 1x1) and the level;
- ``row9`` (and ``parent_row9``): one ``tiled_block3d`` call (its BN
  affines folded in the call, as ``BasicBlock.forward`` folds them), ``call_ms``
  (CUDA events over ``reps`` calls, both turns), ``host_ms`` (the host's
  time to issue one call, no sync between calls), ``device_ms`` by kernel
  name over one call (``torch.profiler``: the memsets, the compaction,
  conv1 and conv2, the split reductions, the dead rows, the output's zero
  fill; the parent's ``block_kernel``) and ``sha1`` of the output's bytes;
- ``two_conv`` (and ``parent_two_conv``): the same for the model's two
  ``tiled_conv3d`` calls of the block (``BasicBlock.forward``);
- ``row9_equals_two_conv``: whether the block's output is bitwise equal
  to the two convs' (and the parent's two convs');
- ``host_pieces_ms``: the host's time to issue each piece of one call of
  the current port, each alone (the output's zero fill, the three weight
  layouts, the affine and occupancy arguments, the row list, the row map,
  the mid, the split scratch, the launch function, its ctypes call alone,
  and the rest of the wrapper: the call less the other pieces but the
  ctypes call, which the launch holds), where the current port has the
  occupied-row block.

``levels`` sums each level's blocks: call, host and device ms of the block
and of the two convs, and device ms by piece.

``--rows`` (with ``--parent``) also runs every call of rows 1, 2, 3, 6 and
7 of ``PERF.md``'s table that one scene's passes make (``tiled_conv3d``,
``tiled_down2``, ``tiled_up2``, ``tiled_conv3d_prefolded``,
``tiled_up2_into``, recorded as ``chip_smoke.py`` phase 1 records them) on
both ports: whether each output is bitwise equal, and each name's summed
``call_ms`` a scene in turns (parent, current, current, parent).

``--ptxas`` (with ``--parent``) runs each checkout's own
``tools/ptxas_usage.py tiled_conv`` and pairs the registers, stack and
spills of every ``conv_rows_kernel`` and ``split_reduce_kernel``
instantiation (the current port's row-map instantiations stand alone).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from splat_probe import device_ms as profiled_ms, load_chip_smoke  # noqa: E402

ROWS = ("tiled_conv3d", "tiled_down2", "tiled_up2", "tiled_conv3d_prefolded",
        "tiled_up2_into")


def load_port(root: str):
    """``ops/tiled_conv.py`` of the checkout at ``root``, bound to that
    checkout's own ``ops/cuda_build.py`` (its csrc and build directory),
    its kernels built."""
    pkg = os.path.join(os.path.abspath(root), "canonicalvoting_tpu_torch")

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    key = "canonicalvoting_tpu_torch.ops.cuda_build"
    saved, build = sys.modules[key], load("parent_cuda_build", "ops/cuda_build.py")
    build.build_all()
    sys.modules[key] = build
    try:
        return load("parent_tiled_conv", "ops/tiled_conv.py")
    finally:
        sys.modules[key] = saved


def device_ms(fn):
    """splat_probe's device ms by kernel of one call, a short sleep kernel
    first: a profile can miss its first kernel (the output fill)."""
    import torch

    def call():
        torch.cuda._sleep(1000)
        return fn()

    dev = profiled_ms(call)
    return {k: v for k, v in dev.items() if "spin_kernel" not in k} \
        if isinstance(dev, dict) else dev


def sha1(t) -> str:
    import torch

    return hashlib.sha1(t.contiguous().view(torch.int16).cpu().numpy()
                        .tobytes()).hexdigest()


def piece(name: str) -> str:
    """A profiler kernel name's piece of a block or conv call."""
    if "Memset" in name or "memset" in name:
        return "memset"
    for key, label in (("compact_kernel", "compaction"),
                       ("split_reduce_kernel", "split_reduce"),
                       ("dead_rows_kernel", "dead_rows"),
                       ("block_kernel", "block_kernel"),
                       ("FillFunctor", "fill")):
        if key in name:
            return label
    if "conv_rows_kernel" in name:
        return "conv2 (row map)" if re.search(r"conv_rows_kernel<\d+, *true>", name) \
            else "conv (dense taps)"
    return "other (layout, casts)"


def by_piece(dev) -> dict:
    out = {}
    if isinstance(dev, dict):
        for k, v in dev.items():
            out[piece(k)] = out.get(piece(k), 0.0) + v
    return out


def two_conv(tc, blk, x, occ, tiles, ts):
    """``BasicBlock.forward`` on the wrappers of ``tc``."""
    a1, b1 = blk.norm1.affine()
    a2, b2 = blk.norm2.affine()
    mid = tc.tiled_conv3d(x, blk.conv1.kernel, tiles, tile_shape=ts,
                          kernel_size=3, scale=a1, bias=b1, occ=occ,
                          relu_out=True)
    rw = rs = rb = None
    if blk.downsample:
        rw = blk.downsample_conv.kernel[0]
        rs, rb = blk.downsample_norm.affine()
    return tc.tiled_conv3d(mid, blk.conv2.kernel, tiles, tile_shape=ts,
                           kernel_size=3, scale=a2, bias=b2, occ=occ,
                           residual=x, res_w=rw, res_scale=rs, res_bias=rb,
                           relu_out=True)


def block_kw(blk, occ, ts):
    a1, b1 = blk.norm1.affine()
    a2, b2 = blk.norm2.affine()
    kw = dict(tile_shape=ts, scale1=a1, bias1=b1, scale2=a2, bias2=b2, occ=occ)
    if blk.downsample:
        rs, rb = blk.downsample_norm.affine()
        kw.update(res_w=blk.downsample_conv.kernel[0], res_scale=rs, res_bias=rb)
    return kw


def host_pieces(tc, cs, x, blk, tiles, kw, reps):
    """{piece: the host's ms to issue it}: each piece of the occupied-row
    block's CUDA route alone, as the wrapper runs it, over ``reps`` calls."""
    import torch

    dev, ts = x.device, kw["tile_shape"]
    w1, w2, res_w = blk.conv1.kernel, blk.conv2.kernel, kw.get("res_w")
    cin, mid, cout = x.shape[3], w1.shape[2], w2.shape[2]
    n_rows = tiles.shape[0] * ts[0] * ts[1] * ts[2]
    weights = [w1, w2] + ([res_w[None]] if res_w is not None else [])
    (w1t, cpad1), (w2t, cpad2), *rest = [tc._k_major(w, x.dtype, dev)
                                         for w in weights]
    rwt, crpad = rest[0] if rest else (None, 0)
    names = ("scale1", "bias1", "scale2", "bias2", "occ", "res_scale", "res_bias")
    f = [tc._f32(kw.get(k), dev) for k in names]
    out = torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype, device=dev)
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    row_map = torch.empty(x.shape[:3], dtype=torch.int32, device=dev)
    mid_rows = torch.empty(n_rows * mid, dtype=x.dtype, device=dev)
    s1, s2, part = tc._block_splits(cin, mid, cout, res_w is not None, n_rows, dev)
    launch = tc._launcher("tiled_block3d_launch")

    def run(n):
        return launch(x.data_ptr(), cin, *x.shape[:3], w1t.data_ptr(), cpad1,
                      w2t.data_ptr(), cpad2, mid, cout, tiles.data_ptr(), n, *ts,
                      *[tc._ptr(t) for t in f[:5]], tc._ptr(rwt), crpad,
                      tc._ptr(f[5]), tc._ptr(f[6]), rows.data_ptr(),
                      row_map.data_ptr(), mid_rows.data_ptr(), out.data_ptr(),
                      tc._ptr(part), s1, s2, tc._stream())

    return {
        "out_zeros": cs.host_ms(lambda: torch.zeros(
            x.shape[:3] + (cout,), dtype=x.dtype, device=dev), reps),
        "weights": cs.host_ms(lambda: [tc._k_major(w, x.dtype, dev)
                                       for w in weights], reps),
        "affine_occ": cs.host_ms(lambda: [tc._f32(kw.get(k), dev)
                                          for k in names], reps),
        "row_list": cs.host_ms(lambda: torch.empty(
            n_rows + 2, dtype=torch.int32, device=dev), reps),
        "row_map": cs.host_ms(lambda: torch.empty(
            x.shape[:3], dtype=torch.int32, device=dev), reps),
        "mid": cs.host_ms(lambda: torch.empty(
            n_rows * mid, dtype=x.dtype, device=dev), reps),
        "split_scratch": cs.host_ms(lambda: tc._block_splits(
            cin, mid, cout, res_w is not None, n_rows, dev), reps),
        "launch": cs.host_ms(lambda: run(n_rows), reps),
        "ctypes": cs.host_ms(lambda: run(0), reps)}


def timed(cs, fn, reps):
    return {"call_ms": cs.time_ms(fn, reps), "host_ms": cs.host_ms(fn, reps)}


def ptxas_pairs(parent: str) -> list:
    """The registers, stack and spills of each conv_rows_kernel and
    split_reduce_kernel instantiation, current against parent."""
    def usage(root):
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "ptxas_usage.py"),
             "tiled_conv"], cwd=root, capture_output=True, text=True,
            timeout=900, check=True).stdout
        rows = {}
        for line in out.splitlines():
            r = json.loads(line)
            if "conv_rows_kernel" in r["kernel"] or "split_reduce_kernel" in r["kernel"]:
                key = re.sub(r"\(.*", "", r["kernel"].replace("(anonymous namespace)::", ""))
                rows[re.sub(r", *false>", ">", key)] = {
                    k: r.get(k, 0) for k in ("registers", "stack_frame",
                                             "spill_stores", "spill_loads",
                                             "static_smem")}
        return rows

    cur, par = usage(os.getcwd()), usage(parent)
    return [{"kernel": k, "current": cur.get(k), "parent": par.get(k)}
            for k in sorted(set(cur) | set(par))]


def rows_against_parent(cs, tc, ptc, pipe, scene, args, reps):
    """Rows 1, 2, 3, 6 and 7 on both ports: bitwise equality of every
    recorded call, and each name's call ms a scene in turns."""
    import torch

    sep = cs.build_separate()
    sep_args = sep.prepare_quantized(*cs.quantize(scene))
    records, _ = cs.record_calls(
        pipe, sep, args, cs.planted_rows(scene, args), sep_args,
        cs.separate_rows(scene, sep_args, len(sep.categories)))
    del sep
    out = {n: {"calls": 0, "bitwise_equal": True, "call_ms": [0.0] * 4}
           for n in ROWS}
    for r in records.values():
        name = r["name"]
        if name not in ROWS:
            continue
        a, kw = r["args"], r["kw"]
        fc, fp = getattr(tc, name), getattr(ptc, name)
        s = out[name]
        s["calls"] += r["count"]
        s["bitwise_equal"] &= bool(torch.equal(
            fc(*a, **cs.fresh(kw)).view(torch.int16),
            fp(*a, **cs.fresh(kw)).view(torch.int16)))
        kc, kp = cs.fresh(kw), cs.fresh(kw)
        for i, f in enumerate((lambda: fp(*a, **kp), lambda: fc(*a, **kc),
                               lambda: fc(*a, **kc), lambda: fp(*a, **kp))):
            s["call_ms"][i] += cs.time_ms(f, reps) * r["count"]
    for s in out.values():
        p1, c1, c2, p2 = s.pop("call_ms")
        s.update(parent_ms=[p1, p2], current_ms=[c1, c2])
    return out


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--parent", default=None)
    parser.add_argument("--rows", action="store_true")
    parser.add_argument("--ptxas", action="store_true")
    opt = parser.parse_args()
    reps = opt.reps
    if not torch.cuda.is_available():
        print("block_probe: no CUDA device", file=sys.stderr)
        return 2
    if (opt.rows or opt.ptxas) and not opt.parent:
        print("block_probe: --rows and --ptxas need --parent", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc
    from canonicalvoting_tpu_torch.ops.cuda_build import build_all

    build_all()
    ptc = load_port(opt.parent) if opt.parent else None
    torch.set_grad_enabled(False)
    scene = cs.make_scenes()[0]
    pipe = cs.build_pipeline()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    blocks, forward = [], du.BasicBlock.forward

    def rec(blk, x, occ, tiles, ts, in_perm=None):
        blocks.append((blk, x, occ, tiles, ts))
        return forward(blk, x, occ, tiles, ts, in_perm)

    with cs.patched(du.BasicBlock, forward=rec):
        pipe.run_backbone(args)
    torch.cuda.synchronize()
    levels = {shape: i for i, shape in enumerate(sorted(
        {tuple(b[2].shape) for b in blocks},
        key=lambda sh: -sh[0] * sh[1] * sh[2]))}
    has_pieces = hasattr(tc, "_block_splits")
    report_blocks = []
    for i, (blk, x, occ, tiles, ts) in enumerate(blocks):
        kw = block_kw(blk, occ, ts)
        a = (x, blk.conv1.kernel, blk.conv2.kernel, tiles)
        cells = tc._row_cells(tiles, ts)
        live = int((occ.reshape(-1)[tc._flat(cells, occ.shape)] > 0).sum())

        def row9(m=tc):  # the BN folds in the call, as the two convs run them
            return m.tiled_block3d(*a, **block_kw(blk, occ, ts))

        def convs(m=tc):
            return two_conv(m, blk, x, occ, tiles, ts)

        got, want = row9(), convs()
        entry = {
            "block": i, "level": levels[tuple(occ.shape)],
            "config": {"cin": int(x.shape[3]), "mid": int(a[1].shape[2]),
                       "cout": int(a[2].shape[2]), "tile_shape": list(ts),
                       "tiles": int(tiles.shape[0]),
                       "listed_cells": int(cells.shape[0]),
                       "occupied_cells": live,
                       "residual": "1x1" if blk.downsample else "identity"},
            "row9_equals_two_conv": bool(torch.equal(got.view(torch.int16),
                                                     want.view(torch.int16)))}
        entry["row9"] = {"sha1": sha1(got)}
        entry["two_conv"] = {"sha1": sha1(want)}
        if ptc is not None:
            pgot, pwant = row9(ptc), convs(ptc)
            entry["parent_row9"] = {"sha1": sha1(pgot)}
            entry["parent_two_conv"] = {"sha1": sha1(pwant)}
            entry["row9_equals_parent_two_conv"] = bool(torch.equal(
                got.view(torch.int16), pwant.view(torch.int16)))
            del pgot, pwant
            p1 = timed(cs, lambda: row9(ptc), reps)
        del got, want
        t1, t2 = timed(cs, row9, reps), timed(cs, row9, reps)
        entry["row9"].update(call_ms=[t1["call_ms"], t2["call_ms"]],
                             host_ms=[t1["host_ms"], t2["host_ms"]],
                             device_ms=device_ms(row9))
        c1, c2 = timed(cs, convs, reps), timed(cs, convs, reps)
        entry["two_conv"].update(call_ms=[c1["call_ms"], c2["call_ms"]],
                                 host_ms=[c1["host_ms"], c2["host_ms"]],
                                 device_ms=device_ms(convs))
        if ptc is not None:
            p2 = timed(cs, lambda: row9(ptc), reps)
            entry["parent_row9"].update(
                call_ms=[p1["call_ms"], p2["call_ms"]],
                host_ms=[p1["host_ms"], p2["host_ms"]],
                device_ms=device_ms(lambda: row9(ptc)))
            entry["parent_two_conv"].update(
                call_ms=[cs.time_ms(lambda: convs(ptc), reps)])
        if has_pieces:
            pieces = host_pieces(tc, cs, x, blk, tiles, kw, reps)
            pieces["rest"] = cs.host_ms(row9, reps) - sum(
                v for k, v in pieces.items() if k != "ctypes")
            entry["host_pieces_ms"] = pieces
        report_blocks.append(entry)
    by_level = {}
    for e in report_blocks:
        lv = by_level.setdefault(e["level"], {"blocks": 0})
        lv["blocks"] += 1
        for key in ("row9", "two_conv", "parent_row9"):
            if key not in e:
                continue
            d = lv.setdefault(key, {"call_ms": 0.0, "host_ms": 0.0,
                                    "device_ms": 0.0, "device_by_piece": {}})
            d["call_ms"] += min(e[key]["call_ms"])
            d["host_ms"] += min(e[key]["host_ms"])
            for p, v in by_piece(e[key]["device_ms"]).items():
                d["device_ms"] += v
                d["device_by_piece"][p] = d["device_by_piece"].get(p, 0.0) + v
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip(),
              "blocks": report_blocks,
              "levels": {str(k): v for k, v in sorted(by_level.items())},
              "all_row9_equal_two_conv": all(e["row9_equals_two_conv"]
                                             for e in report_blocks)}
    for key in ("row9", "two_conv", "parent_row9"):
        report[f"{key}_call_ms_total"] = sum(
            lv[key]["call_ms"] for lv in by_level.values() if key in lv)
    blocks.clear()
    torch.cuda.empty_cache()
    if opt.rows:
        report["rows"] = rows_against_parent(cs, tc, ptc, pipe, scene, args, reps)
    if opt.ptxas:
        report["ptxas"] = ptxas_pairs(opt.parent)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
