"""Measure the stride-2 down conv (``tiled_down2``) by level on one GPU, for
the port in the current directory.

    cd <checkout root> && python3 <path>/tools/down_probe.py [--reps N]

It imports ``canonicalvoting_tpu_torch`` from the working directory and the
workload and timers from the ``chip_smoke.py`` of the checkout that holds
the script (as ``tools/splat_probe.py`` does), so one copy of the script
measures two checkouts in turn on the same workload: the four down convs of
one joint pass over ``chip_smoke.py``'s first scene (into L1, L1 -> L2,
L2 -> L3, L3 -> L4; a separate scene runs the same four widths once per
category).

Prints one JSON line with, for each level:

- ``config``: input channels, weights, tile shape, listed tiles, and the
  listed and occupied coarse cells;
- ``call_ms``: one wrapper call, CUDA events over ``reps`` calls (the
  output grid's zero fill and the weights' layout included);
- ``host_ms``: the host's time to issue one call, no sync between calls;
- ``folded``: ``call_ms`` and ``host_ms`` of a call given the weights laid
  out once by the caller (``wt=``, as the separate evaluator passes them),
  where the checkout has that argument;
- ``host_pieces_ms``: the host's time to issue each piece of one call,
  each piece alone in the same loop (where the checkout has the pieces):
  the output's zero fill, the weights' layout, the affine and occupancy
  arguments, the row list, the split scratch, the launch function (its
  memset, compaction, GEMM and reduction), the launch function's ctypes
  call alone (with no rows it returns at once), and the rest of the
  wrapper (its checks and glue: the call less the other pieces but the
  ctypes call, which the launch holds);
- ``device_ms``: device time by kernel name over one call, from
  ``torch.profiler`` (the zero fill, the weights' cast or transpose, the
  memset, the row compaction, the GEMM and the split-K reduction apart);
- ``sha1``: of the output grid's bytes, to compare checkouts bit for bit
  (the checkouts' outputs differ where their summation orders do).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from splat_probe import device_ms, load_chip_smoke  # noqa: E402


def host_pieces(tc, cs, x, w, tiles, kw, wt, reps):
    """{piece: the host's ms to issue it}: each piece of tiled_down2's
    CUDA route alone, as the wrapper runs it, over ``reps`` calls."""
    import torch

    dev, ts, cout = x.device, kw["tile_shape"], w.shape[2]
    cshape = tuple(kw["occ"].shape)
    cpad = wt.shape[2]
    n_rows = tiles.shape[0] * ts[0] * ts[1] * ts[2]
    out = torch.zeros(cshape + (cout,), dtype=x.dtype, device=dev)
    sc, bi, oc = (tc._f32(kw[k], dev) for k in ("scale", "bias", "occ"))
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    s_max, part = tc._split_scratch(8 * cpad // tc.K_CHUNK, n_rows, cout, 0, dev)
    launch = tc._launcher("tiled_down2_launch")

    def run(n):
        return launch(x.data_ptr(), x.shape[3], *x.shape[:3], wt.data_ptr(),
                      cpad, cout, tiles.data_ptr(), n, *ts, *cshape,
                      tc._ptr(sc), tc._ptr(bi), tc._ptr(oc),
                      int(kw["relu_out"]), rows.data_ptr(), out.data_ptr(),
                      tc._ptr(part), s_max, tc._stream())

    return {
        "out_zeros": cs.host_ms(lambda: torch.zeros(
            cshape + (cout,), dtype=x.dtype, device=dev), reps),
        "weights": cs.host_ms(lambda: tc.down2_weights(
            w, dtype=x.dtype, device=dev), reps),
        "affine_occ": cs.host_ms(lambda: [tc._f32(kw[k], dev) for k in
                                          ("scale", "bias", "occ")], reps),
        "row_list": cs.host_ms(lambda: torch.empty(
            n_rows + 2, dtype=torch.int32, device=dev), reps),
        "split_scratch": cs.host_ms(lambda: tc._split_scratch(
            8 * cpad // tc.K_CHUNK, n_rows, cout, 0, dev), reps),
        "launch": cs.host_ms(lambda: run(n_rows), reps),
        "ctypes": cs.host_ms(lambda: run(0), reps)}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    reps = parser.parse_args().reps
    if not torch.cuda.is_available():
        print("down_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc

    torch.set_grad_enabled(False)
    scene = cs.make_scenes()[0]
    pipe = cs.build_pipeline()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    calls = []

    def rec(*a, **kw):
        calls.append((a, kw))
        return tc.tiled_down2(*a, **kw)

    with cs.patched(du, tiled_down2=rec):
        pipe.run_backbone(args)
    torch.cuda.synchronize()
    levels = []
    for lvl, (a, kw) in enumerate(calls, start=1):
        x, w, tiles = a[:3]
        ts = kw["tile_shape"]
        cells = tc._row_cells(tiles, ts)
        occ = kw["occ"]
        live = int((occ.reshape(-1)[tc._flat(cells, occ.shape)] > 0).sum())

        def call():
            return tc.tiled_down2(*a, **kw)

        out = call()
        folded, pieces = {}, {}
        if hasattr(tc, "down2_weights"):
            wt = tc.down2_weights(w, dtype=x.dtype, device=x.device)

            def call_folded():
                return tc.tiled_down2(*a, **{**kw, "wt": wt})

            folded = {"call_ms": cs.time_ms(call_folded, reps),
                      "host_ms": cs.host_ms(call_folded, reps)}
            pieces = host_pieces(tc, cs, x, w, tiles, kw, wt, reps)
            pieces["rest"] = cs.host_ms(call, reps) - sum(
                v for k, v in pieces.items() if k != "ctypes")
        levels.append({
            "level": lvl,
            "config": {"cin": int(x.shape[3]), "weights": list(w.shape),
                       "tile_shape": list(ts), "tiles": int(tiles.shape[0]),
                       "listed_cells": int(cells.shape[0]),
                       "occupied_cells": live},
            "call_ms": cs.time_ms(call, reps),
            "host_ms": cs.host_ms(call, reps),
            "device_ms": device_ms(call),
            "folded": folded,
            "host_pieces_ms": pieces,
            "sha1": hashlib.sha1(out.contiguous().view(torch.int16).cpu()
                                 .numpy().tobytes()).hexdigest()})
        del out
    report = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip(),
              "levels": levels,
              "call_ms_total": sum(v["call_ms"] for v in levels)}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
