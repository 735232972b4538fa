"""Measure the in-place up-conv (``tiled_up2_into``) by level on one GPU, for
the port in the current directory, beside the concat route's ``tiled_up2``
and the dest copy that the into route's model makes.

    cd <checkout root> && python3 <path>/tools/up_probe.py [--reps N]

It imports ``canonicalvoting_tpu_torch`` from the working directory and the
workload and timers from the ``chip_smoke.py`` of the checkout that holds
the script (as ``tools/splat_probe.py`` does), so one copy of the script
measures two checkouts in turn on the same workload: the two into-convs of
one joint pass with ``up_impl="into"`` over ``chip_smoke.py``'s first
scene (into L1, then into L0).

Prints one JSON line with, for each level:

- ``config``: input channels, weights, skip channels, tile shape, listed
  tiles, listed fine cells, occupied fine cells, and the listed coarse
  parents with an occupied child (live) and without (dead);
- ``call_ms``: one ``tiled_up2_into`` call into a copy of its recorded
  dest, CUDA events over ``reps`` calls; ``host_ms``: the host's time to
  issue one call, no sync between calls; ``device_ms``: device time by
  kernel name over one call, from ``torch.profiler``;
- ``concat``: the same three of the concat route's ``tiled_up2`` call with
  the skip at the same level (its output's zero fill and skip copy
  included);
- ``dest_ms``: the into route's dest, built three ways from the level's
  skip (each CUDA events over ``reps`` calls): ``zeros_then_skip`` (a
  zeroed grid, then the skip copied into its first channels),
  ``empty_then_both`` (an uninitialised grid, the skip copied into its
  first channels and zeros into the rest) and ``cat`` (one concatenation
  of the skip and an expanded zero); ``model`` times the checkout's own
  ``into_dest``;
- ``sha1``: of the conv channels at the listed cells, to compare
  checkouts bit for bit (the checkouts' outputs differ where their
  summation orders do).
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


def dest_recipes(torch):
    """{name: f(skip, skip_c, cout)} of the into route's dest."""
    def zeros_then_skip(skip, skc, cout):
        dest = skip.new_zeros(skip.shape[:3] + (skc + cout,))
        dest[..., :skc] = skip[..., :skc]
        return dest

    def empty_then_both(skip, skc, cout):
        dest = skip.new_empty(skip.shape[:3] + (skc + cout,))
        dest[..., :skc] = skip[..., :skc]
        dest[..., skc:] = 0
        return dest

    def cat(skip, skc, cout):
        zero = skip.new_zeros(()).expand(skip.shape[:3] + (cout,))
        return torch.cat([skip[..., :skc], zero], -1)

    return {"zeros_then_skip": zeros_then_skip,
            "empty_then_both": empty_then_both, "cat": cat}


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    reps = parser.parse_args().reps
    if not torch.cuda.is_available():
        print("up_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = load_chip_smoke()
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.tiled_conv as tc
    from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ

    torch.set_grad_enabled(False)
    scene = cs.make_scenes()[0]
    pipe = cs.build_pipeline()
    args = pipe.prepare_scene(scene.points, scene.rgb)
    calls = []

    def rec(*a, **kw):
        calls.append((a, {**kw, "dest": kw["dest"].clone()}))
        return tc.tiled_up2_into(*a, **kw)

    with cs.patched(du, tiled_up2_into=rec):
        up_impl, pipe.model.up_impl = pipe.model.up_impl, "into"
        try:
            pipe.run_backbone(args)
        finally:
            pipe.model.up_impl = up_impl
    torch.cuda.synchronize()
    recipes = dest_recipes(torch)
    levels = []
    for lvl, (a, kw) in zip((1, 0), calls):
        x, w, tiles = a[:3]
        ts, skc, cout = kw["tile_shape"], kw["skip_c"], w.shape[2]
        cells = tc._row_cells(tiles, ts)
        occ = kw["occ"]
        flat = tc._flat(cells, occ.shape)
        live = int((occ.reshape(-1)[flat] > 0).sum())
        pooled = F.max_pool3d(occ[MX:-MX, MY:-MY, MZ:-MZ][None, None], 2)[0, 0]
        parents = torch.unique(cells >> 1, dim=0)
        parent_live = pooled[parents[:, 0], parents[:, 1], parents[:, 2]] > 0
        dest = kw["dest"].clone()

        def call():
            return tc.tiled_up2_into(*a, **{**kw, "dest": dest})

        out = call()
        conv = out.reshape(-1, out.shape[3])[flat, skc:]
        skip = kw["dest"][..., :skc].contiguous()
        up_kw = {k: kw[k] for k in ("tile_shape", "scale", "bias", "occ",
                                    "relu_out")}

        def concat():
            return tc.tiled_up2(*a, skip=skip, skip_c=skc, **up_kw)

        dest_ms = {name: cs.time_ms(lambda f=f: f(skip, skc, cout), reps)
                   for name, f in recipes.items()}
        dest_ms["model"] = cs.time_ms(lambda: du.into_dest(skip, skc, cout),
                                      reps)
        levels.append({
            "level": lvl,
            "config": {"cin": int(x.shape[3]), "weights": list(w.shape),
                       "skip_c": skc, "tile_shape": list(ts),
                       "tiles": int(tiles.shape[0]),
                       "listed_cells": int(cells.shape[0]),
                       "occupied_cells": live,
                       "live_parents": int(parent_live.sum()),
                       "dead_parents": int((~parent_live).sum())},
            "call_ms": cs.time_ms(call, reps),
            "host_ms": cs.host_ms(call, reps),
            "device_ms": device_ms(call),
            "concat": {"call_ms": cs.time_ms(concat, reps),
                       "host_ms": cs.host_ms(concat, reps),
                       "device_ms": device_ms(concat)},
            "dest_ms": dest_ms,
            "sha1": hashlib.sha1(conv.contiguous().view(torch.int16).cpu()
                                 .numpy().tobytes()).hexdigest()})
        del out, conv, dest, skip
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
