"""Joint-model evaluation CLI of the port.

Usage:
  python -m canonicalvoting_tpu_torch.eval_joint --synthetic [checkpoint=<path>.pth] [key=value ...]

``--synthetic`` evaluates three synthetic scenes (the JAX package's
``eval_joint.py --synthetic`` recipe); ``checkpoint=`` loads an upstream
``.pth`` file, otherwise the weights are random. ``--config=<yaml>`` and
``key=value`` overrides set the keys of ``config.py``. It runs on the GPU;
``--cpu`` asks for the CPU. Real ScanNet loading is not ported yet.
"""

from __future__ import annotations

import logging
import sys

import numpy as np
import torch

logger = logging.getLogger("eval_joint")


def synthetic_scenes(res: float, n: int = 3, seed: int = 0):
    """[(id, coords, rgb)] and {id: [(classname, corners)]} ground truth."""
    from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME
    from canonicalvoting_tpu_torch.data.synthetic import make_scene
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    rng = np.random.RandomState(seed)
    items, gts = [], {}
    for i in range(n):
        scene = make_scene(rng, extent=(4.0, 2.0, 4.0), n_background=15000,
                           n_boxes=3, pts_per_box=2000)
        coords, idx = sparse_quantize(scene.points, res)
        items.append((f"synthetic{i}", coords, scene.rgb[idx]))
        gts[f"synthetic{i}"] = [(NAME2CATNAME[IDX2NAME[ci]], c)
                                for ci, c in scene.gt_corners()]
    return items, gts


def main(argv) -> dict:
    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.data.geometry import NCLASSES
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.metrics.ap import compute_map
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import load_pth

    if "--synthetic" not in argv:
        raise SystemExit("only --synthetic evaluation is ported so far")
    device = "cpu" if "--cpu" in argv else "cuda"
    checkpoint, yaml_path, overrides = None, None, []
    for a in argv:
        if a.startswith("checkpoint="):
            checkpoint = a.split("=", 1)[1]
        elif a.startswith("--config="):
            yaml_path = a.split("=", 1)[1]
        elif not a.startswith("--"):
            overrides.append(a)
    cfg = load_config(yaml_path, overrides)

    torch.manual_seed(0)
    model = DenseMinkUNet34C(cfg.in_channels, 6 * NCLASSES + NCLASSES + 1,
                             compute_dtype=cfg.tpu.conv_dtype)
    if checkpoint is None:
        logger.warning("no checkpoint given: evaluating random weights")
    else:
        load_pth(model, checkpoint)
    pipe = DetectionPipeline(
        model=model, res=cfg.scannet_res, num_rots=120,
        log_scale=cfg.log_scale, use_xyz=cfg.use_xyz,
        peel=PeelConfig(res=cfg.scannet_res, max_boxes=cfg.tpu.max_boxes),
        device=device)
    scenes, gts = synthetic_scenes(cfg.scannet_res)
    pred = {}
    for id_scan, coords, feats_raw in scenes:
        out = pipe.run_scene_with_retry(pipe.prepare_quantized(coords, feats_raw))
        pred[id_scan] = pipe.postprocess(out)
        logger.info("%s: %d detections", id_scan, len(pred[id_scan]))
    results = {}
    for thresh in (0.25, 0.5):
        d = compute_map(pred, {k: gts[k] for k in pred}, ovthresh=thresh,
                        processes=1)
        results[thresh] = d
        for k in sorted(k for k in d if k.endswith("Average Precision")):
            logger.info("%s: %s", k, d[k])
        logger.info("mAP@%.2f: %s  AR: %s", thresh, d["mAP"], d["AR"])
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
