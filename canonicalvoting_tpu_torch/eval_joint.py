"""Joint-model evaluation CLI of the port.

Usage:
  python -m canonicalvoting_tpu_torch.eval_joint [checkpoint=<.pth|.ckpt>] data.scan2cad=... [key=value ...]
  python -m canonicalvoting_tpu_torch.eval_joint --scenenn data.scene_nn_root=<dir> ...
  python -m canonicalvoting_tpu_torch.eval_joint --synthetic

It evaluates the ScanNet validation scans of ``data.val_split`` with their
Scan2CAD annotations (``data.scan2cad``, ``data.scannet``,
``data.val_segments``) against ``data.gt_path``; ``--scenenn`` the SceneNN
scans under ``data.scene_nn_root`` (needs ``h5py``); ``--synthetic`` three
synthetic scenes (the JAX package's ``eval_joint.py --synthetic`` recipe).
``checkpoint=`` loads an upstream ``.pth`` or a JAX package ``.ckpt``,
otherwise the weights are random. ``--config=<yaml>`` and ``key=value``
overrides set the keys of ``config.py``. It runs on the GPU; ``--cpu`` asks
for the CPU. ``--no-mesh`` is accepted: one card runs every scene.
"""

from __future__ import annotations

import logging
import os
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


# the classes SceneNN's ground truth names (upstream eval_joint.py:280)
SCENENN_CLASSES = ("cabinet", "chair", "table", "sofa", "display")


def main(argv) -> dict:
    from canonicalvoting_tpu_torch.config import load_config, parse_cli
    from canonicalvoting_tpu_torch.data.geometry import NCLASSES
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.gt import load_gt_scene
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.metrics.ap import compute_map
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import load_weights

    scenenn = "--scenenn" in argv
    synthetic = "--synthetic" in argv
    device = "cpu" if "--cpu" in argv else "cuda"
    # --no-mesh: one card runs every scene, there is nothing to fan out
    argv = [a for a in argv if not a.startswith("--scenenn")
            and a not in ("--synthetic", "--no-mesh", "--cpu")]
    checkpoint, rest = None, []
    for a in argv:
        if a.startswith("checkpoint="):
            checkpoint = a.split("=", 1)[1]
        else:
            rest.append(a)
    yaml_path, overrides, _ = parse_cli(rest)
    cfg = load_config(yaml_path, overrides)
    cfg.category = "all"  # upstream eval_joint.py:139

    torch.manual_seed(0)
    model = DenseMinkUNet34C(cfg.in_channels, 6 * NCLASSES + NCLASSES + 1,
                             compute_dtype=cfg.tpu.conv_dtype)
    if checkpoint is None:
        logger.warning("no checkpoint given: evaluating random weights")
    else:
        load_weights(model, checkpoint)
    pipe = DetectionPipeline(
        model=model, res=cfg.scannet_res, num_rots=120,
        log_scale=cfg.log_scale, use_xyz=cfg.use_xyz,
        peel=PeelConfig(res=cfg.scannet_res, max_boxes=cfg.tpu.max_boxes),
        device=device)
    if synthetic:
        items, gts = synthetic_scenes(cfg.scannet_res)
        scenes, gt_for = iter(items), gts.__getitem__
    else:
        from canonicalvoting_tpu_torch.data.scannet import (
            SceneNNDataset, ScanNetXYZProbMultiDataset)

        ds = (SceneNNDataset if scenenn else ScanNetXYZProbMultiDataset)(
            cfg, training=False, augment=False)
        scenes = (ds[i][:3] for i in range(len(ds)))
        gt_dir = (os.path.join(cfg.data.scene_nn_root, "results_gt")
                  if scenenn else cfg.data.gt_path)

        def gt_for(id_scan):
            return load_gt_scene(gt_dir, id_scan, scenenn=scenenn)

    pred, gt = {}, {}
    for id_scan, coords, feats_raw in scenes:
        out = pipe.run_scene_with_retry(pipe.prepare_quantized(coords, feats_raw))
        dets = pipe.postprocess(out)
        if scenenn:
            dets = [d for d in dets if d[0] in SCENENN_CLASSES]
        pred[id_scan] = dets
        gt[id_scan] = gt_for(id_scan)
        logger.info("%s: %d detections", id_scan, len(dets))
    results = {}
    for thresh in (0.25, 0.5):
        logger.info("thresh: %s", thresh)
        d = compute_map(pred, gt, ovthresh=thresh, processes=1)
        results[thresh] = d
        for k in sorted(k for k in d if k.endswith("Average Precision")):
            logger.info("%s: %s", k, d[k])
        logger.info("mean Average Precision: %s", d["mAP"])
        logger.info("AR: %s", d["AR"])
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
