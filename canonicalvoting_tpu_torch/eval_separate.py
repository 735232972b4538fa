"""Per-category (separate) evaluation CLI of the port.

Usage:
  python -m canonicalvoting_tpu_torch.eval_separate [pretrained_dir=<dir>] data.scan2cad=... [key=value ...]
  python -m canonicalvoting_tpu_torch.eval_separate --synthetic

Nine MinkUNet34C(3, 8) models, one per category of ``ALL_CATEGORIES``,
run over each scene (``eval/separate.py``). It evaluates the ScanNet
validation scans of ``data.val_split`` with their Scan2CAD annotations
against ``data.gt_path``; ``--synthetic`` two synthetic scenes.
``pretrained_dir=`` holds the per-category weights, looked for as the JAX
``eval_separate.py`` looks: the upstream ``<wnid>.pth``, then the JAX
package's ``<category>.ckpt``; a category with neither gets random weights
from a seed. ``--config=<yaml>`` and ``key=value`` overrides set the keys
of ``config.py``. It runs on the GPU; ``--cpu`` asks for the CPU.
``--no-mesh`` is accepted: one card runs every scene.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("eval_separate")


def main(argv) -> dict:
    from canonicalvoting_tpu_torch.config import load_config, parse_cli
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.gt import load_gt_scene
    from canonicalvoting_tpu_torch.eval.separate import (
        ALL_CATEGORIES, SeparateDetectionPipeline)
    from canonicalvoting_tpu_torch.eval_joint import synthetic_scenes
    from canonicalvoting_tpu_torch.metrics.ap import compute_map
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

    synthetic = "--synthetic" in argv
    device = "cpu" if "--cpu" in argv else "cuda"
    # --no-mesh: one card runs every scene, there is nothing to fan out
    argv = [a for a in argv if a not in ("--synthetic", "--no-mesh", "--cpu")]
    pretrained_dir, rest = None, []
    for a in argv:
        if a.startswith("pretrained_dir="):
            pretrained_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    yaml_path, overrides, _ = parse_cli(rest)
    cfg = load_config(yaml_path, overrides)
    cfg.category = "all"

    model = DenseMinkUNet34C(cfg.in_channels, 8,
                             compute_dtype=cfg.tpu.conv_dtype)
    if pretrained_dir is None:
        logger.warning("no pretrained_dir given: evaluating random weights")
    pipe = SeparateDetectionPipeline(
        model=model, res=cfg.scannet_res, log_scale=cfg.log_scale,
        peel=PeelConfig(res=cfg.scannet_res, elimination_inclusive=False,
                        max_boxes=cfg.tpu.max_boxes),
        device=device)
    pipe.set_state_dicts(
        category_state_dicts(model, ALL_CATEGORIES, pretrained_dir))
    if synthetic:
        items, gts = synthetic_scenes(cfg.scannet_res, n=2)
        scenes, gt_for = iter(items), gts.__getitem__
    else:
        from canonicalvoting_tpu_torch.data.scannet import (
            ScanNetXYZProbMultiDataset)

        ds = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)
        scenes = (ds[i][:3] for i in range(len(ds)))

        def gt_for(id_scan):
            return load_gt_scene(cfg.data.gt_path, id_scan, map_catname=True)

    pred, gt = {}, {}
    for id_scan, coords, feats_raw in scenes:
        pred[id_scan] = pipe.detect(coords, feats_raw)
        gt[id_scan] = gt_for(id_scan)
        logger.info("%s: %d detections", id_scan, len(pred[id_scan]))
    results = {}
    for thresh in (0.25, 0.5):
        logger.info("thresh: %s", thresh)
        d = compute_map(pred, gt, ovthresh=thresh, processes=1)
        results[thresh] = d
        for category in ALL_CATEGORIES:
            logger.info("%s Recall: %s", category,
                        d.get(f"{category} Recall", 0))
            logger.info("%s Average Precision: %s", category,
                        d.get(f"{category} Average Precision", 0))
        logger.info("mAP: %s", d["mAP"])
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
