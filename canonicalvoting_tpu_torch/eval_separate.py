"""Per-category (separate) evaluation CLI of the port.

Usage:
  python -m canonicalvoting_tpu_torch.eval_separate --synthetic [pretrained_dir=<dir>] [key=value ...]

Nine MinkUNet34C(3, 8) models, one per category of ``ALL_CATEGORIES``,
run over each scene (``eval/separate.py``). ``pretrained_dir=`` holds the
upstream per-category checkpoints, ``<wnid>.pth`` (the upstream
``eval_separate.py`` names); a category without one gets random weights
from a seed. ``--synthetic`` evaluates two synthetic scenes; real ScanNet
loading is not ported yet. ``--config=<yaml>`` and ``key=value`` overrides
set the keys of ``config.py``. It runs on the GPU; ``--cpu`` asks for the
CPU.
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger("eval_separate")


def main(argv) -> dict:
    from canonicalvoting_tpu_torch.config import load_config
    from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
    from canonicalvoting_tpu_torch.eval.separate import (
        ALL_CATEGORIES, SeparateDetectionPipeline)
    from canonicalvoting_tpu_torch.eval_joint import synthetic_scenes
    from canonicalvoting_tpu_torch.metrics.ap import compute_map
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

    if "--synthetic" not in argv:
        raise SystemExit("only --synthetic evaluation is ported so far")
    device = "cpu" if "--cpu" in argv else "cuda"
    pretrained_dir, yaml_path, overrides = None, None, []
    for a in argv:
        if a.startswith("pretrained_dir="):
            pretrained_dir = a.split("=", 1)[1]
        elif a.startswith("--config="):
            yaml_path = a.split("=", 1)[1]
        elif not a.startswith("--"):
            overrides.append(a)
    cfg = load_config(yaml_path, overrides)

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
    scenes, gts = synthetic_scenes(cfg.scannet_res, n=2)
    pred = {}
    for id_scan, coords, feats_raw in scenes:
        pred[id_scan] = pipe.detect(coords, feats_raw)
        logger.info("%s: %d detections", id_scan, len(pred[id_scan]))
    results = {}
    for thresh in (0.25, 0.5):
        d = compute_map(pred, {k: gts[k] for k in pred}, ovthresh=thresh,
                        processes=1)
        results[thresh] = d
        for category in ALL_CATEGORIES:
            logger.info("%s Recall: %s  Average Precision: %s", category,
                        d.get(f"{category} Recall", 0),
                        d.get(f"{category} Average Precision", 0))
        logger.info("mAP@%.2f: %s", thresh, d["mAP"])
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
