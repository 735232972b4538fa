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
``trace_dir=<dir>`` writes a trace of the evaluation as ``eval_joint``'s.

Under torchrun (``WORLD_SIZE`` > 1), or in a process group of more than one
rank that the caller initialized, the scenes fan out over the ranks, every
category of a scene on one rank (``parallel/scene_parallel.py``), as
``eval_joint`` fans out; ``--no-mesh`` keeps one process evaluating every
scene.
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
        ALL_CATEGORIES, SeparateDetectionPipeline, stack_state_dicts)
    from canonicalvoting_tpu_torch.eval_joint import synthetic_scenes
    from canonicalvoting_tpu_torch.metrics.ap import compute_map
    from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
    from canonicalvoting_tpu_torch.parallel.mesh import fan_out_mesh
    from canonicalvoting_tpu_torch.utils.profiling import device_trace
    from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

    synthetic = "--synthetic" in argv
    no_mesh = "--no-mesh" in argv
    device = "cpu" if "--cpu" in argv else "cuda"
    argv = [a for a in argv if a not in ("--synthetic", "--no-mesh", "--cpu")]
    pretrained_dir, trace_dir, rest = None, None, []
    for a in argv:
        if a.startswith("pretrained_dir="):
            pretrained_dir = a.split("=", 1)[1]
        elif a.startswith("trace_dir="):
            trace_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    yaml_path, overrides, _ = parse_cli(rest)
    cfg = load_config(yaml_path, overrides)
    cfg.category = "all"

    model = DenseMinkUNet34C(cfg.in_channels, 8,
                             compute_dtype=cfg.tpu.conv_dtype)
    if pretrained_dir is None:
        logger.warning("no pretrained_dir given: evaluating random weights")
    peel = PeelConfig(res=cfg.scannet_res, elimination_inclusive=False,
                      max_boxes=cfg.tpu.max_boxes)
    state_dicts = category_state_dicts(model, ALL_CATEGORIES, pretrained_dir)
    if synthetic:
        scenes, gts = synthetic_scenes(cfg.scannet_res, n=2)
        gt_for = gts.__getitem__
    else:
        from canonicalvoting_tpu_torch.data.scannet import (
            ScanNetXYZProbMultiDataset)

        scenes = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)

        def gt_for(id_scan):
            return load_gt_scene(cfg.data.gt_path, id_scan, map_catname=True)

    with fan_out_mesh(device, no_mesh) as mesh, device_trace(trace_dir):
        if mesh is None:
            pipe = SeparateDetectionPipeline(
                model=model, res=cfg.scannet_res, log_scale=cfg.log_scale,
                peel=peel, device=device)
            pipe.set_state_dicts(state_dicts)
            pred = {}
            for i in range(len(scenes)):
                id_scan, coords, feats_raw = scenes[i][:3]
                pred[id_scan] = pipe.detect(coords, feats_raw)
        else:
            from canonicalvoting_tpu_torch.parallel.scene_parallel import (
                evaluate_scenes_sharded_separate)

            # the lazy tail of the pipeline above
            pred = evaluate_scenes_sharded_separate(
                model, stack_state_dicts(state_dicts), scenes, ALL_CATEGORIES,
                mesh=mesh, res=cfg.scannet_res, log_scale=cfg.log_scale,
                peel=peel, lazy_rot_scale=True)
            if mesh.rank != 0:
                return {}
    gt = {}
    for id_scan, dets in pred.items():
        gt[id_scan] = gt_for(id_scan)
        logger.info("%s: %d detections", id_scan, len(dets))
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
