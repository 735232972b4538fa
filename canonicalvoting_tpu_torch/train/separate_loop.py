"""Per-category (separate) training loop (upstream
train_separate.py:184-459).

The port's counterpart of ``canonicalvoting_tpu/train/separate_loop.py``:
the joint trainer's epoch loop (``train/joint_loop.py:train_epochs``) with
the separate losses, and, every ``eval_every`` epochs, a checkpoint and a
detection + Scan2CAD mAP validation of the one category
(upstream train_separate.py:301-455): each validation scene runs through
``SeparateDetectionPipeline`` (the dense backbone on the card's kernels,
the prefolded stem), its detections labeled with the trained category,
and the category's AP and recall are logged.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Callable, Optional

import torch

from canonicalvoting_tpu_torch.data.collate import collate_separate
from canonicalvoting_tpu_torch.data.geometry import NAME2CATNAME
from canonicalvoting_tpu_torch.data.loader import DataLoader
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.gt import load_gt_scene
from canonicalvoting_tpu_torch.eval.separate import SeparateDetectionPipeline
from canonicalvoting_tpu_torch.metrics.ap import compute_map
from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C, dense_twin
from canonicalvoting_tpu_torch.train.joint_loop import train_epochs
from canonicalvoting_tpu_torch.train.steps import (
    check_ported_routes, create_train_state, make_separate_train_step)

logger = logging.getLogger(__name__)


def run_separate_training(cfg, train_dataset, val_dataset, workdir: str = ".",
                          gt_lookup: Optional[Callable] = None,
                          eval_every: int = 10, max_epoch: Optional[int] = None,
                          cap_multiple: int = 4096, model=None, device="cuda"):
    """Train one per-category model; returns (state, the last validation's
    mAP dict or None). Without ``model``, a MinkUNet34C(in, 8) with weights
    drawn from seed 0."""
    check_ported_routes(cfg)
    os.makedirs(workdir, exist_ok=True)
    max_epoch = max_epoch if max_epoch is not None else cfg.max_epoch
    max_objects = cfg.tpu.max_objects
    if model is None:
        model = MinkUNet34C(cfg.in_channels, 8, compute_dtype=cfg.tpu.conv_dtype,
                            generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg.weight_decay, device)
    step_fn = make_separate_train_step(state.model, cfg, max_objects)
    loader = DataLoader(
        train_dataset, batch_size=cfg.batch_size,
        collate_fn=functools.partial(
            collate_separate, cap_multiple=cap_multiple,
            max_objects=max_objects, microbatch=cfg.tpu.train_microbatch),
        shuffle=True, num_workers=cfg.num_workers, drop_last=True)
    try:
        return train_epochs(
            cfg, state, loader, step_fn, workdir, eval_every, max_epoch,
            lambda s: run_separate_validation(cfg, s.model, val_dataset,
                                              gt_lookup, device),
            tag=f"[{cfg.category}] ")
    finally:
        loader.close()


def run_separate_validation(cfg, model, val_dataset, gt_lookup=None,
                            device="cuda"):
    """Detection + mAP over the validation split for ONE category model
    (upstream train_separate.py:301-455); returns {thresh: compute_map
    dict} at 0.25 and 0.5."""
    category = NAME2CATNAME.get(cfg.category, cfg.category)
    dense = dense_twin(model)
    pipe = SeparateDetectionPipeline(
        model=dense, state_dicts=[dense.state_dict()], categories=[category],
        res=cfg.scannet_res, log_scale=cfg.log_scale,
        # the trainer's peel takes the inclusive elimination slice
        # (train_separate.py:389: `cand+elimination+1`), unlike eval_separate
        peel=PeelConfig(res=cfg.scannet_res, elimination_inclusive=True,
                        max_boxes=cfg.tpu.max_boxes),
        device=device)
    pred, gt = {}, {}
    for i in range(len(val_dataset)):
        id_scan, coords, feats_raw = val_dataset[i][:3]
        pred[id_scan] = pipe.detect(coords, feats_raw)
        gt[id_scan] = (gt_lookup(id_scan) if gt_lookup is not None
                       else load_gt_scene(cfg.data.gt_path, id_scan,
                                          map_catname=True))
    results = {}
    for thresh in (0.25, 0.5):
        d = compute_map(pred, gt, ovthresh=thresh, processes=1)
        logger.info("[%s] IoU %.2f: Recall=%s AP=%s", category, thresh,
                    d.get(f"{category} Recall", 0.0),
                    d.get(f"{category} Average Precision", 0.0))
        results[thresh] = d
    return results
