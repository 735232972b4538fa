"""Joint training loop (upstream train_joint.py:191-473).

The port's counterpart of ``canonicalvoting_tpu/train/joint_loop.py``: an
epoch loop with the upstream schedules (step LR decay, BN-momentum decay),
a checkpoint and a full detection + Scan2CAD mAP validation every
``eval_every`` epochs, and auto-resume from the newest checkpoint of the
work directory (either package's). Ground truth comes from the results_gt
txt files (ScanNet) or from a callback (synthetic runs).

It trains on the card unless ``device="cpu"``: the gather-form sparse
backbone, or with ``tpu.train_backbone=dense`` its masked dense twin
(``DenseMinkUNet.train_forward`` on ``collate_joint_dense`` batches);
``tpu.train_remat`` recomputes each residual block in the backward. The
validation runs ``DetectionPipeline`` on the dense backbone (the card's
tiled kernels, at the model's ``compute_dtype``: ``tpu.conv_dtype``,
bfloat16 or float32) with the trained weights. ``tpu.train_microbatch``
k > 0 accumulates gradients over microbatches of k scenes; 0 (the default)
steps on the whole batch, except on the dense route on the card, which
takes 1 as the JAX package's accelerator does. ``tpu.train_dense_levels``
sites (default: the stem) run through the scatter-dense engine on the
gather backbone: the loader collates flat level ids for them.

With ``tpu.mesh_data`` x ``tpu.mesh_model`` > 1 the loop trains on a mesh
(``parallel/data_parallel.py``), as the JAX package's mesh branch does and
before the backbone choice: the gather backbone with no microbatching
and no dense sites, sync-BN over the data ranks, the conv kernels
column-parallel over the model ranks. The port runs one process a device:
the branch needs an initialized process group (torchrun, or
``parallel/launch.py:run_ranks``), of which every rank calls the loop.
Each rank's loader draws the same global batch of ``batch_size x data``
scenes (the loader's seed) and collates the rank's shard. Every rank
resumes from the full checkpoint and takes its slices; at a validated
epoch the ranks gather the full state, rank 0 alone writes the
checkpoint (one the single-process loop and the JAX package restore) and
the metrics logs and runs the single-device validation, and the others
wait for its result.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Callable, Optional

import torch

from canonicalvoting_tpu_torch.data.collate import (
    collate_joint, collate_joint_dense, collate_joint_sharded)
from canonicalvoting_tpu_torch.data.geometry import NCLASSES
from canonicalvoting_tpu_torch.data.loader import DataLoader
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.gt import load_gt_scene
from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
from canonicalvoting_tpu_torch.metrics.ap import compute_map
from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C, dense_twin
from canonicalvoting_tpu_torch.parallel.data_parallel import (
    gather_train_state, make_dp_train_step, shard_train_state, share_result,
    training_mesh)
from canonicalvoting_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from canonicalvoting_tpu_torch.train.schedules import (
    bn_momentum_for_epoch, lr_for_epoch)
from canonicalvoting_tpu_torch.train.steps import (
    create_train_state, create_train_state_dense,
    make_joint_train_step, parse_dense_sites, train_backbone, train_microbatch)
from canonicalvoting_tpu_torch.utils.meters import AverageMeter
from canonicalvoting_tpu_torch.utils.metrics_log import MetricsLogger

logger = logging.getLogger(__name__)


def train_epochs(cfg, state, loader, step_fn, workdir: str, eval_every: int,
                 max_epoch: int, validate: Callable, tag: str = "",
                 mesh=None):
    """The epoch loop both trainers share: resume from the newest
    checkpoint of ``workdir``, then per epoch the scheduled learning rate
    and BN momentum, one step a batch, and every ``eval_every`` epochs a
    checkpoint and ``validate(state)``. Each epoch's row goes to
    ``workdir/train.{csv,jsonl}`` and each validation's table at IoU t to
    ``workdir/val_iou<t>.{csv,jsonl}`` (``utils/metrics_log.py``). Returns
    (state, the last validation's result or None). On a ``mesh`` the full
    ``state`` is restored on every rank and then sharded; a validated
    epoch gathers it, and rank 0 alone writes the checkpoint and the logs
    and validates, its result shared with the others."""
    start_epoch = cfg.start_epoch
    ckpt = latest_checkpoint(workdir)
    if ckpt is not None:
        state, saved_epoch = restore_checkpoint(ckpt, state)
        start_epoch = saved_epoch + 1
        logger.info("%sresumed from %s (epoch %d)", tag, ckpt, saved_epoch)
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        state = shard_train_state(state, mesh)
    meter = AverageMeter()
    ret = None
    train_log = MetricsLogger(workdir, "train") if lead else None
    for epoch in range(start_epoch, max_epoch + 1):
        lr = lr_for_epoch(epoch, cfg.opt.learning_rate, cfg.lr_decay_steps,
                          cfg.lr_decay_rates)
        mom = bn_momentum_for_epoch(epoch, cfg.opt.bn_decay_step,
                                    cfg.opt.bn_decay_rate)
        meter.reset()
        t0 = time.perf_counter()
        scenes = 0
        for batch in loader:
            state, losses = step_fn(state, batch, lr, mom)
            meter.update(float(losses["loss"]))
            scenes += len(batch["meta"]["ids"]) * (mesh.data if mesh else 1)
        seconds = time.perf_counter() - t0
        state.history.append({"epoch": epoch, "loss": meter.avg,
                              "batches": meter.count, "scenes": scenes,
                              "seconds": seconds})
        logger.info("%sepoch %d: loss=%.4f (%.1fs, lr=%.2e, bn_mom=%.3f)",
                    tag, epoch, meter.avg, seconds, lr, mom)
        if lead:
            train_log.log(epoch, {**state.history[-1], "lr": lr,
                                  "bn_momentum": mom})
        if epoch % eval_every == 0:
            full = state if mesh is None else gather_train_state(state, mesh)
            if lead:
                save_checkpoint(os.path.join(workdir, f"epoch{epoch}.ckpt"),
                                full, epoch)
                ret = validate(full)
                for thresh, table in ret.items():
                    MetricsLogger(workdir, f"val_iou{thresh}").log_map_table(
                        epoch, table, thresh)
            if mesh is not None:
                ret = share_result(ret, mesh)
    return state, ret


def run_joint_training(cfg, train_dataset, val_dataset, workdir: str = ".",
                       gt_lookup: Optional[Callable] = None,
                       eval_every: int = 10, max_epoch: Optional[int] = None,
                       cap_multiple: Optional[int] = None, model=None,
                       device="cuda"):
    """Train the joint model; returns (state, the last validation's mAP
    dict or None). Without ``model``, a MinkUNet34C with weights drawn from
    seed 0."""
    os.makedirs(workdir, exist_ok=True)
    cap_multiple = cap_multiple or cfg.tpu.point_buckets[0]
    max_epoch = max_epoch if max_epoch is not None else cfg.max_epoch
    if model is None:
        model = MinkUNet34C(cfg.in_channels, 6 * NCLASSES + NCLASSES + 1,
                           compute_dtype=cfg.tpu.conv_dtype,
                           generator=torch.Generator().manual_seed(0))
    mesh = None
    if cfg.tpu.mesh_data * cfg.tpu.mesh_model > 1:
        mesh = training_mesh(cfg, device)
        device = mesh.device
        state = create_train_state(model, cfg.weight_decay, device)
        step_fn = make_dp_train_step(state.model, cfg, mesh)
        batch_size = cfg.batch_size * mesh.data
        collate = functools.partial(
            collate_joint_sharded, n_shards=mesh.data, shard=mesh.coords[0],
            cap_multiple=cap_multiple)
    else:
        backbone = train_backbone(cfg)
        mb = train_microbatch(cfg, backbone, device)
        if backbone == "dense":
            state = create_train_state_dense(model, cfg.weight_decay, device,
                                             remat=cfg.tpu.train_remat)
            collate = functools.partial(collate_joint_dense, microbatch=mb)
        else:
            state = create_train_state(model, cfg.weight_decay, device,
                                       remat=cfg.tpu.train_remat)
            collate = functools.partial(
                collate_joint, microbatch=mb, with_flat_levels=bool(
                    parse_dense_sites(cfg.tpu.train_dense_levels)))
        step_fn = make_joint_train_step(state.model, cfg, backbone=backbone)
        batch_size = cfg.batch_size
        collate = functools.partial(collate, cap_multiple=cap_multiple)
    loader = DataLoader(train_dataset, batch_size=batch_size, collate_fn=collate,
                        shuffle=True, num_workers=cfg.num_workers,
                        drop_last=True)
    try:
        return train_epochs(
            cfg, state, loader, step_fn, workdir, eval_every, max_epoch,
            lambda s: run_joint_validation(cfg, s.model, val_dataset,
                                           gt_lookup, device), mesh=mesh)
    finally:
        loader.close()


def run_joint_validation(cfg, model, val_dataset, gt_lookup=None,
                         device="cuda"):
    """Detection + Scan2CAD mAP over the validation split (upstream
    train_joint.py:293-473) with ``model``'s weights (a ``MinkUNetBase`` or
    a ``DenseMinkUNet``) on the dense backbone at its compute dtype;
    returns {thresh: compute_map dict} at 0.25 and 0.5."""
    pipe = DetectionPipeline(
        model=dense_twin(model), res=cfg.scannet_res, num_rots=120,
        log_scale=cfg.log_scale, use_xyz=cfg.use_xyz,
        peel=PeelConfig(res=cfg.scannet_res, max_boxes=cfg.tpu.max_boxes),
        cap_multiple=cfg.tpu.point_buckets[0], device=device)
    pred, gt = {}, {}
    for i in range(len(val_dataset)):
        id_scan, coords, feats_raw = val_dataset[i][:3]
        # a budget exit of the peel re-runs the tail, so that no truncated
        # scene feeds the mAP (upstream peels unbounded, eval_joint.py:204)
        out = pipe.run_scene_with_retry(pipe.prepare_quantized(coords, feats_raw))
        pred[id_scan] = pipe.postprocess(out)
        gt[id_scan] = (gt_lookup(id_scan) if gt_lookup is not None
                       else load_gt_scene(cfg.data.gt_path, id_scan))
    results = {}
    for thresh in (0.25, 0.5):
        d = compute_map(pred, gt, ovthresh=thresh, processes=1)
        logger.info("IoU %.2f: mAP=%.4f AR=%.4f", thresh, d["mAP"], d["AR"])
        results[thresh] = d
    return results
