"""Joint-model training CLI of the port (the JAX package's train_joint.py).

Usage:
  python -m canonicalvoting_tpu_torch.train_joint [key=value ...]             # ScanNet (cfg.data paths)
  python -m canonicalvoting_tpu_torch.train_joint --synthetic [key=value ...] # synthetic run

Hydra-style overrides set the keys of ``config.py``: ``scannet_res=0.03
opt.learning_rate=1e-3 ...`` (upstream README.md:73-78); ``--config=<yaml>``
reads a file first. Checkpoints and the auto-resume go to ``workdir=<dir>``
(default ``outputs/<category>``, ``outputs/synthetic_joint`` with
``--synthetic``), with each epoch's row in ``train.{csv,jsonl}`` and each
validation's mAP table in ``val_iou<t>.{csv,jsonl}``. It trains on the
GPU; ``--cpu`` asks for the CPU.

Mesh training runs one process a device, under torchrun:
  torchrun --nproc-per-node 4 -m canonicalvoting_tpu_torch.train_joint \
      tpu.mesh_data=2 tpu.mesh_model=2 [key=value ...]
With ``WORLD_SIZE`` > 1 the CLI initializes the process group from
torchrun's environment (``parallel/mesh.py:init_from_env``: NCCL, one rank
a GPU; gloo with ``--cpu``); in a group, the world size must equal
``tpu.mesh_data`` x ``tpu.mesh_model``. Rank 0 alone writes the
checkpoints and the metrics logs.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys

import numpy as np


def build_synthetic(cfg, n_train=8, n_val=2, seed=0):
    """(train, val, ground-truth lookup) of synthetic scenes: the JAX
    package's ``train_joint.py --synthetic`` recipe."""
    from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME
    from canonicalvoting_tpu_torch.data.loader import ListDataset
    from canonicalvoting_tpu_torch.data.synthetic import make_scene
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    rng = np.random.RandomState(seed)
    items, gts = [], {}
    for i in range(n_train + n_val):
        scene = make_scene(rng, extent=(4.0, 2.0, 4.0), n_background=15000,
                           n_boxes=3, pts_per_box=2000)
        coords, idx = sparse_quantize(scene.points, cfg.scannet_res)
        items.append((f"synthetic{i}", coords, scene.rgb[idx],
                      scene.xyz_labels[idx], scene.scale_labels[idx],
                      scene.class_labels[idx]))
        gts[f"synthetic{i}"] = [(NAME2CATNAME[IDX2NAME[ci]], c)
                                for ci, c in scene.gt_corners()]
    return ListDataset(items[:n_train]), ListDataset(items[n_train:]), gts.get


def split_args(argv):
    """(flags, ``workdir=`` value or None, the rest) of a training CLI's
    arguments."""
    flags = {a for a in argv if a in ("--synthetic", "--cpu")}
    workdir, rest = None, []
    for a in argv:
        if a in flags:
            continue
        if a.startswith("workdir="):
            workdir = a.split("=", 1)[1]
        else:
            rest.append(a)
    return flags, workdir, rest


@contextlib.contextmanager
def training_group(cfg, device: str):
    """torchrun's process group (``WORLD_SIZE`` > 1, no group yet:
    initialized here and destroyed on exit); in a group, the world size
    must be the mesh's ``tpu.mesh_data`` x ``tpu.mesh_model``."""
    import torch.distributed as dist

    from canonicalvoting_tpu_torch.parallel.mesh import init_from_env

    started = (int(os.environ.get("WORLD_SIZE", "1")) > 1
               and not dist.is_initialized())
    if started:
        init_from_env(device)
    try:
        n = cfg.tpu.mesh_data * cfg.tpu.mesh_model
        if dist.is_initialized() and dist.get_world_size() != n:
            raise ValueError(
                f"{dist.get_world_size()} ranks train a mesh of "
                f"tpu.mesh_data x tpu.mesh_model = {n}: set them to the "
                "world size")
        yield
    finally:
        if started:
            dist.destroy_process_group()


def main(argv):
    """Train; returns (state, the last validation's mAP dict or None)."""
    from canonicalvoting_tpu_torch.config import load_config, parse_cli
    from canonicalvoting_tpu_torch.train.joint_loop import run_joint_training

    flags, workdir, rest = split_args(argv)
    device = "cpu" if "--cpu" in flags else "cuda"
    yaml_path, overrides, _ = parse_cli(rest)
    cfg = load_config(yaml_path, overrides)
    with training_group(cfg, device):
        if "--synthetic" in flags:
            train_ds, val_ds, gt_lookup = build_synthetic(cfg)
            return run_joint_training(
                cfg, train_ds, val_ds,
                workdir=workdir or "outputs/synthetic_joint",
                gt_lookup=gt_lookup, eval_every=max(1, min(10, cfg.max_epoch)),
                cap_multiple=4096, device=device)
        from canonicalvoting_tpu_torch.data.scannet import (
            ScanNetXYZProbMultiDataset)

        train_ds = ScanNetXYZProbMultiDataset(cfg, training=True,
                                              augment=cfg.augment)
        val_ds = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)
        return run_joint_training(cfg, train_ds, val_ds,
                                  workdir=workdir or f"outputs/{cfg.category}",
                                  device=device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
