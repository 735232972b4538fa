"""Per-category training CLI of the port (the JAX package's
train_separate.py).

Usage:
  python -m canonicalvoting_tpu_torch.train_separate category=03001627 [key=value ...]
  python -m canonicalvoting_tpu_torch.train_separate category=a,b,c -m   # one model a category
  python -m canonicalvoting_tpu_torch.train_separate --synthetic         # synthetic run

Overrides, ``--config=<yaml>`` and ``--cpu`` as ``train_joint``; each
category's checkpoints and metrics files (as ``train_joint``'s) go to
``workdir=<dir>/<category>`` (default ``multirun``, ``multirun/synthetic``
with ``--synthetic``). Mesh training runs under torchrun as
``train_joint``'s does (``torchrun --nproc-per-node 2 -m
canonicalvoting_tpu_torch.train_separate category=03001627
tpu.mesh_data=2``), one category after another on the same ranks.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np



def build_synthetic_sym(cfg, n_scenes=6, seed=0):
    """(dataset, ground-truth lookup) of synthetic scenes with object ids and
    symmetry codes: the JAX package's ``train_separate.py --synthetic``
    recipe."""
    from canonicalvoting_tpu_torch.data.geometry import (
        IDX2NAME, NAME2CATNAME, NCLASSES, rotmat_y)
    from canonicalvoting_tpu_torch.data.loader import ListDataset
    from canonicalvoting_tpu_torch.data.synthetic import make_scene
    from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize

    rng = np.random.RandomState(seed)
    items, gts = [], {}
    for i in range(n_scenes):
        scene = make_scene(rng, extent=(2.5, 1.8, 2.5), n_background=4000,
                           n_boxes=2, pts_per_box=600)
        coords, idx = sparse_quantize(scene.points, cfg.scannet_res)
        cls = scene.class_labels[idx]
        obj_lab = (cls < NCLASSES).astype(np.int32)
        pw = coords.astype(np.float32) * cfg.scannet_res
        oid = np.full(len(coords), -1, np.int32)
        for bi, b in enumerate(scene.boxes):
            inv = ((pw - b.center) @ rotmat_y(b.yaw)) / b.scale
            oid[np.all(np.abs(inv) < 1, -1)] = bi
        sym = np.array([(bi % 4) for bi in range(len(scene.boxes))], np.int32)
        items.append((f"s{i}", coords, scene.rgb[idx], scene.xyz_labels[idx],
                      scene.scale_labels[idx], obj_lab, cls, oid, sym))
        gts[f"s{i}"] = [(NAME2CATNAME[IDX2NAME[ci]], c)
                        for ci, c in scene.gt_corners()]
    return ListDataset(items), gts.get


def main(argv):
    """Train each category in turn; returns {category: (state, the last
    validation's mAP dict or None)}."""
    from canonicalvoting_tpu_torch.config import load_config, parse_cli
    from canonicalvoting_tpu_torch.train.separate_loop import run_separate_training
    from canonicalvoting_tpu_torch.train_joint import split_args, training_group

    flags, workdir, rest = split_args(argv)
    device = "cpu" if "--cpu" in flags else "cuda"
    yaml_path, overrides, categories = parse_cli(rest)
    if categories is None:
        categories = [load_config(yaml_path, overrides).category]
    synthetic = "--synthetic" in flags
    root = workdir or ("multirun/synthetic" if synthetic else "multirun")
    out = {}
    with training_group(load_config(yaml_path, overrides), device):
        for category in categories:
            cfg = load_config(yaml_path, overrides)
            cfg.category = category
            if synthetic:
                ds, gt_lookup = build_synthetic_sym(cfg)
                me = min(cfg.max_epoch, 1)
                out[category] = run_separate_training(
                    cfg, ds, ds, workdir=os.path.join(root, category),
                    gt_lookup=gt_lookup, eval_every=max(me, 1), max_epoch=me,
                    device=device)
                continue
            from canonicalvoting_tpu_torch.data.scannet import (
                ScanNetXYZProbSymDataset)

            train_ds = ScanNetXYZProbSymDataset(cfg, training=True,
                                                augment=cfg.augment)
            val_ds = ScanNetXYZProbSymDataset(cfg, training=False,
                                              augment=False)
            out[category] = run_separate_training(
                cfg, train_ds, val_ds, workdir=os.path.join(root, category),
                device=device)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main(sys.argv[1:])
