"""ScanNet / Scan2CAD / SceneNN datasets (host-side NumPy).

The port's copy of ``canonicalvoting_tpu/data/scannet.py`` (upstream
``utils/dataloader.py:89-477``); with the same files, config and ``rng``
state both give the same arrays:

  * ScanNetXYZProbMultiDataset: the joint model's items and labels,
    per-point LCC, scale diag, class in [0..8] with 9 = background
    (:89-210);
  * ScanNetXYZProbSymDataset: per-category labels, the base LCC, a
    per-point object id and a per-object symmetry code (:339-477);
  * SceneNNDataset: transfer-evaluation scans from hdf5 (:213-336),
    inference fields only, as upstream uses them (eval_joint.py:163).
    ``h5py`` is imported when an item is read.

Augmentation as upstream: per-channel brightness / shift / jitter on RGB
(:157-161) and a yaw of k * 90 deg +- 20 deg (:163-167), drawn from
``self.rng`` in that order.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List

import numpy as np

from canonicalvoting_tpu_torch.data.geometry import (
    NCLASSES,
    SYM_CODES,
    apply_trans,
    calc_Mbbox,
    get_top8_classes_mapping,
    make_M_from_tqs,
)
from canonicalvoting_tpu_torch.data.ply import read_ply_vertices
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize


def _augment_rgb(rng, scan_rgb, n_points):
    scan_rgb = scan_rgb * (1 + 0.4 * rng.random(3) - 0.2)
    scan_rgb = scan_rgb + (0.1 * rng.random(3) - 0.05)
    scan_rgb = scan_rgb + (0.05 * rng.random(n_points) - 0.025)[:, None]
    return np.clip(scan_rgb, 0, 1)


def _augment_rotation(rng):
    rot_angle = rng.randint(4) * np.pi / 2.0 + (rng.random() - 0.5) * 2.0 * np.pi / 9.0
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _scan_matrix(annotation) -> np.ndarray:
    """The scan-to-world transform of a Scan2CAD annotation, whose scale
    must be 1."""
    trs = annotation["trs"]
    if not np.all(np.abs(np.array(trs["scale"]) - 1.0) < 1e-7):
        raise ValueError(f"{annotation['id_scan']}: scan scale {trs['scale']} "
                         "is not 1")
    return make_M_from_tqs(trs["translation"], trs["rotation"], trs["scale"])


class _ScanNetBase:
    def __init__(self, cfg, training: bool, augment: bool):
        self.cfg = cfg
        with open(cfg.data.scan2cad) as f:
            annotations = json.load(f)
        split = cfg.data.train_split if training else cfg.data.val_split
        with open(split) as f:
            valid_ids = set(f.read().splitlines())
        annotations = [a for a in annotations if a["id_scan"] in valid_ids]
        seg_path = cfg.data.train_segments if training else cfg.data.val_segments
        with open(seg_path, "rb") as f:
            self.segments = pickle.load(f)
        self.catid2idx = get_top8_classes_mapping()
        self.annotations = self._filter_by_category(annotations)
        self.training = training
        self.augment = augment
        self.rng = np.random.RandomState(0 if not training else None)

    def _filter_by_category(self, annotations):
        cat = self.cfg.category
        if cat == "all":
            return annotations
        if cat == "others":
            return [
                a for a in annotations
                if any(self.catid2idx[m["catid_cad"]] == 0
                       for m in a["aligned_models"])
            ]
        return [
            a for a in annotations
            if any(m["catid_cad"] == cat for m in a["aligned_models"])
        ]

    def _valid_models(self, annotation):
        cat = self.cfg.category
        models = annotation["aligned_models"]
        if cat == "all":
            return models
        if cat == "others":
            return [m for m in models if self.catid2idx[m["catid_cad"]] == 0]
        return [m for m in models if m["catid_cad"] == cat]

    def _load_scan(self, annotation):
        id_scan = annotation["id_scan"]
        scan_file = os.path.join(
            self.cfg.data.scannet, "scans", id_scan, id_scan + "_vh_clean_2.ply"
        )
        Mscan = _scan_matrix(annotation)
        v = read_ply_vertices(scan_file)
        pcd = np.stack([v["x"], v["y"], v["z"]], -1)
        rgb = np.stack([v["red"], v["green"], v["blue"]], -1)
        scan_points = apply_trans(pcd, Mscan)
        return id_scan, scan_points, rgb

    def __len__(self):
        return len(self.annotations)


class ScanNetXYZProbMultiDataset(_ScanNetBase):
    """Joint-model dataset (upstream utils/dataloader.py:89-210)."""

    def __getitem__(self, index):
        annotation = self.annotations[index]
        segments = self.segments[annotation["id_scan"]]
        id_scan, scan_points, rgb = self._load_scan(annotation)
        scan_rgb = (rgb / 255.0).astype(np.float32)

        models = annotation["aligned_models"]
        for i in range(len(models)):
            models[i]["segments"] = segments[i]
        valid_models = self._valid_models(annotation)
        if len(valid_models) == 0:
            return self[self.rng.randint(len(self))]

        augment_mat = np.eye(4)
        if self.augment:
            if self.cfg.augment_color:
                scan_rgb = _augment_rgb(self.rng, scan_rgb, len(scan_points))
            rot = _augment_rotation(self.rng)
            scan_points = scan_points @ rot.T
            augment_mat[:3, :3] = rot @ augment_mat[:3, :3]

        scan_points = scan_points.astype(np.float32)
        xyz_labels = np.zeros_like(scan_points, dtype=np.float32)
        scale_labels = np.zeros_like(scan_points, dtype=np.float32)
        class_labels = np.full((len(scan_points),), NCLASSES, np.int32)

        for model in valid_models:
            if np.min(np.asarray(model["trs"]["scale"], np.float32)) < 1e-3:
                continue  # singular label (:176)
            unit2scan = np.diag(np.asarray(model["trs"]["scale"], np.float32)) \
                @ np.diag(np.asarray(model["bbox"], np.float32))
            Mbbox = calc_Mbbox(model)
            if self.augment:
                Mbbox = augment_mat @ Mbbox
            seg = model["segments"]
            xyz_labels[seg] = apply_trans(scan_points[seg], np.linalg.inv(Mbbox))
            scale_labels[seg] = np.diag(unit2scan)
            class_labels[seg] = self.catid2idx[model["catid_cad"]]

        feats = (
            np.concatenate([scan_points, scan_rgb], -1)
            if self.cfg.use_xyz else scan_rgb
        )
        coords, idx = sparse_quantize(scan_points, self.cfg.scannet_res)
        return (
            id_scan,
            coords,
            feats[idx].astype(np.float32),
            xyz_labels[idx],
            scale_labels[idx],
            class_labels[idx],
        )


class ScanNetXYZProbSymDataset(_ScanNetBase):
    """Per-category symmetry-aware dataset (upstream
    utils/dataloader.py:339-477): base LCC, per-point object ids and
    per-object symmetry codes for the vectorized loss."""

    def __getitem__(self, index):
        annotation = self.annotations[index]
        segments = self.segments[annotation["id_scan"]]
        id_scan, scan_points, rgb = self._load_scan(annotation)

        models = annotation["aligned_models"]
        for i in range(len(models)):
            models[i]["segments"] = segments[i]
        valid_models = self._valid_models(annotation)
        if len(valid_models) == 0:
            return self[self.rng.randint(len(self))]

        augment_mat = np.eye(4)
        scan_rgb_raw = rgb.astype(np.float64)
        if self.augment:
            if self.cfg.augment_color:
                scan_rgb_raw = _augment_rgb(self.rng, scan_rgb_raw, len(scan_points))
            rot = _augment_rotation(self.rng)
            scan_points = scan_points @ rot.T
            augment_mat[:3, :3] = rot @ augment_mat[:3, :3]

        scan_points = scan_points.astype(np.float32)
        coords, idx = sparse_quantize(scan_points, self.cfg.scannet_res)
        scan_points = scan_points[idx]
        scan_rgb = (scan_rgb_raw[idx] / 255.0).astype(np.float32)
        idx_mapping = {int(j): i for i, j in enumerate(idx)}

        n = len(scan_points)
        base_xyz = np.zeros((n, 3), np.float32)
        scale_labels = np.zeros((n, 3), np.float32)
        obj_labels = np.zeros((n,), np.int32)
        class_labels = np.zeros((n,), np.int32)
        obj_id = np.full((n,), -1, np.int32)
        sym_codes: List[int] = []

        for model in valid_models:
            if np.min(np.asarray(model["trs"]["scale"], np.float32)) < 1e-3:
                continue
            unit2scan = np.diag(np.asarray(model["trs"]["scale"], np.float32)) \
                @ np.diag(np.asarray(model["bbox"], np.float32))
            Mbbox = calc_Mbbox(model)
            if self.augment:
                Mbbox = augment_mat @ Mbbox
            seg = np.array(
                [idx_mapping[i] for i in model["segments"] if i in idx_mapping],
                np.int64,
            )
            if len(seg) == 0:
                continue
            oid = len(sym_codes)
            sym_codes.append(SYM_CODES.get(model.get("sym", "__SYM_NONE"), 0))
            base_xyz[seg] = apply_trans(scan_points[seg], np.linalg.inv(Mbbox))
            scale_labels[seg] = np.diag(unit2scan)
            obj_labels[seg] = 1
            class_labels[seg] = self.catid2idx[model["catid_cad"]]
            obj_id[seg] = oid

        feats = (
            np.concatenate([scan_points, scan_rgb], -1)
            if self.cfg.use_xyz else scan_rgb
        )
        return (
            id_scan, coords, feats.astype(np.float32), base_xyz, scale_labels,
            obj_labels, class_labels, obj_id, np.array(sym_codes, np.int32),
        )


class SceneNNDataset:
    """SceneNN transfer-evaluation dataset (upstream
    utils/dataloader.py:213-336): inference fields, with zero labels
    (upstream's label path is dead code, and evaluation discards labels).
    """

    train_list = [
        "005", "014", "015", "016", "025", "036", "038", "041", "045", "047",
        "052", "054", "057", "061", "062", "066", "071", "073", "078", "080",
        "084", "087", "089", "096", "098", "109", "201", "202", "209", "217",
        "223", "225", "227", "231", "234", "237", "240", "243", "249", "251",
        "255", "260", "263", "265", "270", "276", "279", "286", "294", "308",
        "522", "609", "613", "614", "623", "700",
    ]
    test_list = [
        "011", "021", "065", "032", "093", "246", "086", "069", "206", "252",
        "273", "527", "621", "076", "082", "049", "207", "213", "272", "074",
    ]

    def __init__(self, cfg, training: bool, augment: bool):
        self.cfg = cfg
        self.training = training
        self.augment = augment
        root = cfg.data.scene_nn_root
        with open(os.path.join(root, "full_annotations.json")) as f:
            annotations = json.load(f)
        valid_ids = set(self.train_list + self.test_list)
        self.annotations = [a for a in annotations if a["id_scan"] in valid_ids]
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, index):
        try:
            import h5py
        except ImportError as e:
            raise ImportError("SceneNN scans are hdf5 files: reading them "
                              "needs h5py, which is not installed") from e

        annotation = self.annotations[index]
        id_scan = annotation["id_scan"]
        Mscan = _scan_matrix(annotation)
        path = os.path.join(
            self.cfg.data.scene_nn_root, "scenenn_seg",
            f"scenenn_seg_{id_scan}.hdf5",
        )
        with h5py.File(path, "r") as f:
            data = f["data"][:]
        pcd = data[:, :, -3:].reshape(-1, 3)
        rgb = data[:, :, -6:-3].reshape(-1, 3)
        # SceneNN -> ScanNet coordinates (:262-263)
        pcd = pcd[:, [0, 2, 1]]
        pcd[:, 1] = -pcd[:, 1]
        _, indices = np.unique(pcd, axis=0, return_index=True)
        pcd = pcd[indices].astype(np.float32)
        scan_rgb = rgb[indices].astype(np.float32)
        scan_points = apply_trans(pcd, Mscan).astype(np.float32)

        if self.augment:
            rot = _augment_rotation(self.rng)
            scan_points = (scan_points @ rot.T).astype(np.float32)

        coords, idx = sparse_quantize(scan_points, self.cfg.scannet_res)
        scan_points = scan_points[idx]
        scan_rgb = scan_rgb[idx]
        feats = (
            np.concatenate([scan_points, scan_rgb], -1)
            if self.cfg.use_xyz else scan_rgb
        )
        n = len(scan_points)
        zeros3 = np.zeros((n, 3), np.float32)
        return (
            id_scan, coords, feats.astype(np.float32), zeros3,
            zeros3.copy(), np.zeros((n,), np.int32),
        )
