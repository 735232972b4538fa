"""Synthetic scenes written as the data trees the evaluators read.

``write_scannet_tree`` lays out ScanNet scans with their Scan2CAD
annotations (the files of upstream ``config/config.yaml:1-9``):

  * ``scans/<id>/<id>_vh_clean_2.ply``: the scene's points in the scan's
    own frame, float32 xyz and uchar rgb, with a face element;
  * ``full_annotations.json``: the scan's ``trs`` (a yaw and a translation
    to the world frame, scale 1) and one aligned model a planted box, with
    the box's class as ``catid_cad``, its centre, yaw and half-extents as
    the model's ``trs``, a unit ``bbox`` at ``center`` 0, and a ``sym``;
  * ``split.txt`` (the scan ids) and ``segments.pkl`` (each model's vertex
    indices: the points inside its box);
  * ``results_gt/<id>.txt``: one ``tx ty tz ry sx sy sz id_cad catid`` line
    a box.

``write_scenenn_tree`` lays out the SceneNN files of ``SceneNNDataset``
(``h5py`` is imported there). The world frame is the scene's own, so the
ground truth holds ``SyntheticScene.gt_corners()``. Used by the port's
tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from canonicalvoting_tpu_torch.data.geometry import (
    IDX2NAME, make_M_from_tqs, rotmat_y)
from canonicalvoting_tpu_torch.data.synthetic import SyntheticScene

# the wnid of class 0: a ShapeNet category outside the top 8 (file cabinet)
OTHERS_WNID = "03337140"
SYMS = ("__SYM_NONE", "__SYM_ROTATE_UP_2", "__SYM_ROTATE_UP_4",
        "__SYM_ROTATE_UP_INF")


def yaw_quaternion(yaw: float) -> List[float]:
    """(w, x, y, z) of ``rotmat_y(yaw)``, whose rotation about +y is -yaw."""
    return [float(np.cos(-yaw / 2)), 0.0, float(np.sin(-yaw / 2)), 0.0]


def wnid_of(class_idx: int) -> str:
    return OTHERS_WNID if class_idx == 0 else IDX2NAME[class_idx]


def scan_trs(i: int) -> Dict:
    """The scan-to-world ``trs`` of the i-th scan: a yaw and a shift."""
    return {"translation": [0.25 * (i + 1), -0.1, 0.4 - 0.3 * i],
            "rotation": yaw_quaternion(0.35 + 0.5 * i),
            "scale": [1.0, 1.0, 1.0]}


def _to_scan_frame(points: np.ndarray, trs: Dict) -> np.ndarray:
    M = make_M_from_tqs(trs["translation"], trs["rotation"], trs["scale"])
    hom = np.concatenate([points.astype(np.float64),
                          np.ones((len(points), 1))], -1)
    return (np.linalg.inv(M) @ hom.T).T[:, :3].astype(np.float32)


def rgb_u8(rgb: np.ndarray) -> np.ndarray:
    return np.round(np.asarray(rgb) * 255.0).astype(np.uint8)


def write_ply(path: str, pts: np.ndarray, rgb: np.ndarray,
              faces: Sequence[Sequence[int]], binary: bool = True,
              face_first: bool = False) -> None:
    """A ``_vh_clean_2.ply``-layout mesh: float xyz, uchar rgb and alpha,
    and a ``list uchar int vertex_indices`` face element, after the
    vertices or before them."""
    n, m = len(pts), len(faces)
    vertex_hdr = (f"element vertex {n}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "property uchar red\nproperty uchar green\n"
                  "property uchar blue\nproperty uchar alpha\n")
    face_hdr = f"element face {m}\nproperty list uchar int vertex_indices\n"
    fmt = "binary_little_endian" if binary else "ascii"
    header = (f"ply\nformat {fmt} 1.0\n"
              + (face_hdr + vertex_hdr if face_first else vertex_hdr + face_hdr)
              + "end_header\n")
    if binary:
        vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                        ("alpha", "u1")])
        v = np.zeros(n, vdt)
        v["x"], v["y"], v["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        v["red"], v["green"], v["blue"] = rgb.T
        v["alpha"] = 255
        vbytes = v.tobytes()
        fbytes = b"".join(np.uint8(len(f)).tobytes()
                          + np.asarray(f, "<i4").tobytes() for f in faces)
    else:
        vbytes = "".join(
            f"{repr(float(p[0]))} {repr(float(p[1]))} {repr(float(p[2]))} "
            f"{c[0]} {c[1]} {c[2]} 255\n" for p, c in zip(pts, rgb)).encode()
        fbytes = "".join(" ".join(str(x) for x in [len(f), *f]) + "\n"
                         for f in faces).encode()
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(fbytes if face_first else vbytes)
        fh.write(vbytes if face_first else fbytes)


def box_points(scene: SyntheticScene, box) -> np.ndarray:
    """Indices of the scene's points inside ``box`` (its segment), by
    make_scene's own test."""
    inv = ((scene.points - box.center) @ rotmat_y(box.yaw)) / box.scale
    return np.nonzero(np.all(np.abs(inv) < 1.0, axis=-1))[0]


def _faces(n: int) -> List[List[int]]:
    return [[i, i + 1, i + 2] for i in range(0, min(n - 2, 300), 3)]


def _gt_lines(scene: SyntheticScene) -> str:
    lines = []
    for j, b in enumerate(scene.boxes):
        nums = [*b.center, b.yaw, *b.scale]
        lines.append(" ".join(repr(float(v)) for v in nums)
                     + f" {j:04d} {wnid_of(b.class_idx)}")
    return "\n".join(lines) + "\n"


def write_scannet_tree(root: str, scenes: Sequence[SyntheticScene],
                       ids: Sequence[str] = None) -> List[str]:
    """Write ``scenes`` under ``root``; the ``data.*`` overrides that point
    the config at them (training and validation share the split)."""
    ids = list(ids or [f"scene{i:04d}_00" for i in range(len(scenes))])
    annotations, segments = [], {}
    os.makedirs(os.path.join(root, "results_gt"), exist_ok=True)
    for i, (id_scan, scene) in enumerate(zip(ids, scenes)):
        trs = scan_trs(i)
        scandir = os.path.join(root, "scans", id_scan)
        os.makedirs(scandir, exist_ok=True)
        write_ply(os.path.join(scandir, f"{id_scan}_vh_clean_2.ply"),
                  _to_scan_frame(scene.points, trs), rgb_u8(scene.rgb),
                  _faces(len(scene.points)))
        models, segs = [], []
        for j, b in enumerate(scene.boxes):
            models.append({
                "catid_cad": wnid_of(b.class_idx), "id_cad": f"{j:04d}",
                "sym": SYMS[j % len(SYMS)],
                "trs": {"translation": [float(v) for v in b.center],
                        "rotation": yaw_quaternion(b.yaw),
                        "scale": [float(v) for v in b.scale]},
                "center": [0.0, 0.0, 0.0], "bbox": [1.0, 1.0, 1.0]})
            segs.append(box_points(scene, b).tolist())
        annotations.append({"id_scan": id_scan, "trs": trs,
                            "aligned_models": models})
        segments[id_scan] = segs
        with open(os.path.join(root, "results_gt", f"{id_scan}.txt"), "w") as f:
            f.write(_gt_lines(scene))
    with open(os.path.join(root, "full_annotations.json"), "w") as f:
        json.dump(annotations, f)
    with open(os.path.join(root, "split.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, "segments.pkl"), "wb") as f:
        pickle.dump(segments, f)
    paths = {"scan2cad": "full_annotations.json", "scannet": "",
             "train_split": "split.txt", "val_split": "split.txt",
             "train_segments": "segments.pkl", "val_segments": "segments.pkl",
             "gt_path": "results_gt"}
    return [f"data.{k}={os.path.join(root, v)}" for k, v in paths.items()]


def write_scenenn_tree(root: str, scenes: Sequence[SyntheticScene],
                       ids: Sequence[str] = ("011", "021")) -> List[str]:
    """Write ``scenes`` as SceneNN scans under ``root`` (ids from
    ``SceneNNDataset.test_list``), with SceneNN's own class names in the
    ground truth ("desk", "television" among them); the ``data.*``
    override that points the config at them."""
    import h5py

    names = {0: "cabinet", 1: "television", 2: "desk", 3: "bathtub",
             4: "trashbin", 5: "sofa", 6: "chair", 7: "cabinet",
             8: "bookshelf"}
    os.makedirs(os.path.join(root, "scenenn_seg"), exist_ok=True)
    os.makedirs(os.path.join(root, "results_gt"), exist_ok=True)
    annotations = []
    for i, (id_scan, scene) in enumerate(zip(ids, scenes)):
        trs = scan_trs(i)
        p = _to_scan_frame(scene.points, trs)
        # SceneNN axes: the reader swaps y and z and negates the new y
        stored = np.stack([p[:, 0], p[:, 2], -p[:, 1]], -1)
        rgb = np.asarray(scene.rgb, np.float32)
        data = np.concatenate([np.zeros_like(stored), rgb, stored], -1)
        with h5py.File(os.path.join(root, "scenenn_seg",
                                    f"scenenn_seg_{id_scan}.hdf5"), "w") as f:
            f["data"] = data[None].astype(np.float32)
        annotations.append({"id_scan": id_scan, "trs": trs,
                            "aligned_models": []})
        with open(os.path.join(root, "results_gt", f"{id_scan}.txt"), "w") as f:
            f.write("".join(
                " ".join(repr(float(v)) for v in [*b.center, b.yaw, *b.scale])
                + f" {names[b.class_idx]}\n" for b in scene.boxes))
    with open(os.path.join(root, "full_annotations.json"), "w") as f:
        json.dump(annotations, f)
    return [f"data.scene_nn_root={root}"]
