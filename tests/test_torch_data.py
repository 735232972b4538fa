"""The port's host data modules against the JAX package's, on the CPU: the
PLY reader, the Scan2CAD geometry, the ScanNet / SceneNN datasets, the
ground-truth parser, the 2D IoU and the config keys they read. Both sides
are NumPy, so every array must be equal bit for bit, with its dtype."""

import dataclasses
import json
import os

import numpy as np
import pytest

import canonicalvoting_tpu.config as jcfg
import canonicalvoting_tpu.data.geometry as jgeo
from canonicalvoting_tpu.data import scannet as jscannet
from canonicalvoting_tpu.data.ply import read_ply_vertices as j_read_ply
from canonicalvoting_tpu.eval import gt as jgt
from canonicalvoting_tpu.metrics.iou import get_iou_obb2d as j_iou2d
from canonicalvoting_tpu.train.losses import SYM_CODES as J_SYM_CODES

import canonicalvoting_tpu_torch.config as pcfg
import canonicalvoting_tpu_torch.data.geometry as pgeo
from canonicalvoting_tpu_torch.data import scannet as pscannet
from canonicalvoting_tpu_torch.data.ply import read_ply_vertices
from canonicalvoting_tpu_torch.data.synthetic import make_scene
from canonicalvoting_tpu_torch.data.synthetic_tree import (
    write_ply, write_scannet_tree, write_scenenn_tree)
from canonicalvoting_tpu_torch.eval import gt as pgt
from canonicalvoting_tpu_torch.metrics.iou import get_iou_obb2d


def assert_same(a, b):
    """Equal values of equal types: arrays bit for bit, with their dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b, (a, b)


# ---------------------------------------------------------------------------
# PLY

@pytest.mark.parametrize("binary,face_first", [(True, False), (True, True),
                                               (False, False)])
def test_read_ply_matches_jax(tmp_path, binary, face_first):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    rgb = rng.randint(0, 256, (300, 3)).astype(np.uint8)
    faces = [[i, i + 1, i + 2, i + 3][: 3 + i % 2] for i in range(0, 90, 3)]
    path = str(tmp_path / "scene_vh_clean_2.ply")
    write_ply(path, pts, rgb, faces, binary=binary, face_first=face_first)
    got, want = read_ply_vertices(path), j_read_ply(path)
    assert_same(got, want)
    assert np.array_equal(np.stack([got["x"], got["y"], got["z"]], -1), pts)
    assert np.array_equal(
        np.stack([got["red"], got["green"], got["blue"]], -1), rgb)


# ---------------------------------------------------------------------------
# geometry

def _quats(rng):
    q = list(rng.randn(6, 4)) + [np.zeros(4), np.array([1e-8, 0, 0, 0])]
    return [list(map(float, x)) for x in q]


def _models(rng):
    return [{"trs": {"translation": list(rng.randn(3)),
                     "rotation": list(rng.randn(4)),
                     "scale": list(rng.uniform(0.2, 2, 3))},
             "center": list(rng.randn(3) * 0.1),
             "bbox": list(rng.uniform(0.1, 1, 3))} for _ in range(5)]


GEOMETRY_CASES = {
    "quat_to_rotmat": lambda g, rng: [g.quat_to_rotmat(q) for q in _quats(rng)],
    "make_M_from_tqs": lambda g, rng: [
        g.make_M_from_tqs(rng.randn(3), q, rng.uniform(0.5, 2, 3))
        for q in _quats(rng)],
    "calc_Mbbox": lambda g, rng: [g.calc_Mbbox(m) for m in _models(rng)],
    "calc_Mbbox_no_rot": lambda g, rng: [
        g.calc_Mbbox_no_rot(m) for m in _models(rng)],
    "apply_trans": lambda g, rng: [g.apply_trans(
        rng.randn(50, 3).astype(np.float32),
        g.make_M_from_tqs(rng.randn(3), rng.randn(4), [1.0, 1.0, 1.0]))],
    "roty": lambda g, rng: [g.roty(a) for a in rng.uniform(-7, 7, 5)],
    "symmetry_matrices": lambda g, rng: [
        g.symmetry_matrices(g.calc_Mbbox(_models(rng)[0]), s)
        for s in list(g.SYMMETRY_ANGLES) + ["__SYM_UNKNOWN"]],
    "num_symmetry_hypotheses": lambda g, rng: [
        g.num_symmetry_hypotheses(s)
        for s in list(g.SYMMETRY_ANGLES) + ["__SYM_UNKNOWN"]],
    "top8_mapping": lambda g, rng: [
        (dict(m), m["03001627"], m["03337140"], m["others"])
        for m in [g.get_top8_classes_mapping()]],
    "constants": lambda g, rng: [g.IDX2NAME, g.NAME2CATNAME, g.NCLASSES,
                                 g.SYMMETRY_ANGLES],
    "rotmat_y_unit_box": lambda g, rng: [g.rotmat_y(0.7), g.unit_box_corners()],
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(name):
    case = GEOMETRY_CASES[name]
    assert_same(case(pgeo, np.random.RandomState(3)),
                case(jgeo, np.random.RandomState(3)))


def test_sym_codes_match_jax_losses():
    assert pgeo.SYM_CODES == J_SYM_CODES


# ---------------------------------------------------------------------------
# config

CONFIG_OVERRIDES = [
    "data.scan2cad=/a/full_annotations.json", "data.scannet=/b",
    "+data.gt_path=/c/results_gt", "data.scene_nn_root=/d",
    "data.train_split=/e.txt", "data.val_split=/f.txt",
    "data.train_segments=/g.pkl", "data.val_segments=/h.pkl",
    "scannet_res=0.05", "use_xyz=true", "log_scale=0", "category=03001627",
    "augment=false", "augment_color=1", "tpu.max_boxes=32",
    "tpu.conv_dtype=float32", "not_an_override"]


def test_config_matches_jax():
    got = pcfg.load_config(None, CONFIG_OVERRIDES)
    want = jcfg.load_config(None, CONFIG_OVERRIDES)
    assert_same(dataclasses.asdict(got.data), dataclasses.asdict(want.data))
    for k in ("scannet_res", "log_scale", "use_xyz", "category", "augment",
              "augment_color", "in_channels"):
        assert_same(getattr(got, k), getattr(want, k))
    for k in ("max_boxes", "conv_dtype"):
        assert_same(getattr(got.tpu, k), getattr(want.tpu, k))
    assert_same(dataclasses.asdict(pcfg.Config().data),
                dataclasses.asdict(jcfg.Config().data))
    argv = ["--config=a.yaml", "category=a,b,c", "-m", "scannet_res=0.1"]
    assert pcfg.parse_cli(argv) == jcfg.parse_cli(argv)
    assert pcfg.parse_cli(argv[:2]) == jcfg.parse_cli(argv[:2])


# ---------------------------------------------------------------------------
# ScanNet / Scan2CAD datasets

@pytest.fixture(scope="module")
def scannet_tree(tmp_path_factory):
    """Four scans: 0 as written (others, display, table); 1 in ascii PLY
    with its table's scale under 1e-3; 2 with a face-first PLY and its
    table alone; 3 with no aligned model (the fallback draw)."""
    root = str(tmp_path_factory.mktemp("scannet"))
    rng = np.random.RandomState(0)
    scenes = [make_scene(rng, extent=(1.0, 0.7, 1.0), n_background=300,
                         n_boxes=3, pts_per_box=100, scale_range=(0.1, 0.2))
              for _ in range(4)]
    overrides = write_scannet_tree(root, scenes)
    with open(os.path.join(root, "full_annotations.json")) as f:
        ann = json.load(f)
    ann[1]["aligned_models"][2]["trs"]["scale"][0] = 1e-4
    ann[2]["aligned_models"] = ann[2]["aligned_models"][2:]
    ann[3]["aligned_models"] = []
    with open(os.path.join(root, "full_annotations.json"), "w") as f:
        json.dump(ann, f)
    import pickle

    with open(os.path.join(root, "segments.pkl"), "rb") as f:
        seg = pickle.load(f)
    seg["scene0002_00"] = seg["scene0002_00"][2:]
    with open(os.path.join(root, "segments.pkl"), "wb") as f:
        pickle.dump(seg, f)
    for i, kw in ((1, dict(binary=False)), (2, dict(face_first=True))):
        path = os.path.join(root, "scans", f"scene000{i}_00",
                            f"scene000{i}_00_vh_clean_2.ply")
        v = read_ply_vertices(path)
        write_ply(path, np.stack([v["x"], v["y"], v["z"]], -1),
                  np.stack([v["red"], v["green"], v["blue"]], -1),
                  [[0, 1, 2], [3, 4, 5, 6]], **kw)
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("scene0000_00\nscene0001_00\nscene0003_00\n")
    return overrides + [f"data.val_split={root}/val.txt"]


@pytest.mark.parametrize("use_xyz", [False, True])
@pytest.mark.parametrize("category", ["all", "03211117", "others"])
@pytest.mark.parametrize("mode", ["eval", "train_augment"])
@pytest.mark.parametrize("kind", ["ScanNetXYZProbMultiDataset",
                                  "ScanNetXYZProbSymDataset"])
def test_scannet_dataset_matches_jax(scannet_tree, kind, mode, category,
                                     use_xyz):
    training = mode != "eval"
    sets = []
    for cfg_mod, ds_mod in ((pcfg, pscannet), (jcfg, jscannet)):
        cfg = cfg_mod.load_config(None, scannet_tree + [
            f"category={category}", f"use_xyz={use_xyz}",
            f"augment_color={training}"])
        ds = getattr(ds_mod, kind)(cfg, training=training, augment=training)
        if training:
            ds.rng = np.random.RandomState(7)
        sets.append(ds)
    got, want = sets
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        assert_same(got[i], want[i])
    # the items' segments were written into the annotations, as in JAX
    assert got.annotations == want.annotations
    assert got.rng.randint(1 << 30) == want.rng.randint(1 << 30)


# ---------------------------------------------------------------------------
# SceneNN

@pytest.mark.parametrize("use_xyz,augment", [(False, False), (True, True)])
def test_scenenn_dataset_matches_jax(tmp_path, use_xyz, augment):
    pytest.importorskip("h5py")
    rng = np.random.RandomState(2)
    scenes = [make_scene(rng, extent=(1.0, 0.7, 1.0), n_background=300,
                         n_boxes=2, pts_per_box=100) for _ in range(3)]
    # repeated points: the reader keeps the first of each
    s = scenes[0]
    scenes[0] = dataclasses.replace(
        s, points=np.concatenate([s.points, s.points[:40]]),
        rgb=np.concatenate([s.rgb, s.rgb[::-1][:40]]))
    # "999" is in neither of SceneNN's lists
    overrides = write_scenenn_tree(str(tmp_path), scenes,
                                   ids=("011", "005", "999"))
    overrides.append(f"use_xyz={use_xyz}")
    got = pscannet.SceneNNDataset(pcfg.load_config(None, overrides),
                                  training=False, augment=augment)
    want = jscannet.SceneNNDataset(jcfg.load_config(None, overrides),
                                   training=False, augment=augment)
    assert len(got) == len(want) == 2
    for i in range(len(got)):
        assert_same(got[i], want[i])


# ---------------------------------------------------------------------------
# ground truth and the 2D IoU

GT_LINES = {
    "scene0000_00": [
        "0.5 0.25 1.5 0.3 0.4 0.5 0.6 0001 03001627",
        "1.25 0.5 -0.75 -2.1 0.2 0.3 0.25 extra 0002 03337140",
        "2 1 0 3.14159 1 1 1 04379243"],
    "011": ["0.5 0.4 0.3 1.1 0.3 0.4 0.5 desk",
            "1 1 1 0 0.2 0.2 0.2 television",
            "0 0 0 -0.5 0.3 0.3 0.3 chair"],
}


@pytest.mark.parametrize("id_scan,map_catname,scenenn", [
    ("scene0000_00", True, False), ("scene0000_00", False, False),
    ("011", True, True)])
def test_gt_matches_jax(tmp_path, id_scan, map_catname, scenenn):
    with open(tmp_path / f"{id_scan}.txt", "w") as f:
        f.write("\n".join(GT_LINES[id_scan]) + "\n")
    got = pgt.load_gt_scene(str(tmp_path), id_scan, map_catname=map_catname,
                            scenenn=scenenn)
    want = jgt.load_gt_scene(str(tmp_path), id_scan, map_catname=map_catname,
                             scenenn=scenenn)
    assert_same(got, want)
    if scenenn:
        assert [c for c, _ in got] == ["table", "display", "chair"]
    for line in GT_LINES[id_scan]:
        assert_same(pgt.parse_gt_line(line, map_catname),
                    jgt.parse_gt_line(line, map_catname))


def test_iou_obb2d_matches_jax():
    rng = np.random.RandomState(4)
    boxes = []
    for _ in range(12):
        line = " ".join(str(v) for v in [*rng.uniform(-0.5, 0.5, 3),
                                         rng.uniform(-3, 3),
                                         *rng.uniform(0.1, 0.6, 3)]) + " x"
        boxes.append(pgt.parse_gt_line(line)[1])
    boxes.append(boxes[0][[4, 5, 6, 7, 0, 1, 2, 3]])  # upside down: IoU 0
    ious = [(get_iou_obb2d(a, b), j_iou2d(a, b)) for a in boxes for b in boxes]
    for got, want in ious:
        assert_same(float(got), float(want))
    assert any(0 < g < 1 for g, _ in ious) and ious[-1][0] == 0.0
