"""Scan2CAD label geometry (pure NumPy): class maps, annotation transforms
and box conventions.

The port's copy of ``canonicalvoting_tpu/data/geometry.py`` (upstream
``utils/dataloader.py:13-86, 434-454``, ``eval_joint.py:124-134, 178-188,
202-215``), float64 throughout as there: the datasets' labels and voxels
depend on it.
"""

from __future__ import annotations

import numpy as np

# class index -> ShapeNet wnid of the 8 top Scan2CAD categories; 0 = others
IDX2NAME = {
    0: "others",
    1: "03211117",
    2: "04379243",
    3: "02808440",
    4: "02747177",
    5: "04256520",
    6: "03001627",
    7: "02933112",
    8: "02871439",
}

NAME2CATNAME = {
    "03211117": "display",
    "04379243": "table",
    "02808440": "bathtub",
    "02747177": "trashbin",
    "04256520": "sofa",
    "02933112": "cabinet",
    "02871439": "bookshelf",
    "others": "others",
    "03001627": "chair",
}

NCLASSES = 9

#: symmetry class codes of the symmetry-aware loss (JAX ``train/losses.py``)
SYM_CODES = {
    "__SYM_NONE": 0,
    "__SYM_ROTATE_UP_2": 1,
    "__SYM_ROTATE_UP_4": 2,
    "__SYM_ROTATE_UP_INF": 3,
}


def get_top8_classes_mapping():
    """wnid -> class index of the top 8 categories, 0 ("others") for any
    other wnid."""

    class _Top8(dict):
        def __missing__(self, key):
            return 0

    return _Top8({wnid: i for i, wnid in IDX2NAME.items() if i})


def quat_to_rotmat(q) -> np.ndarray:
    """Rotation matrix of the quaternion (w, x, y, z), the convention of
    ``np.quaternion(q[0], q[1], q[2], q[3])`` upstream."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def make_M_from_tqs(t, q, s) -> np.ndarray:
    """T @ R @ S homogeneous transform (upstream utils/dataloader.py:72-82)."""
    T = np.eye(4)
    T[0:3, 3] = t
    R = np.eye(4)
    R[0:3, 0:3] = quat_to_rotmat(q)
    S = np.eye(4)
    S[0:3, 0:3] = np.diag(s)
    return T @ R @ S


def _model_parts(model: dict):
    trs = model["trs"]
    return [np.asarray(v, dtype=np.float64) for v in (
        model["bbox"], model["center"], trs["translation"], trs["rotation"],
        trs["scale"])]


def calc_Mbbox(model: dict) -> np.ndarray:
    """Scan2CAD oriented-bbox-to-world transform
    (upstream utils/dataloader.py:49-69)."""
    bbox, center, trans, rot, scale = _model_parts(model)
    tcenter1 = np.eye(4)
    tcenter1[0:3, 3] = center
    trans1 = np.eye(4)
    trans1[0:3, 3] = trans
    rot1 = np.eye(4)
    rot1[0:3, 0:3] = quat_to_rotmat(rot)
    scale1 = np.eye(4)
    scale1[0:3, 0:3] = np.diag(scale)
    bbox1 = np.eye(4)
    bbox1[0:3, 0:3] = np.diag(bbox)
    return trans1 @ rot1 @ scale1 @ tcenter1 @ bbox1


def calc_Mbbox_no_rot(model: dict) -> np.ndarray:
    """The rotation-free variant (upstream utils/dataloader.py:26-46)."""
    bbox, center, trans, rot, scale = _model_parts(model)
    tcenter1 = np.eye(4)
    tcenter1[0:3, 3] = center
    rot1 = np.eye(4)
    rot1[0:3, 0:3] = quat_to_rotmat(rot)
    trans1 = np.eye(4)
    trans1[0:3, 3] = np.linalg.inv(rot1[0:3, 0:3]) @ trans
    scale1 = np.eye(4)
    scale1[0:3, 0:3] = np.diag(scale)
    bbox1 = np.eye(4)
    bbox1[0:3, 0:3] = np.diag(bbox)
    return trans1 @ scale1 @ tcenter1 @ bbox1


def apply_trans(pc: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """A 4x4 homogeneous transform applied to (N, 3) points
    (upstream utils/dataloader.py:85-86)."""
    return (trans @ np.concatenate([pc, np.ones((pc.shape[0], 1))], -1).T).T[:, :3]


def roty(angle: float) -> np.ndarray:
    """4x4 yaw rotation of the symmetry hypotheses, with upstream's -sin in
    the first row (utils/dataloader.py:434-435)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]]
    )


#: symmetry class -> yaw angles of the extra bbox hypotheses
#: (upstream utils/dataloader.py:444-454)
SYMMETRY_ANGLES = {
    "__SYM_NONE": [],
    "__SYM_ROTATE_UP_2": [np.pi],
    "__SYM_ROTATE_UP_4": [np.pi / 2, np.pi, -np.pi / 2],
    "__SYM_ROTATE_UP_INF": [2 * np.pi / 36 * i for i in range(1, 36)],
}


def symmetry_matrices(Mbbox: np.ndarray, sym: str) -> list:
    """[Mbbox, Mbbox @ roty(a), ...]: every hypothesis of a symmetry class."""
    mats = [Mbbox]
    for a in SYMMETRY_ANGLES.get(sym, []):
        mats.append(Mbbox @ roty(a))
    return mats


def num_symmetry_hypotheses(sym: str) -> int:
    return 1 + len(SYMMETRY_ANGLES.get(sym, []))


def rotmat_y(angle: float) -> np.ndarray:
    """3x3 yaw rotation with the detection pipeline's convention
    (upstream eval_joint.py:215)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def unit_box_corners() -> np.ndarray:
    """(8, 3) corners of the [-1, 1]^3 box shared by box decoding, GT and
    IoU (upstream eval_joint.py:202-203): corners 0-3 are the top face
    (+y), 4-7 the bottom."""
    l = h = w = 2
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    return np.array([x, y, z], dtype=np.float64).T
