"""Scan2CAD label geometry (pure NumPy): class maps and box conventions.

The part of ``canonicalvoting_tpu/data/geometry.py`` the joint inference
path uses (upstream ``eval_joint.py:124-134, 178-188, 202-215``).
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
