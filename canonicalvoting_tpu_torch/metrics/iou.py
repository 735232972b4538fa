"""Oriented-bounding-box IoU (pure NumPy, no shapely).

Replaces the reference's shapely-based IoU (reference:
utils/calc_map.py:6-37 upstream): intersection of the two XZ-plane
quads (corners 0..3) via Sutherland–Hodgman convex clipping, times the
Y-extent overlap. Box corner layout per
reference eval_joint.py:203: corners 0..3 = top face (+y), 4..7 = bottom.
"""

from __future__ import annotations

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Unsigned area of a 2D polygon (shoelace)."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip polygon by the half-plane left of directed edge a->b
    (for a counter-clockwise clipper)."""
    out = []
    n = len(subject)
    if n == 0:
        return np.zeros((0, 2))
    d = b - a
    for i in range(n):
        p, q = subject[i], subject[(i + 1) % n]
        side_p = d[0] * (p[1] - a[1]) - d[1] * (p[0] - a[0])
        side_q = d[0] * (q[1] - a[1]) - d[1] * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
            if side_q < 0:
                t = side_p / (side_p - side_q)
                out.append(p + t * (q - p))
        elif side_q >= 0:
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return np.array(out) if out else np.zeros((0, 2))


def _ccw(poly: np.ndarray) -> np.ndarray:
    """Return polygon with counter-clockwise winding."""
    x, y = poly[:, 0], poly[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return poly if signed >= 0 else poly[::-1]


def convex_intersection_area(p1: np.ndarray, p2: np.ndarray) -> float:
    """Intersection area of two convex 2D polygons."""
    clipper = _ccw(np.asarray(p2, dtype=np.float64))
    poly = _ccw(np.asarray(p1, dtype=np.float64))
    for i in range(len(clipper)):
        poly = _clip(poly, clipper[i], clipper[(i + 1) % len(clipper)])
        if len(poly) == 0:
            return 0.0
    return polygon_area(poly)


def get_iou_obb(bbox1: np.ndarray, bbox2: np.ndarray) -> float:
    """3D oriented-box IoU (reference utils/calc_map.py:6-21).

    bbox: (8, 3) corners; corners 0..3 top face in XZ, corner 4 has the
    bottom y. Returns 0 when either box is degenerate (top not above bottom),
    matching the reference's early-out (:13).
    """
    bbox1 = np.asarray(bbox1, dtype=np.float64)
    bbox2 = np.asarray(bbox2, dtype=np.float64)
    if not (bbox1[0, 1] > bbox1[4, 1] and bbox2[0, 1] > bbox2[4, 1]):
        return 0.0
    poly1 = np.stack([bbox1[:4, 0], bbox1[:4, 2]], -1)
    poly2 = np.stack([bbox2[:4, 0], bbox2[:4, 2]], -1)
    inter_area = convex_intersection_area(poly1, poly2)
    y_overlap = max(
        0.0, min(bbox1[0, 1], bbox2[0, 1]) - max(bbox1[4, 1], bbox2[4, 1])
    )
    inter_vol = inter_area * y_overlap
    a1 = polygon_area(poly1)
    a2 = polygon_area(poly2)
    vol1 = a1 * (bbox1[0, 1] - bbox1[4, 1])
    vol2 = a2 * (bbox2[0, 1] - bbox2[4, 1])
    denom = vol1 + vol2 - inter_vol
    if denom <= 0:
        return 0.0
    return inter_vol / denom


def get_iou_obb2d(bbox1: np.ndarray, bbox2: np.ndarray) -> float:
    """The XZ-plane IoU of two boxes' top faces (upstream
    utils/calc_map.py:24-37), 0 for a degenerate box as ``get_iou_obb``."""
    bbox1 = np.asarray(bbox1, dtype=np.float64)
    bbox2 = np.asarray(bbox2, dtype=np.float64)
    if not (bbox1[0, 1] > bbox1[4, 1] and bbox2[0, 1] > bbox2[4, 1]):
        return 0.0
    poly1 = np.stack([bbox1[:4, 0], bbox1[:4, 2]], -1)
    poly2 = np.stack([bbox2[:4, 0], bbox2[:4, 2]], -1)
    inter_area = convex_intersection_area(poly1, poly2)
    a1 = polygon_area(poly1)
    a2 = polygon_area(poly2)
    denom = a1 + a2 - inter_area
    if denom <= 0:
        return 0.0
    return inter_area / denom
