"""Synthetic scene generator for tests and benchmarks.

Generates room-like point clouds with planted oriented boxes and the exact
per-point label semantics of the ScanNet pipeline (LCC / scale / class), so
the full detection stack can be exercised without the (license-gated) ScanNet
data. Used by the port's tests, its ``eval_joint --synthetic`` CLI and
``chip_smoke.py``. A copy of ``canonicalvoting_tpu/data/synthetic.py``: the
same seed gives the same scene in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from canonicalvoting_tpu_torch.data.geometry import NCLASSES, rotmat_y, unit_box_corners


@dataclass
class SyntheticBox:
    center: np.ndarray
    scale: np.ndarray  # half-extents (matches Scan2CAD label convention)
    yaw: float
    class_idx: int


@dataclass
class SyntheticScene:
    points: np.ndarray          # (N, 3) world
    rgb: np.ndarray             # (N, 3) in [0, 1]
    xyz_labels: np.ndarray      # (N, 3) LCC
    scale_labels: np.ndarray    # (N, 3)
    class_labels: np.ndarray    # (N,) int32, NCLASSES = background
    boxes: List[SyntheticBox] = field(default_factory=list)

    def gt_corners(self) -> List[Tuple[int, np.ndarray]]:
        out = []
        for b in self.boxes:
            c = (rotmat_y(b.yaw) @ np.diag(b.scale) @ unit_box_corners().T).T
            out.append((b.class_idx, c + b.center))
        return out


def _room_surface(rng, ex, n):
    """Points on floor + walls (RGB-D scans are surfaces, not volumes)."""
    # allocate by surface area
    areas = np.array([
        ex[0] * ex[2],            # floor
        ex[0] * ex[1], ex[0] * ex[1],  # front/back walls
        ex[2] * ex[1], ex[2] * ex[1],  # left/right walls
    ])
    counts = (n * areas / areas.sum()).astype(int)
    pts = []
    u = rng.uniform(size=(counts[0], 2))
    pts.append(np.stack([u[:, 0] * ex[0], np.zeros(counts[0]), u[:, 1] * ex[2]], -1))
    for i, z in ((1, 0.0), (2, float(ex[2]))):
        u = rng.uniform(size=(counts[i], 2))
        pts.append(np.stack([u[:, 0] * ex[0], u[:, 1] * ex[1],
                             np.full(counts[i], z)], -1))
    for i, x in ((3, 0.0), (4, float(ex[0]))):
        u = rng.uniform(size=(counts[i], 2))
        pts.append(np.stack([np.full(counts[i], x), u[:, 1] * ex[1],
                             u[:, 0] * ex[2]], -1))
    out = np.concatenate(pts, 0).astype(np.float32)
    return out + rng.randn(len(out), 3).astype(np.float32) * 0.01


def _box_surface_lcc(rng, n):
    """Canonical coords on the surface of the [-1,1]^3 box."""
    face = rng.randint(6, size=n)
    u = rng.uniform(-0.98, 0.98, (n, 2)).astype(np.float32)
    sign = np.where(face % 2 == 0, -0.98, 0.98).astype(np.float32)
    axis = face // 2
    lcc = np.zeros((n, 3), np.float32)
    for a in range(3):
        sel = axis == a
        others = [b for b in range(3) if b != a]
        lcc[sel, a] = sign[sel]
        lcc[sel, others[0]] = u[sel, 0]
        lcc[sel, others[1]] = u[sel, 1]
    return lcc


def make_scene(
    rng: np.random.RandomState,
    extent=(6.0, 2.5, 7.0),
    n_background: int = 40000,
    n_boxes: int = 4,
    pts_per_box: int = 3000,
    scale_range=(0.3, 0.7),
) -> SyntheticScene:
    ex = np.asarray(extent, np.float32)
    pts = [_room_surface(rng, ex, n_background)]
    boxes = []
    for i in range(n_boxes):
        scale = rng.uniform(*scale_range, 3).astype(np.float32)
        # rejection-sample a center that keeps boxes disjoint
        for _ in range(100):
            center = rng.uniform(ex * 0.15, ex * 0.85).astype(np.float32)
            center[1] = min(center[1], scale[1] + 0.2)
            r = float(np.linalg.norm(scale)) + 0.2
            ok = all(
                np.linalg.norm(center - b.center)
                > r + float(np.linalg.norm(b.scale))
                for b in boxes
            )
            if ok:
                break
        yaw = float(rng.uniform(-np.pi, np.pi))
        lcc = _box_surface_lcc(rng, pts_per_box)
        world = (rotmat_y(yaw) @ (lcc * scale).T).T + center
        pts.append(world.astype(np.float32))
        boxes.append(SyntheticBox(center, scale, yaw, i % NCLASSES))

    points = np.concatenate(pts, 0)
    xyz = np.zeros_like(points)
    scl = np.full_like(points, 0.25)
    cls = np.full((len(points),), NCLASSES, np.int32)
    for b in boxes:
        R = rotmat_y(b.yaw)
        inv = ((points - b.center) @ R) / b.scale
        inside = np.all(np.abs(inv) < 1.0, axis=-1)
        xyz[inside] = inv[inside]
        scl[inside] = b.scale
        cls[inside] = b.class_idx
    rgb = rng.uniform(0, 1, points.shape).astype(np.float32)
    return SyntheticScene(
        points=points.astype(np.float32),
        rgb=rgb,
        xyz_labels=xyz.astype(np.float32),
        scale_labels=scl.astype(np.float32),
        class_labels=cls,
        boxes=boxes,
    )


def perfect_predictions(scene: SyntheticScene, points_w: np.ndarray,
                        base_prob: float = 0.02, obj_prob: float = 0.95):
    """Ideal model outputs at given (quantized) world points — lets the vote +
    peel + NMS + mAP stages be tested in isolation from the backbone."""
    xyz = np.zeros_like(points_w)
    scl = np.full_like(points_w, 0.25)
    prob = np.full((len(points_w),), base_prob, np.float32)
    cls = np.zeros((len(points_w),), np.int32)
    for b in scene.boxes:
        R = rotmat_y(b.yaw)
        inv = ((points_w - b.center) @ R) / b.scale
        inside = np.all(np.abs(inv) < 1.0, axis=-1)
        xyz[inside] = inv[inside]
        scl[inside] = b.scale
        prob[inside] = obj_prob
        cls[inside] = b.class_idx
    return (xyz.astype(np.float32), scl.astype(np.float32), prob, cls)


def encode_joint_head_rows(points_w, xyz, scl, prob_is_high, cls, cap):
    """Per-point predictions -> raw joint-model head rows
    (cap, 6*n + n + 1), inverse of eval.pipeline.slice_joint_heads
    (reference head slicing: eval_joint.py:173-190).

    Rows beyond ``len(points_w)`` stay zero (padding). Low-prob points are
    encoded as background (logit on the n-th class); their xyz/scale land
    in class-0 slots, matching the reference's background->class-0 gather.
    Used by the parity tests and the planted detection-bearing tail of
    ``chip_smoke.py``.
    """
    nclasses = NCLASSES
    n = len(points_w)
    rows = np.zeros((cap, 6 * nclasses + nclasses + 1), np.float32)
    r = np.arange(n)
    slot = np.where(prob_is_high, cls, 0)
    xyz_all = rows[:, : 3 * nclasses].reshape(cap, nclasses, 3)
    scale_all = rows[:, 3 * nclasses: 6 * nclasses].reshape(cap, nclasses, 3)
    xyz_all[r, slot] = xyz
    scale_all[r, slot] = np.log(scl)
    logits = rows[:, 6 * nclasses:]
    hot = np.where(prob_is_high, cls, nclasses)
    logits[r, hot] = 4.0  # softmax prob ~0.858 fg / ~0.016 bg
    return rows


def encode_separate_head_rows(points_w, xyz, scl, prob_is_high, cap):
    """Per-point predictions -> raw per-category head rows (cap, 8), inverse
    of eval.pipeline.slice_separate_heads (xyz 3 + scale 3 + binary
    objectness logits 2; upstream train_separate.py:247-249). High rows get
    the foreground logit 4 (softmax prob ~0.982), the rest the background
    logit 4 (~0.018). The planted rows of the separate evaluator's tests and
    of ``chip_smoke.py``."""
    n = len(points_w)
    rows = np.zeros((cap, 8), np.float32)
    rows[:, 6] = 4.0  # background default (low foreground prob)
    r = np.arange(n)[prob_is_high]
    rows[r, 0:3] = xyz[prob_is_high]
    rows[r, 3:6] = np.log(scl[prob_is_high])
    rows[r, 6] = 0.0
    rows[r, 7] = 4.0
    return rows
