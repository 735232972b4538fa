"""Plain canonical Hough voting, box peeling and NMS: the benchmark's
reference for the detection tail.

Semantics of the upstream decoder (``hv_cuda_kernel.cu``, ``eval_joint.py``
/ ``eval_separate.py``): every point votes, for each of ``num_rots`` yaws
theta_i = i * 2pi / num_rots, at ``(p - Rot_y(theta) (xyz * scale) -
corner) / res``; a vote outside ``[0, dims - 1)`` on any axis is dropped,
the rest splat their objectness trilinearly. The peel takes the grid's
largest cell while it holds at least ``thresh_high`` votes, reads the
rotation and scale votes at that cell, zeroes the cell's neighbourhood and
every cell inside the box, and keeps the box when enough confident points
inside it agree with their predicted local coordinates. NMS is greedy by
score over the boxes' 3D IoU (bird's-eye polygon overlap times height
overlap).

The reference forms positions in float32, each operation rounded in the
upstream kernel's order, and sums in float64; the control forms and sums
them in bfloat16. One category at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

TWO_PI = 2.0 * 3.141592654  # the upstream kernel's constant


@dataclass(frozen=True)
class PeelSettings:
    res: float = 0.03
    thresh_high: float = 60.0
    thresh_low: int = 10
    valid_ratio: float = 0.2
    elimination: int = 2
    prob_thresh: float = 0.3
    err_thresh: float = 0.3
    max_boxes: int = 64
    max_iters: int = 128


def unit_corners(device, dtype) -> torch.Tensor:
    x = [1, 1, -1, -1, 1, 1, -1, -1]
    y = [1, 1, 1, 1, -1, -1, -1, -1]
    z = [1, -1, -1, 1, 1, -1, -1, 1]
    return torch.tensor([x, y, z], dtype=dtype, device=device).t()


def heads_of(rows: torch.Tensor, log_scale: bool = True):
    """(xyz, scale, prob) of per-category head rows (..., 8): xyz 3, scale 3
    (log), two objectness logits."""
    scale = torch.exp(rows[..., 3:6]) if log_scale else rows[..., 3:6]
    return rows[..., :3], scale, torch.softmax(rows[..., 6:8], -1)[..., 1]


def corners_and_dims(points: torch.Tensor, res: float, grid_shape):
    """(corner (3,), dims (3,) int) over float32 points: the grid's dims are
    the extent over ``res`` truncated, plus one, clipped to the grid."""
    p = points.float()
    lo, hi = p.min(0).values, p.max(0).values
    r = torch.tensor(res, dtype=torch.float32, device=p.device)
    dims = ((hi - lo) / r).to(torch.int32) + 1
    dims = torch.minimum(dims, torch.tensor(grid_shape, dtype=torch.int32,
                                            device=p.device))
    return lo, dims


def _angles(num_rots: int, device, dtype):
    """cos and sin of theta_i, the angles formed in float64 and rounded to
    float32, their cos and sin in float32 (then ``dtype``)."""
    t = torch.from_numpy((np.arange(num_rots) * (TWO_PI / num_rots))
                         .astype(np.float32)).to(device)
    return torch.cos(t).to(dtype), torch.sin(t).to(dtype)


def _votes(points, xyz, scale, corner, res, c, s):
    """(N, R) vote coordinates ux, uz and (N,) uy: each operation rounded
    in the inputs' dtype, in the order of the upstream kernel."""
    corr = xyz * scale
    cx, cy, cz = corr[:, 0:1], corr[:, 1], corr[:, 2:3]
    offx = (-c) * cx + s * cz
    offz = (-s) * cx - c * cz
    ux = ((points[:, 0:1] + offx) - corner[0]) / res
    uy = ((points[:, 1] + (-cy)) - corner[1]) / res
    uz = ((points[:, 2:3] + offz) - corner[2]) / res
    return ux, uy, uz


def splat(points, xyz, scale, obj, corner, dims, res: float, num_rots: int,
          grid_shape, acc=torch.float64, rot_chunk: int = 30) -> torch.Tensor:
    """The (gx, gy, gz) objectness grid of one category: the votes and
    their trilinear weights in the inputs' dtype, summed in ``acc``."""
    dev, dt = points.device, points.dtype
    gx, gy, gz = grid_shape
    grid = torch.zeros(gx * gy * gz, dtype=acc, device=dev)
    r_t = torch.tensor(res, dtype=dt, device=dev)
    lim = dims.to(dt) - 1
    c_all, s_all = _angles(num_rots, dev, dt)
    for r0 in range(0, num_rots, rot_chunk):
        c, s = c_all[None, r0:r0 + rot_chunk], s_all[None, r0:r0 + rot_chunk]
        ux, uy, uz = _votes(points, xyz, scale, corner, r_t, c, s)
        u = torch.stack([ux, uy[:, None].expand_as(ux), uz], -1).reshape(-1, 3)
        ok = ((u >= 0) & (u < lim)).all(-1)
        u = u[ok]
        w = obj[:, None].expand_as(ux).reshape(-1)[ok]
        f = torch.floor(u)
        r = u - f
        f = f.long()
        for bits in range(8):
            b = [(bits >> 2) & 1, (bits >> 1) & 1, bits & 1]
            wa = [r[:, a] if b[a] else 1 - r[:, a] for a in range(3)]
            wt = ((wa[0] * wa[1]) * wa[2]) * w
            idx = ((f[:, 0] + b[0]) * gy + f[:, 1] + b[1]) * gz + f[:, 2] + b[2]
            grid.index_add_(0, idx, wt.to(acc))
    return grid.view(gx, gy, gz)


def stats_at(points, xyz, scale, obj, corner, dims, res, num_rots, cell, acc):
    """(rot_vec (2,), scale_vec (3,)) in ``acc``: the normalized rotation
    and scale votes at ``cell``, from the per-axis tent weights of every
    in-range vote."""
    dt = points.dtype
    c, s = _angles(num_rots, points.device, dt)
    r_t = torch.tensor(res, dtype=dt, device=points.device)
    ux, uy, uz = _votes(points, xyz, scale, corner, r_t, c[None], s[None])
    lim = dims.to(dt) - 1
    ok = ((ux >= 0) & (ux < lim[0]) & (uz >= 0) & (uz < lim[2])
          & ((uy >= 0) & (uy < lim[1]))[:, None])
    cf = cell.to(dt)
    tx = torch.clamp_min(1 - (ux - cf[0]).abs(), 0)
    ty = torch.clamp_min(1 - (uy - cf[1]).abs(), 0)[:, None]
    tz = torch.clamp_min(1 - (uz - cf[2]).abs(), 0)
    w = torch.where(ok, obj[:, None] * tx * ty * tz, torch.zeros_like(tx)).to(acc)
    den = w.sum() + 1e-7
    rot = torch.stack([(w * c.to(acc)).sum(), (w * s.to(acc)).sum()]) / den
    sc = (w.sum(1)[:, None] * scale.to(acc)).sum(0) / den
    return rot, sc


def peel(grid, points, xyz, scale, prob, corner, dims, num_rots: int,
         cfg: PeelSettings, acc=torch.float64) -> Dict[str, torch.Tensor]:
    """Boxes (n, 8, 3) and scores (n,) peeled off one category's grid, in
    the order found; ``truncated`` when a budget and not the threshold
    ended the loop. Positions in the points' dtype, sums in ``acc``."""
    dt, dev = points.dtype, grid.device
    grid = grid.clone()
    gx, gy, gz = grid.shape
    e = cfg.elimination
    hi = e - 1      # upstream eval_separate.py's exclusive elimination window
    ix = torch.arange(gx, device=dev)[:, None, None]
    iy = torch.arange(gy, device=dev)[None, :, None]
    iz = torch.arange(gz, device=dev)[None, None, :]
    r_t = torch.tensor(cfg.res, dtype=dt, device=dev)
    unit = unit_corners(dev, dt)
    boxes, scores, done, dropped = [], [], False, 0
    for _ in range(cfg.max_iters):
        flat = int(torch.argmax(grid.reshape(-1)))
        cand = (flat // (gy * gz), (flat // gz) % gy, flat % gz)
        if float(grid.reshape(-1)[flat]) < cfg.thresh_high:
            done = True
            break
        cell = torch.tensor(cand, device=dev)
        world = corner + r_t * cell.to(dt)
        rot_vec, sc = stats_at(points, xyz, scale, prob, corner, dims,
                               cfg.res, num_rots, cell, acc)
        rot = torch.atan2(rot_vec[1], rot_vec[0]).to(dt)
        c, s = torch.cos(rot), torch.sin(rot)
        sc = sc.to(dt)
        sc = torch.where(sc.abs() < 1e-12, torch.full_like(sc, 1e-12), sc)
        elim = ((ix >= cand[0] - e) & (ix <= cand[0] + hi)
                & (iy >= cand[1] - e) & (iy <= cand[1] + hi)
                & (iz >= cand[2] - e) & (iz <= cand[2] + hi))
        dx = (ix - cand[0]).to(dt) * r_t
        dy = (iy - cand[1]).to(dt) * r_t
        dz = (iz - cand[2]).to(dt) * r_t
        inside_cells = ((((dx * c + dz * s) / sc[0]).abs() < 1)
                        & ((dy / sc[1]).abs() < 1)
                        & (((-dx * s + dz * c) / sc[2]).abs() < 1))
        grid = torch.where(elim | inside_cells, torch.zeros_like(grid), grid)

        d = points - world
        w0 = (d[:, 0] * c + d[:, 2] * s) / sc[0]
        w1 = d[:, 1] / sc[1]
        w2 = (-d[:, 0] * s + d[:, 2] * c) / sc[2]
        inside = (w0.abs() < 1) & (w1.abs() < 1) & (w2.abs() < 1)
        n_inside = int(inside.sum())
        conf = inside & (prob > cfg.prob_thresh)
        n_conf = int(conf.sum())
        err_vec = torch.linalg.norm((xyz - torch.stack([w0, w1, w2], -1)).to(acc),
                                    dim=-1)
        err = float((err_vec * prob.to(acc))[conf].sum()) / max(n_conf, 1)
        if (n_conf >= cfg.valid_ratio * n_inside and n_inside >= cfg.thresh_low
                and err <= cfg.err_thresh):
            if len(boxes) < cfg.max_boxes:
                bx, by, bz = (unit[:, a] * sc[a] for a in range(3))
                boxes.append(torch.stack([c * bx - s * bz, by, s * bx + c * bz],
                                         -1) + world)
                scores.append(float(prob[inside].max()) if n_inside else 0.0)
            else:
                dropped += 1
    out_boxes = (torch.stack(boxes) if boxes
                 else torch.zeros(0, 8, 3, dtype=dt, device=dev))
    return {"boxes": out_boxes,
            "scores": torch.tensor(scores, dtype=torch.float64),
            "truncated": (not done) or dropped > 0}


# ------------------------------------------------------------------- NMS
def _area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    signed = np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    return poly if signed >= 0 else poly[::-1]


def _clip(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: the part of ``poly`` left of a -> b."""
    out = []
    d = b - a
    for i in range(len(poly)):
        p, q = poly[i], poly[(i + 1) % len(poly)]
        sp = d[0] * (p[1] - a[1]) - d[1] * (p[0] - a[0])
        sq = d[0] * (q[1] - a[1]) - d[1] * (q[0] - a[0])
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            out.append(p + sp / (sp - sq) * (q - p))
    return np.array(out) if out else np.zeros((0, 2))


def iou3d(b1: np.ndarray, b2: np.ndarray) -> float:
    """3D IoU of two yaw-rotated boxes given by their (8, 3) corners (0-3
    the top face): the x-z footprints' overlap times the y overlap."""
    p1 = _ccw(b1[:4][:, [0, 2]].astype(np.float64))
    p2 = _ccw(b2[:4][:, [0, 2]].astype(np.float64))
    poly = p1
    for i in range(4):
        poly = _clip(poly, p2[i], p2[(i + 1) % 4])
        if len(poly) == 0:
            return 0.0
    inter2d = _area(poly) if len(poly) >= 3 else 0.0
    y1 = (b1[:, 1].min(), b1[:, 1].max())
    y2 = (b2[:, 1].min(), b2[:, 1].max())
    ih = max(0.0, min(y1[1], y2[1]) - max(y1[0], y2[0]))
    inter = inter2d * ih
    v1 = _area(p1) * (y1[1] - y1[0])
    v2 = _area(p2) * (y2[1] - y2[0])
    union = v1 + v2 - inter
    return inter / union if union > 0 else 0.0


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS: the highest score first, dropping every box whose IoU
    with a kept one exceeds ``thresh``; the kept indices in that order."""
    order = list(np.argsort(scores, kind="stable"))
    keep = []
    while order:
        i = order.pop()
        keep.append(int(i))
        order = [j for j in order if iou3d(boxes[i], boxes[j]) <= thresh]
    return keep
