"""Canonical Hough voting, inference path (objectness grid + lazy rot/scale).

Counterpart of the inference half of ``canonicalvoting_tpu/ops/
hough_voting.py``: ``hough_voting_obj`` builds the objectness vote grid
through the splat kernel (``ops/hv_splat.py``), and ``vote_stats_at_cell``
samples the normalized rotation and scale votes at one cell, so the box
peeler never needs the dense rot/scale grids.

Semantics (upstream ``hv_cuda_kernel.cu``): for every point with predicted
LCC ``xyz``, scale and objectness, each yaw theta_i = i * 2pi / num_rots
gives the vote ``(p - Rot_y(theta) @ (xyz * scale) - corner) / res``; votes
outside ``[0, dims - 1)`` on any axis are dropped; the rest splat obj
trilinearly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.ops.hv_splat import TWO_PI, device_scalar, hv_splat


def compute_corners(points: torch.Tensor,
                    valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(2, 3) [min; max] over the valid points."""
    if valid is None:
        return torch.stack([points.min(0).values, points.max(0).values])
    big = torch.finfo(points.dtype).max
    v = valid[:, None] > 0
    lo = torch.where(v, points, torch.full_like(points, big)).min(0).values
    hi = torch.where(v, points, torch.full_like(points, -big)).max(0).values
    return torch.stack([lo, hi])


def grid_dims_from_corners(corners: torch.Tensor, res: float) -> torch.Tensor:
    """int32 (3,) actual grid dims: (max - min) / res truncated, + 1."""
    res = device_scalar(res, corners.device)
    return ((corners[1] - corners[0]) / res).to(torch.int32) + 1


def round_grid_shape(dims, multiple=64, cap: Optional[tuple] = None) -> tuple:
    """Host helper: round concrete dims up to per-axis multiples."""
    if isinstance(multiple, int):
        multiple = (multiple,) * 3
    out = []
    for i, d in enumerate(np.asarray(dims).tolist()):
        m = multiple[i]
        r = int(np.ceil(max(d, 1) / m) * m)
        if cap is not None:
            r = min(r, cap[i])
        out.append(r)
    return tuple(out)


def vote_stats_at_cell(points, xyz, scale, obj, corner, dims, res: float,
                       num_rots: int, cell, valid=None):
    """(rot_vec (2,), scale_vec (3,)): the normalized rotation and scale vote
    channels that the dense grids would hold at ``cell`` (upstream
    accumulation + ``/ (obj + 1e-7)``), from the per-axis tent weights
    ``max(0, 1 - |u - c|)`` of every vote."""
    # float32 angle products, as the JAX package forms them here
    t = torch.arange(num_rots, dtype=torch.float32, device=points.device) \
        * float(np.float32(TWO_PI / num_rots))
    c, s = torch.cos(t)[None], torch.sin(t)[None]
    res = device_scalar(res, points.device)
    corr = xyz * scale
    cx, cz = corr[:, 0:1], corr[:, 2:3]
    ux = (points[:, 0:1] - cx * c + cz * s - corner[0]) / res
    uy = (points[:, 1] - corr[:, 1] - corner[1]) / res
    uz = (points[:, 2:3] - cx * s - cz * c - corner[2]) / res
    df = dims.float()
    ok = ((ux >= 0.0) & (ux < df[0] - 1.0) & (uz >= 0.0) & (uz < df[2] - 1.0)
          & ((uy >= 0.0) & (uy < df[1] - 1.0))[:, None])
    cellf = cell.float()
    tx = torch.clamp_min(1.0 - torch.abs(ux - cellf[0]), 0.0)
    ty = torch.clamp_min(1.0 - torch.abs(uy - cellf[1]), 0.0)[:, None]
    tz = torch.clamp_min(1.0 - torch.abs(uz - cellf[2]), 0.0)
    w = obj[:, None] * tx * ty * tz * ok.float()
    if valid is not None:
        w = w * (valid > 0).float()[:, None]
    denom = w.sum() + 1e-7
    rot_vec = torch.stack([(w * c).sum(), (w * s).sum()]) / denom
    scale_vec = (w.sum(1)[:, None] * scale).sum(0) / denom
    return rot_vec, scale_vec


def hough_voting_obj(points: torch.Tensor, xyz: torch.Tensor,
                     scale: torch.Tensor, obj: torch.Tensor, *, res: float,
                     num_rots: int, grid_shape: Tuple[int, int, int],
                     corners: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (gx, gy, gz) objectness vote grid; corners default to the valid
    points' bounding box, and dims are clipped to ``grid_shape``."""
    if valid is not None:
        valid = valid.to(points.dtype)
    if corners is None:
        corners = compute_corners(points, valid)
    dims = torch.minimum(grid_dims_from_corners(corners, res),
                         torch.tensor(grid_shape, dtype=torch.int32,
                                      device=points.device))
    return hv_splat(points, xyz, scale, obj, corners[0], dims, res,
                    num_rots=num_rots, grid_shape=grid_shape, valid=valid)
