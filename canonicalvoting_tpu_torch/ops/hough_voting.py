"""Canonical Hough voting.

Counterpart of ``canonicalvoting_tpu/ops/hough_voting.py``:
``hough_voting_obj`` builds the objectness vote grid through the splat
kernel (``ops/hv_splat.py``), and ``vote_stats_at_cell`` samples the
normalized rotation and scale votes at one cell, so the lazy box peeler
never needs the dense rot/scale grids; ``hough_voting`` builds all three
grids through the 6-channel splat (the non-lazy path) and is
differentiable: its backward is the JAX package's custom VJP
(``_backward_obj``, ``ops/hough_voting.py:227-339``; upstream
``hv_cuda_kernel.cu:168-259``), the transpose of the objectness splat in
plain torch over chunks of rotations, on either device. Only the
objectness grid's cotangent flows (the rot and scale ones are discarded,
upstream ``train_joint.py:31-37``), to xyz, scale and obj; points, corners
and valid get zeros, and the 1/res factor of the chain rule is left out,
as upstream leaves it out.

Semantics (upstream ``hv_cuda_kernel.cu``): for every point with predicted
LCC ``xyz``, scale and objectness, each yaw theta_i = i * 2pi / num_rots
gives the vote ``(p - Rot_y(theta) @ (xyz * scale) - corner) / res``; votes
outside ``[0, dims - 1)`` on any axis are dropped; the rest splat obj
trilinearly.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.ops.hv_splat import (
    TWO_PI, clip_dims, device_scalar, hv_splat, hv_splat6, hv_splat_windowed)

#: the splat routes of hough_voting_obj: "auto" and "pallas" run the plane
#: splat (hv_splat), "pallas_windowed" the windowed one where the grid's x
#: extent is a multiple of its 32-cell buckets. The JAX package's "xla" and
#: "pallas_interpret" name its own backends and have no counterpart here.
HV_METHODS = ("auto", "pallas", "pallas_windowed")
WINDOW_X_BUCKET = 32


def check_hv_method(method: str) -> None:
    if method not in HV_METHODS:
        raise ValueError(f"hv_method must be one of {HV_METHODS}, got {method!r}")


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


def clipped_grid_dims(corners: torch.Tensor, res: float,
                      grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """The grid dims of :func:`grid_dims_from_corners` clipped to the
    static capacity ``grid_shape``: the bounds of every vote test. No host
    sync once ``res`` and the extent are cached for the device."""
    return clip_dims(grid_dims_from_corners(corners, res), grid_shape)


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
    """(rot_vec (..., 2), scale_vec (..., 3)): the normalized rotation and
    scale vote channels that the dense grids would hold at ``cell``
    (upstream accumulation + ``/ (obj + 1e-7)``), from the per-axis tent
    weights ``max(0, 1 - |u - c|)`` of every vote.

    ``xyz``/``scale`` (..., N, 3), ``obj`` (..., N) and ``cell`` (..., 3)
    may carry leading batch dims (the categories of the batched peel); each
    batch entry sums exactly as an unbatched call does."""
    # float32 angle products, as the JAX package forms them here
    t = torch.arange(num_rots, dtype=torch.float32, device=points.device) \
        * float(np.float32(TWO_PI / num_rots))
    c, s = torch.cos(t), torch.sin(t)
    res = device_scalar(res, points.device)
    corr = xyz * scale
    cx, cz = corr[..., 0:1], corr[..., 2:3]
    ux = (points[:, 0:1] - cx * c + cz * s - corner[0]) / res    # (..., N, R)
    uy = (points[:, 1] - corr[..., 1] - corner[1]) / res         # (..., N)
    uz = (points[:, 2:3] - cx * s - cz * c - corner[2]) / res
    df = dims.float()
    ok = ((ux >= 0.0) & (ux < df[0] - 1.0) & (uz >= 0.0) & (uz < df[2] - 1.0)
          & ((uy >= 0.0) & (uy < df[1] - 1.0))[..., None])
    cellf = cell.float()[..., None, :]                            # (..., 1, 3)
    tx = torch.clamp_min(1.0 - torch.abs(ux - cellf[..., 0:1]), 0.0)
    ty = torch.clamp_min(1.0 - torch.abs(uy - cellf[..., 1]), 0.0)[..., None]
    tz = torch.clamp_min(1.0 - torch.abs(uz - cellf[..., 2:3]), 0.0)
    # invalid rows drop out by select, not by a product: the sparse args'
    # padding rows may hold junk heads far from the grid
    keep = ok if valid is None else ok & (valid > 0)[:, None]
    w = torch.where(keep, obj[..., None] * tx * ty * tz, torch.zeros_like(tx))
    denom = (w.sum((-2, -1)) + 1e-7)[..., None]
    rot_vec = torch.stack([(w * c).sum((-2, -1)), (w * s).sum((-2, -1))],
                          -1) / denom
    ws = w.sum(-1)[..., None] * scale
    if valid is not None:  # 0 * a padding row's non-finite scale is NaN
        ws = torch.where((valid > 0)[:, None], ws, torch.zeros_like(ws))
    scale_vec = ws.sum(-2) / denom
    return rot_vec, scale_vec


def hough_voting_obj(points: torch.Tensor, xyz: torch.Tensor,
                     scale: torch.Tensor, obj: torch.Tensor, *, res: float,
                     num_rots: int, grid_shape: Tuple[int, int, int],
                     corners: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None,
                     method: str = "auto") -> torch.Tensor:
    """The (gx, gy, gz) objectness vote grid; corners default to the valid
    points' bounding box, and dims are clipped to ``grid_shape``. ``method``
    (:data:`HV_METHODS`) picks the splat as the JAX package does
    (``ops/hough_voting.py:501-542``): "pallas_windowed" runs
    :func:`hv_splat_windowed` when ``gx % 32 == 0`` and the plane splat
    otherwise; "auto" and "pallas" run the plane splat. Every route gives
    the same grid. xyz (C, N, 3), scale (C, N, 3) and obj (C, N) give the C
    categories' grids (C, gx, gy, gz) over the same points in one splat
    launch, plane or windowed."""
    check_hv_method(method)
    if valid is not None:
        valid = valid.to(points.dtype)
    if corners is None:
        corners = compute_corners(points, valid)
    dims = clipped_grid_dims(corners, res, grid_shape)
    kw = dict(num_rots=num_rots, grid_shape=grid_shape, valid=valid)
    if method == "pallas_windowed" and grid_shape[0] % WINDOW_X_BUCKET == 0:
        return hv_splat_windowed(points, xyz, scale, obj, corners[0], dims,
                                 res, x_bucket=WINDOW_X_BUCKET, **kw)
    return hv_splat(points, xyz, scale, obj, corners[0], dims, res, **kw)


# the kernel's 8 corners, (x, y, z) bits with z fastest (hv_cuda_kernel.cu:52-59)
_CORNER_BITS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
# rotations a backward chunk takes: (N, 4, 8, 3) temporaries
_ROT_CHUNK = 4


@functools.lru_cache(maxsize=64)
def _backward_constants(num_rots: int, device: torch.device):
    """(angles, corner bits, their signs) on ``device``, copied there once:
    the float32 sweep i * 2pi / num_rots formed in float64 and rounded, as
    the JAX package's XLA path forms it (``_theta_chunks``)."""
    thetas = torch.from_numpy(
        (np.arange(num_rots) * (TWO_PI / num_rots)).astype(np.float32)).to(device)
    cb = torch.tensor(_CORNER_BITS, device=device)
    return thetas, cb, torch.where(cb == 0, -1.0, 1.0)


def hough_backward_obj(points, xyz, scale, obj, corner, dims, res: float,
                       num_rots: int, grid_shape: Tuple[int, int, int],
                       g_obj, valid=None):
    """(d_xyz, d_scale, d_obj): the transpose of the objectness splat at
    ``g_obj`` (the JAX package's ``_backward_obj``): per vote, d_obj the
    trilinear weights times the cotangent at its 8 cells, and d_center
    the cotangent times each axis' tent slope, weighted by obj and rotated
    back; d_xyz = d_corr * scale, d_scale = d_corr * xyz, with d_corr =
    -Rot_y^T d_center and no 1/res factor (upstream's). Votes outside
    [0, dims - 1) and invalid rows contribute nothing. ``_ROT_CHUNK``
    rotations at a time; no host sync."""
    gx, gy, gz = grid_shape
    total = gx * gy * gz
    dev = points.device
    res = device_scalar(res, dev)
    corr = xyz * scale
    objv = obj if valid is None else obj * valid
    g_flat = g_obj.reshape(-1)
    thetas, cb, sign = _backward_constants(num_rots, dev)           # cb (8, 3)
    limit = dims.float() - 1.0
    cx, cy, cz = corr[:, 0:1], corr[:, 1:2], corr[:, 2:3]
    d_obj = torch.zeros_like(obj)
    d_corr = torch.zeros_like(xyz)
    for t0 in range(0, num_rots, _ROT_CHUNK):
        th = thetas[t0:t0 + _ROT_CHUNK][None]                         # (1, T)
        c, s = torch.cos(th), torch.sin(th)
        off_x = -c * cx + s * cz
        off_y = (-cy).expand_as(off_x)
        off_z = -s * cx - c * cz
        center = torch.stack([(points[:, 0:1] + off_x - corner[0]) / res,
                              (points[:, 1:2] + off_y - corner[1]) / res,
                              (points[:, 2:3] + off_z - corner[2]) / res], -1)
        inb = ((center >= 0.0) & (center < limit)).all(-1)           # (N, T)
        fl = torch.floor(center)
        resid = center - fl
        idx = fl.long()[:, :, None, :] + cb                          # (N, T, 8, 3)
        flat = (idx[..., 0] * gy + idx[..., 1]) * gz + idx[..., 2]
        flat = torch.where(inb[..., None], flat, torch.full_like(flat, total))
        g = torch.where(flat < total, g_flat[flat.clamp(0, total - 1)],
                        torch.zeros((), device=dev))                 # (N, T, 8)
        w_axes = torch.where(cb == 0, (1.0 - resid)[:, :, None, :],
                             resid[:, :, None, :])                   # (N, T, 8, 3)
        w8 = w_axes[..., 0] * w_axes[..., 1] * w_axes[..., 2]
        d_obj = d_obj + (g * w8).sum((1, 2))
        prod_other = torch.stack([w_axes[..., 1] * w_axes[..., 2],
                                  w_axes[..., 0] * w_axes[..., 2],
                                  w_axes[..., 0] * w_axes[..., 1]], -1)
        gm = g * inb.to(g.dtype)[..., None]
        d_center = (gm[..., None] * sign * prod_other).sum(2) * objv[:, None, None]
        gxc, gyc, gzc = d_center[..., 0], d_center[..., 1], d_center[..., 2]
        d_corr = d_corr + torch.stack([(-c * gxc - s * gzc).sum(1),
                                       (-gyc).sum(1),
                                       (s * gxc - c * gzc).sum(1)], -1)
    d_xyz, d_scale = d_corr * scale, d_corr * xyz
    if valid is not None:
        d_obj = d_obj * valid
        d_xyz = d_xyz * valid[:, None]
        d_scale = d_scale * valid[:, None]
    return d_xyz, d_scale, d_obj


class _HoughVoting(torch.autograd.Function):
    """The 6-channel splat forward; the objectness splat's transpose
    backward (:func:`hough_backward_obj`)."""

    @staticmethod
    def forward(ctx, points, xyz, scale, obj, corners, valid, res, num_rots,
                grid_shape):
        dims = clipped_grid_dims(corners, res, grid_shape)
        raw = hv_splat6(points, xyz, scale, obj, corners[0], dims, res,
                        num_rots=num_rots, grid_shape=grid_shape, valid=valid)
        ctx.save_for_backward(points, xyz, scale, obj, corners, dims, valid)
        ctx.res, ctx.num_rots, ctx.grid_shape = res, num_rots, grid_shape
        denom = raw[..., 0:1] + 1e-7
        return raw[..., 0], raw[..., 1:3] / denom, raw[..., 3:6] / denom

    @staticmethod
    def backward(ctx, g_obj, _g_rot, _g_scale):
        points, xyz, scale, obj, corners, dims, valid = ctx.saved_tensors
        d_xyz, d_scale, d_obj = hough_backward_obj(
            points, xyz, scale, obj, corners[0], dims, ctx.res, ctx.num_rots,
            ctx.grid_shape, g_obj, valid)

        def zeros(t, i):
            return torch.zeros_like(t) if ctx.needs_input_grad[i] else None

        return (zeros(points, 0), d_xyz, d_scale, d_obj, zeros(corners, 4),
                None if valid is None else zeros(valid, 5), None, None, None)


def hough_voting(points: torch.Tensor, xyz: torch.Tensor, scale: torch.Tensor,
                 obj: torch.Tensor, *, res: float, num_rots: int,
                 grid_shape: Tuple[int, int, int],
                 corners: Optional[torch.Tensor] = None,
                 valid: Optional[torch.Tensor] = None):
    """(grid_obj (gx, gy, gz), grid_rot (gx, gy, gz, 2), grid_scale (gx, gy,
    gz, 3)): the 6-channel splat's raw sums, rot and scale normalized by
    ``grid_obj + 1e-7`` as the JAX package does outside its kernel
    (upstream ``hv_cuda_kernel.cu:100-119``). Corners and dims as
    :func:`hough_voting_obj`. xyz (C, N, 3), scale (C, N, 3) and obj (C,
    N) give the C categories' grids, each with a leading C axis, from one
    splat launch (the JAX package's separate evaluator scans the
    categories; each grid is the single call's). There is no windowed
    route here: the JAX package's ``hough_voting`` computes
    "pallas_windowed" through its XLA scatter
    (``ops/hough_voting.py:173-186``), the same function as this 6-channel
    splat, so the pipelines' non-lazy tails ignore the method.
    Differentiable in xyz, scale and obj through ``grid_obj``, for one
    category (the JAX VJP's form; module docstring)."""
    if valid is not None:
        valid = valid.to(points.dtype)
    if corners is None:
        corners = compute_corners(points, valid)
    if torch.is_grad_enabled() and xyz.dim() != 2 and any(
            t.requires_grad for t in (xyz, scale, obj)):
        raise ValueError("the hough_voting backward takes one category, as "
                         "the JAX package's custom VJP does")
    return _HoughVoting.apply(points, xyz, scale, obj, corners, valid, res,
                              num_rots, tuple(grid_shape))
