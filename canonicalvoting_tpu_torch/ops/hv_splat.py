"""The vote splat: CUDA kernel and its plain PyTorch version.

Counterpart of ``hv_splat_pallas`` in
``canonicalvoting_tpu/ops/pallas/hv_splat.py``: ``hv_splat`` is its
``channels=1`` objectness grid, ``hv_splat6`` its ``channels=6`` raw sums
``[obj, obj*cos, obj*sin, obj*sx, obj*sy, obj*sz]``. The kernel is in
``csrc/hv_splat.cu``; its header says what bounds it on the H100, and how it
makes the sums deterministic (64-bit fixed-point integer atomics).

Both wrappers run the kernel for CUDA tensors and the plain version for CPU
tensors, and raise for anything else. ``<wrapper>.launches`` counts kernel
launches, apart for the two channel counts.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.ops.cuda_build import check, library

TWO_PI = 2.0 * 3.141592654  # the upstream CUDA kernel's constant

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, ctypes.c_float,
             _I, _I, _I, _I, _P, _P, _P]


def rotation_table(num_rots: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 of theta_i = i * 2pi / num_rots, as the JAX
    package computes them (angles rounded to float32 first)."""
    thetas = (np.arange(num_rots) * (TWO_PI / num_rots)).astype(np.float32)
    t = torch.from_numpy(thetas).to(device)
    return torch.cos(t), torch.sin(t)


def device_scalar(v: float, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``. Dividing by it is an IEEE
    division on the card, as in the kernel (and the upstream kernel); a
    Python float divisor becomes a multiply by its reciprocal there, which
    rounds some votes differently and moves the in-range test of a vote
    that sits on the grid's edge."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def hv_splat_plain(points, xyz, scale, obj, corner, dims, res, *, num_rots,
                   grid_shape, valid=None, channels=1):
    """Scatter-add of every in-range vote's 8 float32 trilinear weights (times
    ``[1, cos, sin, sx, sy, sz]`` with 6 channels, each product in float32),
    summed in float64 so the reference carries no summation error of its
    own (a hot cell collects ~1e5 votes). (gx, gy, gz) with one channel,
    (gx, gy, gz, 6) with six."""
    if channels not in (1, 6):
        raise ValueError(f"channels must be 1 or 6, got {channels}")
    gx, gy, gz = grid_shape
    dev = points.device
    cosv, sinv = rotation_table(num_rots, dev)
    corr = xyz * scale
    objv = obj if valid is None else obj * valid
    cx, cy, cz = corr[:, 0:1], corr[:, 1:2], corr[:, 2:3]
    dimf = dims.float()
    res = device_scalar(res, dev)
    grid = torch.zeros(gx * gy * gz, channels, dtype=torch.float64, device=dev)
    for r0 in range(0, num_rots, 8):  # 8 rotations of votes at a time
        c = cosv[None, r0:r0 + 8]
        s = sinv[None, r0:r0 + 8]
        off_x = -c * cx + s * cz
        off_y = (-cy).expand_as(off_x)
        off_z = -s * cx - c * cz
        u = torch.stack([(points[:, 0:1] + off_x - corner[0]) / res,
                         (points[:, 1:2] + off_y - corner[1]) / res,
                         (points[:, 2:3] + off_z - corner[2]) / res], -1)
        ok = torch.all((u >= 0.0) & (u < dimf - 1.0), -1)
        u = u[ok]
        ob = objv[:, None].expand(ok.shape)[ok]
        if channels == 6:
            chan = torch.stack([c.expand(ok.shape), s.expand(ok.shape)]
                               + [scale[:, a:a + 1].expand(ok.shape)
                                  for a in range(3)], -1)[ok]
        fl = torch.floor(u)
        w1 = u - fl
        fl = fl.long()
        for b in range(8):
            bits = ((b >> 2) & 1, (b >> 1) & 1, b & 1)
            w = None
            for a, bit in enumerate(bits):
                wa = w1[:, a] if bit else 1.0 - w1[:, a]
                w = wa if w is None else w * wa
            idx = ((fl[:, 0] + bits[0]) * gy + fl[:, 1] + bits[1]) * gz \
                + fl[:, 2] + bits[2]
            w = (w * ob)[:, None]
            if channels == 6:
                w = torch.cat([w, w * chan], 1)
            grid.index_add_(0, idx, w.double())
    grid = grid.float().reshape(gx, gy, gz, channels)
    return grid[..., 0] if channels == 1 else grid


def _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
           grid_shape, valid, channels):
    n = points.shape[0]
    for name, t, shape in (("points", points, (n, 3)), ("xyz", xyz, (n, 3)),
                           ("scale", scale, (n, 3)), ("obj", obj, (n,)),
                           ("corner", corner, (3,)), ("dims", dims, (3,))):
        if tuple(t.shape) != shape or t.device != points.device:
            raise ValueError(f"{name} must be {shape} on {points.device}")
    if valid is not None and tuple(valid.shape) != (n,):
        raise ValueError("valid must be (N,)")
    if not points.is_cuda:
        if points.device.type != "cpu":
            raise RuntimeError(f"no kernel for tensors on {points.device}")
        return hv_splat_plain(points, xyz, scale, obj, corner, dims, res,
                              num_rots=num_rots, grid_shape=grid_shape,
                              valid=valid, channels=channels)
    gx, gy, gz = grid_shape
    dev = points.device
    f = [t.to(torch.float32).contiguous() for t in (points, xyz, scale, obj, corner)]
    v = None if valid is None else valid.to(torch.float32).contiguous()
    # the kernel's writes stay inside the grid only with dims <= grid_shape
    d = torch.minimum(dims.to(torch.int32),
                      torch.tensor(grid_shape, dtype=torch.int32, device=dev))
    cosv, sinv = rotation_table(num_rots, dev)
    acc = torch.empty(gx * gy * gz * channels, dtype=torch.int64, device=dev)
    out = torch.empty((gx, gy, gz, channels), dtype=torch.float32, device=dev)
    fn = library("hv_splat").hv_splat_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(*[t.data_ptr() for t in f[:4]], None if v is None else v.data_ptr(),
            n, cosv.data_ptr(), sinv.data_ptr(), num_rots, f[4].data_ptr(),
            d.data_ptr(), float(res), gx, gy, gz, channels, acc.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "hv_splat")
    (hv_splat6 if channels == 6 else hv_splat).launches += 1
    return out


def hv_splat(points: torch.Tensor, xyz: torch.Tensor, scale: torch.Tensor,
             obj: torch.Tensor, corner: torch.Tensor, dims: torch.Tensor,
             res: float, *, num_rots: int, grid_shape: Tuple[int, int, int],
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw objectness vote grid (gx, gy, gz) float32.

    points/xyz/scale (N, 3), obj and valid (N,) float32; ``corner`` (3,) is
    the grid origin and ``dims`` (3,) int32 the grid's actual extent (the
    bounds test), both on the points' device; ``grid_shape`` the static
    capacity.
    """
    return _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
                  grid_shape, valid, 1).reshape(grid_shape)


hv_splat.launches = 0


def hv_splat6(points: torch.Tensor, xyz: torch.Tensor, scale: torch.Tensor,
              obj: torch.Tensor, corner: torch.Tensor, dims: torch.Tensor,
              res: float, *, num_rots: int, grid_shape: Tuple[int, int, int],
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw (gx, gy, gz, 6) float32 vote sums ``[obj, obj*cos, obj*sin,
    obj*sx, obj*sy, obj*sz]``, channel-last as the JAX package returns them;
    arguments as :func:`hv_splat`."""
    return _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
                  grid_shape, valid, 6)


hv_splat6.launches = 0
