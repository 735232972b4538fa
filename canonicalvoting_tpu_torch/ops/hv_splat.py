"""The vote splat: CUDA kernel and its plain PyTorch version.

Counterpart of ``hv_splat_pallas`` in
``canonicalvoting_tpu/ops/pallas/hv_splat.py``: ``hv_splat`` is its
``channels=1`` objectness grid, ``hv_splat6`` its ``channels=6`` raw sums
``[obj, obj*cos, obj*sin, obj*sx, obj*sy, obj*sz]``, each of one category
or of several in one launch (the separate evaluator's categories);
``hv_splat_windowed`` is ``hv_splat_windowed`` there, ``hv_splat``'s
function through (y plane, x bucket) windows. The kernels are in
``csrc/hv_splat.cu``; its header says what bounds them on the H100, and
how they make the sums deterministic (64-bit fixed-point integer
atomics). ``hv_splat6_sums`` hands back the 6-channel splat's sums before
their conversion (``sums_to_float``), for a reduction over ranks
(``parallel/hv_sharded.py``).

The wrappers run the kernel for CUDA tensors and the plain version for CPU
tensors, and raise for anything else. ``<wrapper>.launches`` counts kernel
launches, each wrapper its own. A call on the card makes no host sync once
its device constants (the rotation table, ``res``, the grid's extent) are
cached for its device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.ops.cuda_build import check, launcher

TWO_PI = 2.0 * 3.141592654  # the upstream CUDA kernel's constant

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "hv_votes_launch": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                        ctypes.c_float, _I, _I, _I, _I, _I, _I, _P, _P],
    "hv_fixed_to_float_launch": [_P, ctypes.c_longlong, _P, _P],
}
_launcher = functools.partial(launcher, "hv_splat", _ARGTYPES)


def rotation_angles(num_rots: int) -> np.ndarray:
    """float32 theta_i = i * 2pi / num_rots, as the JAX package's XLA path
    forms them (``ops/hough_voting.py:_theta_chunks``: float64 products
    rounded to float32)."""
    return (np.arange(num_rots) * (TWO_PI / num_rots)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rotation_table(num_rots: int, device: torch.device):
    t = torch.from_numpy(rotation_angles(num_rots)).to(device)
    return torch.cos(t), torch.sin(t)


def rotation_table(num_rots: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 of :func:`rotation_angles`, computed on
    ``device``; built once per (num_rots, device) and cached, so a splat's
    call copies nothing from the host. Callers must not write to them."""
    return _rotation_table(num_rots, torch.device(device))


@functools.lru_cache(maxsize=None)
def _device_scalar(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def device_scalar(v: float, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``, cached per (v, device).
    Dividing by it is an IEEE division on the card, as in the kernel (and
    the upstream kernel); a Python float divisor becomes a multiply by its
    reciprocal there, which rounds some votes differently and moves the
    in-range test of a vote that sits on the grid's edge."""
    return _device_scalar(float(v), torch.device(device))


@functools.lru_cache(maxsize=None)
def _grid_extent(grid_shape: Tuple[int, int, int], device: torch.device):
    return torch.tensor(grid_shape, dtype=torch.int32, device=device)


def clip_dims(dims: torch.Tensor, grid_shape) -> torch.Tensor:
    """int32 ``dims`` clipped to the static capacity ``grid_shape``, against
    an extent tensor cached per (grid_shape, device): the kernels' writes
    stay inside the grid only with dims <= grid_shape."""
    return torch.minimum(dims.to(torch.int32),
                         _grid_extent(tuple(grid_shape), dims.device))


def hv_splat_plain(points, xyz, scale, obj, corner, dims, res, *, num_rots,
                   grid_shape, valid=None, channels=1, sums=False):
    """Scatter-add of every in-range vote's 8 float32 trilinear weights (times
    ``[1, cos, sin, sx, sy, sz]`` with 6 channels, each product in float32),
    summed in float64 so the reference carries no summation error of its
    own (a hot cell collects ~1e5 votes), then rounded to float32 (with
    ``sums``: the float64 sums, 6 channels only). (gx, gy, gz) with one
    channel, (gx, gy, gz, 6) with six; with a leading category axis on xyz,
    scale and obj, one such grid per category, stacked (a loop over the
    categories)."""
    if channels not in (1, 6):
        raise ValueError(f"channels must be 1 or 6, got {channels}")
    if obj.dim() == 2:
        return torch.stack([_splat_plain(points, xyz[c], scale[c], obj[c],
                                         corner, dims, res, num_rots,
                                         grid_shape, valid, channels,
                                         sums=sums)
                            for c in range(obj.shape[0])])
    return _splat_plain(points, xyz, scale, obj, corner, dims, res, num_rots,
                        grid_shape, valid, channels, sums=sums)


def _splat_plain(points, xyz, scale, obj, corner, dims, res, num_rots,
                 grid_shape, valid, channels, x_window=None, sums=False):
    """hv_splat_plain's grid, or with ``sums`` its float64 sums (gx, gy,
    gz, channels) before the conversion; ``x_window`` ((N,), (N,)) int64
    keeps only the corners whose x cell lies in the point's [lo, hi)."""
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
        if valid is not None:  # as the kernels: an invalid row places nothing
            ok = ok & (valid > 0)[:, None]
        u = u[ok]
        ob = objv[:, None].expand(ok.shape)[ok]
        if x_window is not None:
            lo, hi = (t[:, None].expand(ok.shape)[ok] for t in x_window)
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
            if x_window is not None:
                xcell = fl[:, 0] + bits[0]
                keep = (xcell >= lo) & (xcell < hi)
                idx, w = idx[keep], w[keep]
            grid.index_add_(0, idx, w.double())
    grid = grid.reshape(gx, gy, gz, channels)
    if sums:
        return grid
    grid = grid.float()
    return grid[..., 0] if channels == 1 else grid


def _route(points, xyz, scale, obj, corner, dims, valid,
           categories: bool = False) -> str:
    """Check the splat's arguments: "cuda" for the kernel, "plain" for CPU
    tensors; anything else raises. With ``categories`` xyz, scale and obj
    may carry a leading category axis."""
    n = points.shape[0]
    lead = tuple(obj.shape[:-1])
    if len(lead) > int(categories):
        raise ValueError(f"obj must be (N,){' or (C, N)' * categories}, "
                         f"got {tuple(obj.shape)}")
    for name, t, shape in (("points", points, (n, 3)),
                           ("xyz", xyz, lead + (n, 3)),
                           ("scale", scale, lead + (n, 3)),
                           ("obj", obj, lead + (n,)),
                           ("corner", corner, (3,)), ("dims", dims, (3,))):
        if tuple(t.shape) != shape or t.device != points.device:
            raise ValueError(f"{name} must be {shape} on {points.device}")
    if valid is not None and tuple(valid.shape) != (n,):
        raise ValueError("valid must be (N,)")
    if points.is_cuda:
        return "cuda"
    if points.device.type != "cpu":
        raise RuntimeError(f"no kernel for tensors on {points.device}")
    return "plain"


def _kernel_args(points, xyz, scale, obj, corner, dims, valid, num_rots,
                 grid_shape):
    """The kernels' inputs on the card: float32 rows, valid or None, dims
    clipped to grid_shape and the rotation table. No host sync."""
    f = [t.to(torch.float32).contiguous() for t in (points, xyz, scale, obj, corner)]
    v = None if valid is None else valid.to(torch.float32).contiguous()
    return f, v, clip_dims(dims, grid_shape), rotation_table(num_rots,
                                                             points.device)


def _votes(acc, f, v, d, tables, res, num_rots, grid_shape, channels,
           window=(0, 0)):
    """Launch the vote kernel of ``_kernel_args``' inputs: every category's
    votes added into ``acc``, (C, gx, gy, gz, channels) int64 fixed point
    that the caller zeroed. ``window`` (x_bucket, x_pad) with x_bucket > 0
    runs the windowed splat's vote kernel."""
    cosv, sinv = tables
    gx, gy, gz = grid_shape
    n_cat = f[3].shape[0] if f[3].dim() == 2 else 1
    rc = _launcher("hv_votes_launch")(
        *[t.data_ptr() for t in f[:4]], None if v is None else v.data_ptr(),
        f[0].shape[0], n_cat, cosv.data_ptr(), sinv.data_ptr(), num_rots,
        f[4].data_ptr(), d.data_ptr(), float(res), gx, gy, gz, channels,
        *window, acc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(rc, "hv_splat votes")


def _fixed_to_float(acc: torch.Tensor, out: torch.Tensor) -> None:
    rc = _launcher("hv_fixed_to_float_launch")(
        acc.data_ptr(), acc.numel(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    check(rc, "hv_splat fixed_to_float")


def _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
           grid_shape, valid, channels, window=None):
    """The splats' route: the plain version for CPU tensors, else the
    scratch, the vote kernel (windowed with ``window``, (x_bucket,
    x_pad)) and the conversion."""
    if _route(points, xyz, scale, obj, corner, dims, valid,
              categories=True) == "plain":
        kw = dict(num_rots=num_rots, grid_shape=grid_shape, valid=valid)
        if window is not None:
            return hv_splat_windowed_plain(
                points, xyz, scale, obj, corner, dims, res, x_bucket=window[0],
                x_pad=window[1], **kw)
        return hv_splat_plain(points, xyz, scale, obj, corner, dims, res,
                              channels=channels, **kw)
    return sums_to_float(_card_sums(points, xyz, scale, obj, corner, dims,
                                    res, num_rots, grid_shape, valid,
                                    channels, window))


def _card_sums(points, xyz, scale, obj, corner, dims, res, num_rots,
               grid_shape, valid, channels, window=None):
    """The vote kernel's int64 fixed-point sums (C?, gx, gy, gz, channels)
    in a scratch it zeroes; counts the wrapper's launch."""
    f, v, d, tables = _kernel_args(points, xyz, scale, obj, corner, dims,
                                   valid, num_rots, grid_shape)
    shape = tuple(obj.shape[:-1]) + tuple(grid_shape) + (channels,)
    acc = torch.zeros(shape, dtype=torch.int64, device=points.device)
    _votes(acc, f, v, d, tables, res, num_rots, grid_shape, channels,
           (0, 0) if window is None else window)
    (hv_splat_windowed if window is not None
     else hv_splat6 if channels == 6 else hv_splat).launches += 1
    return acc


def sums_to_float(sums: torch.Tensor) -> torch.Tensor:
    """float32 grid of :func:`hv_splat6_sums`' sums (or of a sum of
    them): the fixed point's conversion kernel on the card, a rounding of
    the float64 sums on the CPU."""
    if sums.dtype == torch.float64 and sums.device.type == "cpu":
        return sums.float()
    if sums.dtype != torch.int64 or not sums.is_cuda:
        raise ValueError(f"sums must be int64 on the card or float64 on the "
                         f"CPU, got {sums.dtype} on {sums.device}")
    out = torch.empty(sums.shape, dtype=torch.float32, device=sums.device)
    _fixed_to_float(sums, out)
    return out


def hv_splat(points: torch.Tensor, xyz: torch.Tensor, scale: torch.Tensor,
             obj: torch.Tensor, corner: torch.Tensor, dims: torch.Tensor,
             res: float, *, num_rots: int, grid_shape: Tuple[int, int, int],
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw objectness vote grid (gx, gy, gz) float32.

    points/xyz/scale (N, 3), obj and valid (N,) float32; ``corner`` (3,) is
    the grid origin and ``dims`` (3,) int32 the grid's actual extent (the
    bounds test), both on the points' device; ``grid_shape`` the static
    capacity. xyz (C, N, 3), scale (C, N, 3) and obj (C, N) splat C
    categories over the same points in one launch: (C, gx, gy, gz), each
    grid exactly the single call's.
    """
    out = _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
                 grid_shape, valid, 1)
    return out.reshape(tuple(obj.shape[:-1]) + tuple(grid_shape))


hv_splat.launches = 0


def hv_splat6(points: torch.Tensor, xyz: torch.Tensor, scale: torch.Tensor,
              obj: torch.Tensor, corner: torch.Tensor, dims: torch.Tensor,
              res: float, *, num_rots: int, grid_shape: Tuple[int, int, int],
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw (gx, gy, gz, 6) float32 vote sums ``[obj, obj*cos, obj*sin,
    obj*sx, obj*sy, obj*sz]``, channel-last as the JAX package returns them;
    arguments as :func:`hv_splat`. xyz (C, N, 3), scale (C, N, 3) and obj
    (C, N) splat C categories over the same points in one launch: (C, gx,
    gy, gz, 6), each grid exactly the single call's."""
    return _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
                  grid_shape, valid, 6)


hv_splat6.launches = 0


def hv_splat6_sums(points: torch.Tensor, xyz: torch.Tensor,
                   scale: torch.Tensor, obj: torch.Tensor,
                   corner: torch.Tensor, dims: torch.Tensor, res: float, *,
                   num_rots: int, grid_shape: Tuple[int, int, int],
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`hv_splat6`'s sums before their conversion to float32: on the
    card the vote kernel's int64 fixed point (2^-32 a unit; the launch
    counts as hv_splat6's), for CPU tensors the plain version's float64
    sums; (gx, gy, gz, 6), or (C, gx, gy, gz, 6) with a category axis.
    Sums of several calls over parts of the points (an all-reduce over
    ranks) convert with :func:`sums_to_float`; on the card integer sums do
    not depend on their order, so that grid is bitwise hv_splat6's over
    all the points."""
    if _route(points, xyz, scale, obj, corner, dims, valid,
              categories=True) == "plain":
        return hv_splat_plain(points, xyz, scale, obj, corner, dims, res,
                              num_rots=num_rots, grid_shape=grid_shape,
                              valid=valid, channels=6, sums=True)
    return _card_sums(points, xyz, scale, obj, corner, dims, res, num_rots,
                      grid_shape, valid, 6)


def window_keys(points, xyz, scale, corner, dims, res, *, grid_shape,
                valid=None, x_bucket=32, x_pad=40) -> torch.Tensor:
    """(N,) int64 segment key of each point, the JAX package's bucketing
    (``hv_splat.py:440-456``): ``jy * NB + bx`` for a point whose vote floor
    y plane is jy, whose x cell lies in x bucket bx (of NB = gx // x_bucket)
    and whose rotation radius is at most ``x_pad - 2`` cells; ``gy * NB +
    jy`` (the tail) for larger radii; ``gy * NB + gy`` for points off the y
    range or not valid. The y plane is computed as the kernels place it."""
    gx, gy, _ = grid_shape
    nb = gx // x_bucket
    res = device_scalar(res, points.device)
    corr = xyz * scale
    center_y = (points[:, 1] - corr[:, 1] - corner[1]) / res
    jy = torch.floor(center_y).long()
    y_ok = (center_y >= 0.0) & (center_y < dims[1].float() - 1.0)
    if valid is not None:
        y_ok = y_ok & (valid > 0)
    px = (points[:, 0] - corner[0]) / res
    r = torch.sqrt(corr[:, 0] ** 2 + corr[:, 2] ** 2) / res
    bx = torch.clamp(torch.floor(px / x_bucket).long(), 0, nb - 1)
    key = torch.where(r <= float(x_pad - 2), jy * nb + bx, gy * nb + jy)
    return torch.where(y_ok, key, torch.full_like(key, gy * nb + gy))


def _check_window(grid_shape, x_bucket, x_pad) -> None:
    if x_bucket <= 0 or x_pad < 0 or grid_shape[0] % x_bucket:
        raise ValueError(f"grid x {grid_shape[0]} must be a multiple of "
                         f"x_bucket {x_bucket} > 0, and x_pad {x_pad} >= 0")


def hv_splat_windowed_plain(points, xyz, scale, obj, corner, dims, res, *,
                            num_rots, grid_shape, valid=None, x_bucket=32,
                            x_pad=40):
    """The windowed splat's function, segment by segment: each point of a
    windowed segment keeps only the corners inside its segment's x window
    ``[bx * x_bucket - x_pad, bx * x_bucket + x_bucket + x_pad)`` (the JAX
    kernel's canvas), tail points keep every corner and points of no
    segment none; summed in float64 as :func:`hv_splat_plain`. With the
    keys right no corner leaves its window, so this equals hv_splat_plain;
    a wrong bucket or a dropped tail point shows. A leading category axis
    on xyz, scale and obj gives one grid per category, stacked."""
    _check_window(grid_shape, x_bucket, x_pad)
    kw = dict(num_rots=num_rots, grid_shape=grid_shape, valid=valid,
              x_bucket=x_bucket, x_pad=x_pad)
    if obj.dim() == 2:
        return torch.stack([hv_splat_windowed_plain(
            points, xyz[c], scale[c], obj[c], corner, dims, res, **kw)
            for c in range(obj.shape[0])])
    gx, gy, _ = grid_shape
    nb = gx // x_bucket
    key = window_keys(points, xyz, scale, corner, dims, res,
                      grid_shape=grid_shape, valid=valid, x_bucket=x_bucket,
                      x_pad=x_pad)
    lo = (key % nb) * x_bucket - x_pad
    hi = lo + x_bucket + 2 * x_pad
    tail = (key >= gy * nb) & (key < gy * nb + gy)
    lo = torch.where(tail, torch.full_like(lo, -x_pad), lo)
    hi = torch.where(tail, torch.full_like(hi, gx + x_pad), hi)
    hi = torch.where(key == gy * nb + gy, lo, hi)  # no segment: no corner
    return _splat_plain(points, xyz, scale, obj, corner, dims, res, num_rots,
                        grid_shape, valid, 1, x_window=(lo, hi))


def hv_splat_windowed(points: torch.Tensor, xyz: torch.Tensor,
                      scale: torch.Tensor, obj: torch.Tensor,
                      corner: torch.Tensor, dims: torch.Tensor, res: float, *,
                      num_rots: int, grid_shape: Tuple[int, int, int],
                      valid: Optional[torch.Tensor] = None,
                      chunk_points: int = 128, rot_chunk: int = 8,
                      x_bucket: int = 32, x_pad: int = 40) -> torch.Tensor:
    """:func:`hv_splat`'s objectness grid through (y plane, x bucket)
    windows: each point's corners kept only inside the x window of its
    :func:`window_keys` segment (the large-radius tail: the full width).
    Counterpart of the JAX package's ``hv_splat_windowed``
    (``ops/pallas/hv_splat.py:404``); ``chunk_points`` and ``rot_chunk``
    size that kernel's MXU steps and are accepted and unused here, and no
    keyword changes the result. Needs ``gx % x_bucket == 0``. xyz (C, N,
    3), scale (C, N, 3) and obj (C, N) splat C categories in one launch,
    as :func:`hv_splat`. On the card each vote is placed once and each
    window worked out in the vote kernel (``csrc/hv_splat.cu``:
    ``windowed_vote_kernel``); the grid equals hv_splat's bitwise: each
    vote is placed and weighted by the same float operations, and the
    fixed-point sums do not depend on order."""
    del chunk_points, rot_chunk
    _check_window(grid_shape, x_bucket, x_pad)
    out = _splat(points, xyz, scale, obj, corner, dims, res, num_rots,
                 grid_shape, valid, 1, window=(x_bucket, x_pad))
    return out.reshape(tuple(obj.shape[:-1]) + tuple(grid_shape))


hv_splat_windowed.launches = 0
