"""Occupied-tile convolutions of the dense backbone: CUDA kernels and their
plain PyTorch versions.

Counterparts of ``canonicalvoting_tpu/ops/pallas/tiled_conv.py``:
``tiled_conv3d`` (odd-k submanifold Conv3D with a fused epilogue),
``tiled_down2`` (stride-2 k=2 conv) and ``tiled_up2`` (transposed stride-2
k=2 conv with the U-Net skip concat fused in). The kernels are in
``csrc/tiled_conv.cu``; its header says what bounds them on the H100 and how
they are built.

Grids are margined and channel-last, (X + 2MX, Y + 2MY, Z + 2MZ, C), with
their real channel count: bfloat16 on the card (the kernels' only dtype),
bfloat16 or float32 on the CPU. ``tiles`` is a (T, 3)
int32 tensor of tile coordinates over the interior of the OUTPUT grid;
``occ`` is the output level's margined (Xm, Ym, Zm) float32 occupancy grid.
Weights are (K, Cin, Cout) with x-fastest offsets (``idx = dx + k*dy +
k*k*dz``). Cells outside the listed tiles are exact zeros.

Each wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors, and raises for anything else: there is no fallback from one to the
other. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ
from canonicalvoting_tpu_torch.ops.cuda_build import check, library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tiled_conv3d_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                            _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P],
    "tiled_down2_launch": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P, _I, _P, _P],
    "tiled_up2_launch": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}


def _launcher(name: str):
    fn = getattr(library("tiled_conv"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.to(device=device, dtype=torch.float32).contiguous()


def _like(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """Weights in the grid's dtype and device: the kernels run bfloat16 on
    the tensor cores."""
    if t is None:
        return None
    return t.to(device=x.device, dtype=x.dtype).contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16 grids, got {x.dtype}")
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise RuntimeError(f"no kernel for tensors on {x.device}")


def _check_grid(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (Xm, Ym, Zm, C) grid")


def _check_occ(occ: Optional[torch.Tensor], shape) -> None:
    if occ is not None and tuple(occ.shape) != tuple(shape):
        raise ValueError(f"occ {tuple(occ.shape)} does not match grid {tuple(shape)}")


def _interior(shape) -> Tuple[int, int, int]:
    return shape[0] - 2 * MX, shape[1] - 2 * MY, shape[2] - 2 * MZ


def _check_tiles(tiles: torch.Tensor, x: torch.Tensor, dims, tile_shape) -> None:
    if tiles.dtype != torch.int32 or tiles.dim() != 2 or tiles.shape[1] != 3:
        raise ValueError("tiles must be an int32 (T, 3) tensor")
    if tiles.device != x.device:
        raise ValueError("tiles must lie on the grid's device")
    if any(d % t for d, t in zip(dims, tile_shape)):
        raise ValueError(f"interior {dims} is not a multiple of {tile_shape}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the card compares against)

def _row_cells(tiles: torch.Tensor, tile_shape) -> torch.Tensor:
    """Interior (R, 3) int64 coordinates of the listed tiles' cells, in the
    kernels' row order (tile, then x, y, z with z fastest); repeated tiles
    are dropped."""
    t = torch.unique(tiles.long(), dim=0)
    ts = torch.tensor(tile_shape, dtype=torch.long, device=tiles.device)
    local = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=tiles.device) for n in tile_shape],
        indexing="ij"), -1).reshape(-1, 3)
    return (t[:, None, :] * ts + local[None]).reshape(-1, 3)


def _wt(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weights rounded to the grid's dtype, as the kernels (and the JAX
    package) use them, in float32 for the plain matmuls."""
    return w.to(device=x.device, dtype=x.dtype).float()


def _flat(c: torch.Tensor, shape) -> torch.Tensor:
    """Flat index into a margined grid of ``shape`` of interior coords c."""
    return ((c[:, 0] + MX) * shape[1] + c[:, 1] + MY) * shape[2] + c[:, 2] + MZ


def _epilogue(acc, scale, bias, occ_rows, res_rows, relu_out):
    """The TPU kernel's epilogue order: affine, mask, residual, ReLU."""
    if scale is not None:
        acc = acc * scale.float() + bias.float()
    if occ_rows is not None:
        acc = acc * occ_rows[:, None]
    if res_rows is not None:
        acc = acc + res_rows
    if relu_out:
        acc = torch.clamp_min(acc, 0.0)
    return acc


def tiled_conv3d_plain(x, w, tiles, *, tile_shape, kernel_size, scale=None,
                       bias=None, occ=None, residual=None, res_w=None,
                       res_scale=None, res_bias=None, relu_out=False):
    k = kernel_size
    h = k // 2
    cout = w.shape[2]
    c = _row_cells(tiles, tile_shape)
    xf = x.reshape(-1, x.shape[-1]).float()
    acc = torch.zeros(c.shape[0], cout, dtype=torch.float32, device=x.device)
    for tap in range(k ** 3):
        d = torch.tensor([tap % k - h, (tap // k) % k - h, tap // (k * k) - h],
                         device=x.device)
        acc += xf[_flat(c + d, x.shape)] @ _wt(w[tap], x)
    oflat = _flat(c, x.shape)
    occ_rows = None if occ is None else occ.reshape(-1)[oflat].float()
    res_rows = None
    if residual is not None:
        r = residual.reshape(-1, residual.shape[-1])[oflat].float()
        if res_w is not None:
            r = r @ _wt(res_w, x)
            rs = torch.ones(cout) if res_scale is None else res_scale
            rb = torch.zeros(cout) if res_bias is None else res_bias
            r = r * rs.float().to(x.device) + rb.float().to(x.device)
            if occ_rows is not None:
                r = r * occ_rows[:, None]
        res_rows = r
    acc = _epilogue(acc, scale, bias, occ_rows, res_rows, relu_out)
    out = torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype, device=x.device)
    out.view(-1, cout)[oflat] = acc.to(x.dtype)
    return out


def tiled_down2_plain(x, w, tiles, *, tile_shape, scale=None, bias=None,
                      occ=None, relu_out=False):
    X, Y, Z = _interior(x.shape)
    cshape = (X // 2 + 2 * MX, Y // 2 + 2 * MY, Z // 2 + 2 * MZ)
    cout = w.shape[2]
    c = _row_cells(tiles, tile_shape)
    xf = x.reshape(-1, x.shape[-1]).float()
    acc = torch.zeros(c.shape[0], cout, dtype=torch.float32, device=x.device)
    for tap in range(8):
        d = torch.tensor([tap & 1, (tap >> 1) & 1, tap >> 2], device=x.device)
        acc += xf[_flat(2 * c + d, x.shape)] @ _wt(w[tap], x)
    oflat = _flat(c, cshape)
    occ_rows = None if occ is None else occ.reshape(-1)[oflat].float()
    acc = _epilogue(acc, scale, bias, occ_rows, None, relu_out)
    out = torch.zeros(cshape + (cout,), dtype=x.dtype, device=x.device)
    out.view(-1, cout)[oflat] = acc.to(x.dtype)
    return out


def tiled_up2_plain(x, w, tiles, *, tile_shape, scale=None, bias=None,
                    occ=None, skip=None, skip_c=0, relu_out=False):
    Xc, Yc, Zc = _interior(x.shape)
    fshape = (2 * Xc + 2 * MX, 2 * Yc + 2 * MY, 2 * Zc + 2 * MZ)
    cout = w.shape[2]
    c = _row_cells(tiles, tile_shape)
    par = (c[:, 0] & 1) + 2 * (c[:, 1] & 1) + 4 * (c[:, 2] & 1)
    xf = x.reshape(-1, x.shape[-1]).float()[_flat(c >> 1, x.shape)]
    acc = torch.zeros(c.shape[0], cout, dtype=torch.float32, device=x.device)
    for d in range(8):
        sel = par == d
        acc[sel] = xf[sel] @ _wt(w[d], x)
    oflat = _flat(c, fshape)
    occ_rows = None if occ is None else occ.reshape(-1)[oflat].float()
    acc = _epilogue(acc, scale, bias, occ_rows, None, relu_out)
    out = torch.zeros(fshape + (cout + skip_c,), dtype=x.dtype, device=x.device)
    rows = out.view(-1, cout + skip_c)
    rows[oflat, :cout] = acc.to(x.dtype)
    if skip_c:
        rows[oflat, cout:] = skip.reshape(-1, skip.shape[-1])[oflat, :skip_c]
    return out


# ---------------------------------------------------------------------------
# wrappers

def tiled_conv3d(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor, *,
                 tile_shape: Tuple[int, int, int], kernel_size: int,
                 scale=None, bias=None, occ=None, residual=None, res_w=None,
                 res_scale=None, res_bias=None,
                 relu_out: bool = False) -> torch.Tensor:
    """Submanifold odd-k Conv3D over the listed tiles, with the epilogue
    ``relu?(occ * (conv * scale + bias) + res)``, where ``res`` is
    ``residual`` or, with ``res_w`` (Cr, Cout), ``occ * ((residual @ res_w)
    * res_scale + res_bias)``. Returns a new grid of x's shape with Cout
    channels."""
    _check_grid(x, "x")
    k = kernel_size
    if k % 2 != 1 or k // 2 > min(MX, MY) or w.shape[:2] != (k ** 3, x.shape[3]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit k={k}, x {tuple(x.shape)}")
    _check_tiles(tiles, x, _interior(x.shape), tile_shape)
    cout = w.shape[2]
    _check_occ(occ, x.shape[:3])
    if residual is not None:
        _check_grid(residual, "residual")
        want = res_w.shape[0] if res_w is not None else cout
        if residual.shape != x.shape[:3] + (want,):
            raise ValueError(f"residual {tuple(residual.shape)} does not fit")
    kw = dict(tile_shape=tile_shape, scale=scale, bias=bias, occ=occ,
              relu_out=relu_out)
    if _route(x) == "plain":
        return tiled_conv3d_plain(x, w, tiles, kernel_size=k, residual=residual,
                                  res_w=res_w, res_scale=res_scale,
                                  res_bias=res_bias, **kw)
    dev = x.device
    out = torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype, device=dev)
    res = None if residual is None else residual.to(x.dtype).contiguous()
    rw = _like(res_w, x)
    rs = rb = None
    if rw is not None:
        rs = _f32(res_scale if res_scale is not None
                  else torch.ones(cout), dev)
        rb = _f32(res_bias if res_bias is not None
                  else torch.zeros(cout), dev)
    wf, sc, bi, oc = _like(w, x), _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    cells = tile_shape[0] * tile_shape[1] * tile_shape[2]
    rc = _launcher("tiled_conv3d_launch")(
        x.data_ptr(), x.shape[3], *x.shape[:3], wf.data_ptr(),
        k, cout, tiles.data_ptr(), tiles.shape[0] * cells, *tile_shape,
        _ptr(sc), _ptr(bi), _ptr(oc), _ptr(res),
        0 if res is None else res.shape[3], _ptr(rw), _ptr(rs), _ptr(rb),
        int(relu_out), out.data_ptr(), _stream())
    check(rc, "tiled_conv3d")
    tiled_conv3d.launches += 1
    return out


tiled_conv3d.launches = 0


def tiled_down2(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor, *,
                tile_shape: Tuple[int, int, int], scale=None, bias=None,
                occ=None, relu_out: bool = False) -> torch.Tensor:
    """Stride-2 k=2 conv ``out[o] = sum_d W[d] @ in[2o + d]`` (d = dx + 2dy
    + 4dz) over the listed COARSE tiles, then ``relu?(occ * (. * scale +
    bias))``. x is the fine grid; returns the coarse grid."""
    _check_grid(x, "x")
    if w.shape[:2] != (8, x.shape[3]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit x {tuple(x.shape)}")
    X, Y, Z = _interior(x.shape)
    if X % 2 or Y % 2 or Z % 2:
        raise ValueError("the fine interior must have even dims")
    _check_tiles(tiles, x, (X // 2, Y // 2, Z // 2), tile_shape)
    _check_occ(occ, (X // 2 + 2 * MX, Y // 2 + 2 * MY, Z // 2 + 2 * MZ))
    kw = dict(tile_shape=tile_shape, scale=scale, bias=bias, occ=occ,
              relu_out=relu_out)
    if _route(x) == "plain":
        return tiled_down2_plain(x, w, tiles, **kw)
    dev = x.device
    cout = w.shape[2]
    cshape = (X // 2 + 2 * MX, Y // 2 + 2 * MY, Z // 2 + 2 * MZ)
    out = torch.zeros(cshape + (cout,), dtype=x.dtype, device=dev)
    wf, sc, bi, oc = _like(w, x), _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    cells = tile_shape[0] * tile_shape[1] * tile_shape[2]
    rc = _launcher("tiled_down2_launch")(
        x.data_ptr(), x.shape[3], *x.shape[:3], wf.data_ptr(),
        cout, tiles.data_ptr(), tiles.shape[0] * cells, *tile_shape, *cshape,
        _ptr(sc), _ptr(bi), _ptr(oc), int(relu_out), out.data_ptr(), _stream())
    check(rc, "tiled_down2")
    tiled_down2.launches += 1
    return out


tiled_down2.launches = 0


def tiled_up2(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor, *,
              tile_shape: Tuple[int, int, int], scale=None, bias=None,
              occ=None, skip=None, skip_c: int = 0,
              relu_out: bool = False) -> torch.Tensor:
    """Transposed stride-2 k=2 conv ``out[2p + d] = W[d] @ in[p]`` over the
    listed FINE tiles, then ``relu?(occ * (. * scale + bias))``; with
    ``skip`` (a fine grid) the output channels are ``[conv | skip[...,
    :skip_c]]``. x is the coarse grid; returns the fine grid."""
    _check_grid(x, "x")
    if w.shape[:2] != (8, x.shape[3]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit x {tuple(x.shape)}")
    Xc, Yc, Zc = _interior(x.shape)
    fshape = (2 * Xc + 2 * MX, 2 * Yc + 2 * MY, 2 * Zc + 2 * MZ)
    _check_tiles(tiles, x, (2 * Xc, 2 * Yc, 2 * Zc), tile_shape)
    _check_occ(occ, fshape)
    if any(t % 2 for t in tile_shape):
        raise ValueError(f"up tiles need even dims, got {tile_shape}")
    if (skip is None) != (skip_c == 0):
        raise ValueError("pass skip together with skip_c > 0")
    if skip is not None:
        _check_grid(skip, "skip")
        if skip.shape[:3] != fshape or skip.shape[3] < skip_c:
            raise ValueError(f"skip {tuple(skip.shape)} does not fit {fshape}")
    kw = dict(tile_shape=tile_shape, scale=scale, bias=bias, occ=occ,
              relu_out=relu_out)
    if _route(x) == "plain":
        return tiled_up2_plain(x, w, tiles, skip=skip, skip_c=skip_c, **kw)
    dev = x.device
    cout = w.shape[2]
    out = torch.zeros(fshape + (cout + skip_c,), dtype=x.dtype, device=dev)
    sk = None if skip is None else skip.to(x.dtype).contiguous()
    wf, sc, bi, oc = _like(w, x), _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    cells = tile_shape[0] * tile_shape[1] * tile_shape[2]
    rc = _launcher("tiled_up2_launch")(
        x.data_ptr(), x.shape[3], *x.shape[:3], wf.data_ptr(),
        cout, tiles.data_ptr(), tiles.shape[0] * cells, *tile_shape, *fshape,
        _ptr(sc), _ptr(bi), _ptr(oc), _ptr(sk),
        0 if sk is None else sk.shape[3], skip_c, int(relu_out),
        out.data_ptr(), _stream())
    check(rc, "tiled_up2")
    tiled_up2.launches += 1
    return out


tiled_up2.launches = 0
