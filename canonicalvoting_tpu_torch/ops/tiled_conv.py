"""Occupied-tile convolutions of the dense backbone: CUDA kernels and their
plain PyTorch versions.

Counterparts of ``canonicalvoting_tpu/ops/pallas/tiled_conv.py``:
``tiled_conv3d`` (odd-k submanifold Conv3D with a fused epilogue),
``tiled_conv3d_prefolded`` (its ``prefolded=True`` stem mode, over the
grid :func:`fold_dydz` builds), ``tiled_down2`` (stride-2 k=2 conv) and
``tiled_up2`` (transposed stride-2 k=2 conv with the U-Net skip concat fused
in), ``tiled_up2_into`` (the same conv written in place into a grid that
holds the skip, layout ``[skip | conv]``) and ``tiled_block3d`` (a whole
BasicBlock in one launch; no model route calls it, as in the JAX package).
The kernels are in ``csrc/tiled_conv.cu``; its header says what bounds them
on the H100 and how they are built.

Grids are margined and channel-last, (X + 2MX, Y + 2MY, Z + 2MZ, C), with
their real channel count, bfloat16 or float32. ``tiles`` is a (T, 3)
int32 tensor of tile coordinates over the interior of the OUTPUT grid;
``occ`` is the output level's margined (Xm, Ym, Zm) float32 occupancy grid.
Weights are (K, Cin, Cout) with x-fastest offsets (``idx = dx + k*dy +
k*k*dz``). Cells outside the listed tiles are exact zeros.

Each wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors, and raises for anything else: there is no fallback from one to the
other. On the card a bfloat16 grid runs the tensor-core kernel (its launch
symbol ``<name>_launch``) and a float32 grid the FFMA kernel
(``<name>_f32_launch``: exact float32 products, no TF32);
``<wrapper>.launches`` counts the bfloat16 launches and
``<wrapper>.launches_f32`` the float32 ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ
from canonicalvoting_tpu_torch.ops.cuda_build import check, launcher

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "tiled_conv3d_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I,
                            _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I,
                            _P, _P, _P, _I, _P],
    "tiled_conv3d_prefolded_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _I, _P,
                                      _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                                      _P],
    "tiled_down2_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                           _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                           _P],
    "tiled_up2_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "tiled_up2_into_launch": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                              _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                              _P],
    "tiled_block3d_launch": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P,
                             _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P,
                             _P, _P, _P, _P, _P, _P, _I, _I, _P],
}
# each float32 launcher takes its bfloat16 twin's arguments
for _name in list(_ARGTYPES):
    _ARGTYPES[_name.replace("_launch", "_f32_launch")] = _ARGTYPES[_name]
_launcher = functools.partial(launcher, "tiled_conv", _ARGTYPES)
#: the grid dtypes of the card's kernels, and their launch symbols' suffix
KERNEL_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}
# the JAX kernel keeps one parity of [skip | conv] in one 128-lane block
# (tiled_conv.py:2013); the port keeps its limit
UP_INTO_MAX_CHANNELS = 128


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.to(device=device, dtype=torch.float32).contiguous()


def _like(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """Weights in the grid's dtype and device: a bfloat16 grid's kernel
    multiplies bfloat16 on the tensor cores, a float32 grid's float32 on the
    FFMA units."""
    if t is None:
        return None
    return t.to(device=x.device, dtype=x.dtype).contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _route(x: torch.Tensor) -> str:
    """"plain" for a CPU grid; for a CUDA grid, the launch symbols' suffix
    of its dtype ("" bfloat16, "_f32" float32)."""
    if x.is_cuda:
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"the CUDA kernels take bfloat16 or float32 grids, "
                            f"got {x.dtype}")
        return KERNEL_DTYPES[x.dtype]
    if x.device.type == "cpu":
        return "plain"
    raise RuntimeError(f"no kernel for tensors on {x.device}")


def _count(wrapper, suffix: str) -> None:
    """One launch on ``wrapper``'s counter of the grid's dtype."""
    name = "launches_f32" if suffix else "launches"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _check_grid(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (Xm, Ym, Zm, C) grid")


def _check_occ(occ: Optional[torch.Tensor], shape) -> None:
    if occ is not None and tuple(occ.shape) != tuple(shape):
        raise ValueError(f"occ {tuple(occ.shape)} does not match grid {tuple(shape)}")


def _interior(shape) -> Tuple[int, int, int]:
    return shape[0] - 2 * MX, shape[1] - 2 * MY, shape[2] - 2 * MZ


def _check_cells(shape) -> None:
    """The occupied-row kernels keep a grid's cell index in 32 bits."""
    if shape[0] * shape[1] * shape[2] >= 2 ** 31:
        raise ValueError(f"grid {tuple(shape[:3])} has 2^31 cells or more")


# the K-major weights' channel padding, and the bfloat16 kernels' reduction
# step: 32 input channels (the float32 kernels step 16 channels and read no
# padding past Cin)
K_CHUNK = 32
# the conv's K splits, for calls whose live rows are too few to fill the
# card (the kernel picks the count from them): at most MAX_SPLITS, in a
# float32 scratch of at most SPLIT_BYTES
MAX_SPLITS = 8
SPLIT_BYTES = 128 << 20


def _cpad(cin: int) -> int:
    """Input channels rounded up to a whole number of K steps."""
    return -(-cin // K_CHUNK) * K_CHUNK


def _k_major(w: torch.Tensor, dtype: torch.dtype, device,
             parities: bool = False):
    """(taps, Cin, Cout) weights -> K-major rows in ``dtype`` on ``device``
    for the occupied-row kernels, Cin zero-padded to a multiple of K_CHUNK:
    (Cout, taps, Cpad) for a conv, or (8, Cout, Cpad) with ``parities`` for
    the up. One copy casts and transposes. Returns (rows, Cpad)."""
    taps, cin, cout = w.shape
    cpad = _cpad(cin)
    shape, src = (((taps, cout, cpad), w.permute(0, 2, 1)) if parities
                  else ((cout, taps, cpad), w.permute(2, 0, 1)))
    rows = (torch.empty if cpad == cin else torch.zeros)(
        shape, dtype=dtype, device=device)
    rows[..., :cin].copy_(src)
    return rows, cpad


def _max_splits(steps: int, n_rows: int, cout: int, extra: int) -> int:
    """The most K splits an occupied-row conv call may take: at most one a
    K step, their float32 sums and ``extra`` more (n_rows, cout) slices
    (the fused 1x1's result) within SPLIT_BYTES."""
    return max(1, min(MAX_SPLITS, steps,
                      SPLIT_BYTES // max(1, 4 * n_rows * cout) - extra))


def _split_scratch(steps: int, n_rows: int, cout: int, extra: int, device,
                   park: bool = False):
    """(s_max, part) of an occupied-row conv call: :func:`_max_splits` and
    their float32 scratch; with one split, none, or with ``park`` (the
    float32 kernel, which parks the fused 1x1's result there) the
    ``extra`` slices alone."""
    s_max = _max_splits(steps, n_rows, cout, extra)
    slices = s_max + extra if s_max > 1 else extra if park else 0
    part = None if slices == 0 else torch.empty(
        slices * n_rows * cout, dtype=torch.float32, device=device)
    return s_max, part


def _block_splits(cin: int, mid: int, cout: int, fused: bool, n_rows: int,
                  device, park: bool = False):
    """(s1, s2, part) of a fused block call: the most K splits of its conv1
    and conv2, as the model's two tiled_conv3d calls take them (so the
    block sums in their order), and one float32 scratch that both use in
    turn, sized as :func:`_split_scratch` sizes each; none when neither
    needs one."""
    s1 = _max_splits(27 * _cpad(cin) // K_CHUNK, n_rows, mid, 0)
    s2 = _max_splits(27 * _cpad(mid) // K_CHUNK, n_rows, cout, int(fused))
    size = max(s1 * mid if s1 > 1 else 0,
               (s2 + int(fused)) * cout if s2 > 1
               else int(fused and park) * cout) * n_rows
    part = torch.empty(size, dtype=torch.float32, device=device) if size else None
    return s1, s2, part


def _check_tiles(tiles: torch.Tensor, x: torch.Tensor, dims, tile_shape) -> None:
    if tiles.dtype != torch.int32 or tiles.dim() != 2 or tiles.shape[1] != 3:
        raise ValueError("tiles must be an int32 (T, 3) tensor")
    if tiles.device != x.device:
        raise ValueError("tiles must lie on the grid's device")
    if any(d % t for d, t in zip(dims, tile_shape)):
        raise ValueError(f"interior {dims} is not a multiple of {tile_shape}")


# ---------------------------------------------------------------------------
# the stem's (dy, dz) fold (an XLA pass in the JAX package: plain torch ops)

# folded channels are padded to a multiple of 8 (75 -> 80 for the 3-channel
# k=5 stem): the kernel's 16-byte operand loads then stay aligned and every
# 8-channel load lies inside one x tap. The JAX package pads to 128 lanes, a
# TPU layout the port does not keep.
FOLD_ALIGN = 8


def folded_channels(cin: int, k: int) -> int:
    return -(-cin * k * k // FOLD_ALIGN) * FOLD_ALIGN


def fold_dydz(x: torch.Tensor, k: int) -> torch.Tensor:
    """(dy, dz) tap fold of a margined (Xm, Ym, Zm, C) grid for the
    prefolded stem: returns (Xm, Ym, Zm, folded_channels(C, k)) where channel
    ``c*k*k + dz*k + dy`` holds channel c of x shifted by (dy - h, dz - h)
    in (y, z), channel-major as the JAX package's ``fold_dydz``
    (``ops/pallas/tiled_conv.py:372``); the padding channels are zero. Reads
    past the grid's border are zeros; interior cells read at most h margin
    rows, which are zero. Built once per scene and shared by every model
    that runs over it, in one strided copy: the output is written once, in
    its own order."""
    Xm, Ym, Zm, C = x.shape
    h = k // 2
    n = C * k * k
    xp = F.pad(x, (0, 0, h, h, h, h)).contiguous()  # (Xm, Ym + 2h, Zm + 2h, C)
    sx, sy, sz, sc = xp.stride()
    # window[x, y, z, c, dz, dy] = xp[x, y + dy, z + dz, c]
    window = xp.as_strided((Xm, Ym, Zm, C, k, k), (sx, sy, sz, sc, sz, sy))
    out = x.new_empty((Xm, Ym, Zm, folded_channels(C, k)))
    out[..., :n].view(Xm, Ym, Zm, C, k, k).copy_(window)
    out[..., n:] = 0
    return out


def fold_stem_weights(w: torch.Tensor, k: int, cf: int) -> torch.Tensor:
    """(k^3, Cin, Cout) x-fastest kernel -> (k, cf, Cout): per x offset dx,
    rows (c, dz, dy) in fold_dydz's channel order (the JAX package's
    ``_fold_w`` prefolded branch), zero rows up to cf."""
    cin, cout = w.shape[1], w.shape[2]
    wk = w.reshape(k, k, k, cin, cout).permute(2, 3, 0, 1, 4)  # (dx, c, dz, dy, co)
    wk = wk.reshape(k, k * k * cin, cout)
    return F.pad(wk, (0, 0, 0, cf - k * k * cin))


def prefold_stem_weights(w: torch.Tensor, k: int, *, dtype: torch.dtype,
                         device) -> torch.Tensor:
    """The prefolded stem kernel's weights: the (k^3, Cin, Cout) kernel
    folded (:func:`fold_stem_weights`) and laid out K-major in ``dtype`` on
    ``device``, (Cout, k, Cpad) with Cpad = folded_channels(Cin, k) rounded
    up to K_CHUNK over zero rows. A caller builds it once per set of
    weights and passes it to :func:`tiled_conv3d_prefolded` as ``wt``."""
    cf = folded_channels(w.shape[1], k)
    return _k_major(fold_stem_weights(w.to(device=device, dtype=dtype), k, cf),
                    dtype, device)[0]


def down2_weights(w: torch.Tensor, *, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """The down kernel's weights: the (8, Cin, Cout) kernel laid out K-major
    in ``dtype`` on ``device``, (Cout, 8, Cpad) with Cpad = Cin rounded up
    to K_CHUNK over zero rows. A caller builds it once per set of weights
    and passes it to :func:`tiled_down2` as ``wt``."""
    return _k_major(w, dtype, device)[0]


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


def tiled_conv3d_prefolded_plain(xf, w, tiles, *, tile_shape, kernel_size,
                                 scale=None, bias=None, occ=None,
                                 relu_out=False):
    k = kernel_size
    h = k // 2
    cout = w.shape[2]
    wf = fold_stem_weights(_wt(w, xf), k, xf.shape[3])
    c = _row_cells(tiles, tile_shape)
    xff = xf.reshape(-1, xf.shape[-1]).float()
    acc = torch.zeros(c.shape[0], cout, dtype=torch.float32, device=xf.device)
    for dx in range(k):  # five x[cell + dx] @ W[dx] products
        d = torch.tensor([dx - h, 0, 0], device=xf.device)
        acc += xff[_flat(c + d, xf.shape)] @ wf[dx]
    oflat = _flat(c, xf.shape)
    occ_rows = None if occ is None else occ.reshape(-1)[oflat].float()
    acc = _epilogue(acc, scale, bias, occ_rows, None, relu_out)
    out = torch.zeros(xf.shape[:3] + (cout,), dtype=xf.dtype, device=xf.device)
    out.view(-1, cout)[oflat] = acc.to(xf.dtype)
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


def tiled_up2_into_plain(x, w, tiles, *, dest, skip_c, tile_shape, scale=None,
                         bias=None, occ=None, relu_out=False):
    Xc, Yc, Zc = _interior(x.shape)
    fshape = (2 * Xc + 2 * MX, 2 * Yc + 2 * MY, 2 * Zc + 2 * MZ)
    cout = w.shape[2]
    conv = tiled_up2_plain(x, w, tiles, tile_shape=tile_shape, scale=scale,
                           bias=bias, occ=occ, relu_out=relu_out)
    oflat = _flat(_row_cells(tiles, tile_shape), fshape)
    rows = dest.view(-1, dest.shape[3])
    rows[oflat, skip_c:skip_c + cout] = conv.view(-1, cout)[oflat].to(dest.dtype)
    return dest


def tiled_block3d_plain(x, w1, w2, tiles, *, tile_shape, scale1, bias1,
                        scale2, bias2, occ, res_w=None, res_scale=None,
                        res_bias=None):
    """The two-conv path: conv1 over the listed tiles, rounded to the grid's
    dtype, then conv2 with the residual. Equal to the fused block because
    every occupied cell lies in a listed tile, so a grown tile's mid outside
    its own tile is either a neighbour tile's mid or masked to zero."""
    kw = dict(tile_shape=tile_shape, kernel_size=3, occ=occ, relu_out=True)
    mid = tiled_conv3d_plain(x, w1, tiles, scale=scale1, bias=bias1, **kw)
    return tiled_conv3d_plain(mid, w2, tiles, scale=scale2, bias=bias2,
                              residual=x, res_w=res_w, res_scale=res_scale,
                              res_bias=res_bias, **kw)


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
    route = _route(x)
    if route == "plain":
        return tiled_conv3d_plain(x, w, tiles, kernel_size=k, residual=residual,
                                  res_w=res_w, res_scale=res_scale,
                                  res_bias=res_bias, **kw)
    _check_cells(x.shape)
    dev = x.device
    out = torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype, device=dev)
    res = None if residual is None else residual.to(x.dtype).contiguous()
    cin = x.shape[3]
    wt, cpad = _k_major(w, x.dtype, dev)
    rwt, crpad, rs, rb = None, 0, None, None
    if res_w is not None:
        rwt, crpad = _k_major(res_w[None], x.dtype, dev)
        rs = _f32(res_scale if res_scale is not None
                  else torch.ones(cout), dev)
        rb = _f32(res_bias if res_bias is not None
                  else torch.zeros(cout), dev)
    sc, bi, oc = _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    args = [x.data_ptr(), cin, *x.shape[:3], wt.data_ptr(), cpad, k, cout,
            tiles.data_ptr(), n_rows, *tile_shape, _ptr(sc), _ptr(bi), _ptr(oc),
            _ptr(res), 0 if res is None else res.shape[3], _ptr(rwt), crpad,
            _ptr(rs), _ptr(rb), int(relu_out), rows.data_ptr(), out.data_ptr()]
    # the kernel splits K when few rows are live
    s_max, part = _split_scratch(k ** 3 * cpad // K_CHUNK, n_rows, cout,
                                 int(rwt is not None), dev, park=bool(route))
    rc = _launcher(f"tiled_conv3d{route}_launch")(*args, _ptr(part), s_max,
                                                  _stream())
    check(rc, "tiled_conv3d")
    _count(tiled_conv3d, route)
    return out


tiled_conv3d.launches = tiled_conv3d.launches_f32 = 0


def tiled_conv3d_prefolded(xf: torch.Tensor, w: torch.Tensor,
                           tiles: torch.Tensor, *,
                           tile_shape: Tuple[int, int, int],
                           kernel_size: int, scale=None, bias=None, occ=None,
                           relu_out: bool = False,
                           wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The k-wide stem conv over fold_dydz's grid ``xf``: only the k
    x-offsets remain as taps, ``out = relu?(occ * (sum_dx xf[cell + (dx - h,
    0, 0)] @ W[dx] * scale + bias))`` over the listed tiles. ``w`` is the
    unfolded (k^3, Cin, Cout) kernel; ``wt`` its folded K-major layout from
    :func:`prefold_stem_weights` in xf's dtype, which a caller builds once
    (else the kernel's route builds it here, each call). The plain version,
    for CPU tensors, ignores ``wt`` and folds ``w`` itself, so the kernel's
    weights are held against a fold of their own. Counterpart of the JAX package's
    ``tiled_conv3d(prefolded=True)``; launches count apart from
    ``tiled_conv3d``'s."""
    _check_grid(xf, "xf")
    k = kernel_size
    if (k % 2 != 1 or k // 2 > MX or w.shape[0] != k ** 3
            or xf.shape[3] != folded_channels(w.shape[1], k)):
        raise ValueError(f"weights {tuple(w.shape)} do not fit a k={k} fold "
                         f"of {tuple(xf.shape)}")
    cout, cf = w.shape[2], xf.shape[3]
    cpad = _cpad(cf)
    if wt is not None and (tuple(wt.shape) != (cout, k, cpad)
                           or wt.device != xf.device):
        raise ValueError(f"wt {tuple(wt.shape)} on {wt.device} is not the "
                         f"({cout}, {k}, {cpad}) fold on {xf.device}")
    _check_tiles(tiles, xf, _interior(xf.shape), tile_shape)
    _check_occ(occ, xf.shape[:3])
    kw = dict(tile_shape=tile_shape, kernel_size=k, scale=scale, bias=bias,
              occ=occ, relu_out=relu_out)
    route = _route(xf)
    if route == "plain":
        return tiled_conv3d_prefolded_plain(xf, w, tiles, **kw)
    _check_cells(xf.shape)
    dev = xf.device
    out = torch.zeros(xf.shape[:3] + (cout,), dtype=xf.dtype, device=dev)
    wt = (prefold_stem_weights(w, k, dtype=xf.dtype, device=dev) if wt is None
          else _like(wt, xf))
    sc, bi, oc = _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    rc = _launcher(f"tiled_conv3d_prefolded{route}_launch")(
        xf.data_ptr(), cf, *xf.shape[:3], wt.data_ptr(), cpad, k, cout,
        tiles.data_ptr(), n_rows, *tile_shape, _ptr(sc), _ptr(bi), _ptr(oc),
        int(relu_out), rows.data_ptr(), out.data_ptr(), _stream())
    check(rc, "tiled_conv3d_prefolded")
    _count(tiled_conv3d_prefolded, route)
    return out


tiled_conv3d_prefolded.launches = tiled_conv3d_prefolded.launches_f32 = 0


def tiled_down2(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor, *,
                tile_shape: Tuple[int, int, int], scale=None, bias=None,
                occ=None, relu_out: bool = False,
                wt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 k=2 conv ``out[o] = sum_d W[d] @ in[2o + d]`` (d = dx + 2dy
    + 4dz) over the listed COARSE tiles, then ``relu?(occ * (. * scale +
    bias))``. x is the fine grid; returns the coarse grid. On the card the
    occupied-row GEMM runs the live coarse cells only (every listed cell
    without ``occ``); the others keep the output's zeros. ``wt`` is ``w``
    laid out by :func:`down2_weights` in x's dtype on x's device, which a
    caller builds once (else the kernel's route lays ``w`` out here, each
    call); the plain version ignores it."""
    _check_grid(x, "x")
    if w.shape[:2] != (8, x.shape[3]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit x {tuple(x.shape)}")
    cout, cpad = w.shape[2], _cpad(x.shape[3])
    if wt is not None and (tuple(wt.shape) != (cout, 8, cpad)
                           or wt.dtype != x.dtype or wt.device != x.device
                           or not wt.is_contiguous()):
        raise ValueError(f"wt {tuple(wt.shape)} {wt.dtype} on {wt.device} is "
                         f"not the ({cout}, 8, {cpad}) layout in {x.dtype} on "
                         f"{x.device}")
    X, Y, Z = _interior(x.shape)
    if X % 2 or Y % 2 or Z % 2:
        raise ValueError("the fine interior must have even dims")
    _check_tiles(tiles, x, (X // 2, Y // 2, Z // 2), tile_shape)
    cshape = (X // 2 + 2 * MX, Y // 2 + 2 * MY, Z // 2 + 2 * MZ)
    _check_occ(occ, cshape)
    kw = dict(tile_shape=tile_shape, scale=scale, bias=bias, occ=occ,
              relu_out=relu_out)
    route = _route(x)
    if route == "plain":
        return tiled_down2_plain(x, w, tiles, **kw)
    _check_cells(x.shape)
    dev = x.device
    out = torch.zeros(cshape + (cout,), dtype=x.dtype, device=dev)
    if wt is None:
        wt = down2_weights(w, dtype=x.dtype, device=dev)
    sc, bi, oc = _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    args = [x.data_ptr(), x.shape[3], *x.shape[:3], wt.data_ptr(), cpad, cout,
            tiles.data_ptr(), n_rows, *tile_shape, *cshape, _ptr(sc), _ptr(bi),
            _ptr(oc), int(relu_out), rows.data_ptr(), out.data_ptr()]
    # the kernel splits K when few rows are live
    s_max, part = _split_scratch(8 * cpad // K_CHUNK, n_rows, cout, 0, dev)
    rc = _launcher(f"tiled_down2{route}_launch")(*args, _ptr(part), s_max,
                                                 _stream())
    check(rc, "tiled_down2")
    _count(tiled_down2, route)
    return out


tiled_down2.launches = tiled_down2.launches_f32 = 0


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
    route = _route(x)
    if route == "plain":
        return tiled_up2_plain(x, w, tiles, skip=skip, skip_c=skip_c, **kw)
    _check_cells(fshape)
    dev = x.device
    cout = w.shape[2]
    out = torch.zeros(fshape + (cout + skip_c,), dtype=x.dtype, device=dev)
    sk = None if skip is None else skip.to(x.dtype).contiguous()
    wt, cpad = _k_major(w, x.dtype, dev, parities=True)
    sc, bi, oc = _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows // 8 + 2, dtype=torch.int32, device=dev)
    rc = _launcher(f"tiled_up2{route}_launch")(
        x.data_ptr(), x.shape[3], *x.shape[:3], wt.data_ptr(), cpad, cout,
        tiles.data_ptr(), n_rows, *tile_shape, *fshape,
        _ptr(sc), _ptr(bi), _ptr(oc), _ptr(sk),
        0 if sk is None else sk.shape[3], skip_c, int(relu_out),
        rows.data_ptr(), out.data_ptr(), _stream())
    check(rc, "tiled_up2")
    _count(tiled_up2, route)
    return out


tiled_up2.launches = tiled_up2.launches_f32 = 0


def tiled_up2_into(x: torch.Tensor, w: torch.Tensor, tiles: torch.Tensor, *,
                   dest: torch.Tensor, skip_c: int,
                   tile_shape: Tuple[int, int, int], scale=None, bias=None,
                   occ=None, relu_out: bool = False) -> torch.Tensor:
    """``tiled_up2``'s conv written IN PLACE into ``dest``: a fine grid of
    ``skip_c + cout`` channels holding the skip in ``[0, skip_c)``. Over the
    listed fine tiles, channels ``[skip_c, skip_c + cout)`` receive
    ``relu?(occ * (W[d] @ in[p] * scale + bias))``, exact zeros where occ
    is 0 whatever dest held there; the skip channels and every cell outside
    the tiles keep dest's values. Returns ``dest``, laid out ``[skip |
    conv]`` (the next conv permutes its input rows). Counterpart of the JAX
    package's ``tiled_up2_into`` (``ops/pallas/tiled_conv.py:1961``). On
    the card it runs tiled_up2's occupied-row GEMM over the live parents,
    so its conv channels equal tiled_up2's bit for bit."""
    _check_grid(x, "x")
    _check_grid(dest, "dest")
    if w.shape[:2] != (8, x.shape[3]):
        raise ValueError(f"weights {tuple(w.shape)} do not fit x {tuple(x.shape)}")
    cout = w.shape[2]
    if skip_c + cout > UP_INTO_MAX_CHANNELS:
        raise ValueError(
            f"tiled_up2_into writes [skip | conv] into at most "
            f"{UP_INTO_MAX_CHANNELS} channels, as the JAX kernel does; skip_c "
            f"{skip_c} + cout {cout} exceed it (a grouped net does)")
    Xc, Yc, Zc = _interior(x.shape)
    fshape = (2 * Xc + 2 * MX, 2 * Yc + 2 * MY, 2 * Zc + 2 * MZ)
    if dest.shape != fshape + (skip_c + cout,) or dest.dtype != x.dtype \
            or dest.device != x.device:
        raise ValueError(f"dest {tuple(dest.shape)} {dest.dtype} must be "
                         f"{fshape + (skip_c + cout,)} {x.dtype} on {x.device}")
    _check_tiles(tiles, x, (2 * Xc, 2 * Yc, 2 * Zc), tile_shape)
    _check_occ(occ, fshape)
    if any(t % 2 for t in tile_shape):
        raise ValueError(f"up tiles need even dims, got {tile_shape}")
    kw = dict(tile_shape=tile_shape, scale=scale, bias=bias, occ=occ,
              relu_out=relu_out)
    route = _route(x)
    if route == "plain":
        return tiled_up2_into_plain(x, w, tiles, dest=dest, skip_c=skip_c, **kw)
    _check_cells(fshape)
    dev = x.device
    wt, cpad = _k_major(w, x.dtype, dev, parities=True)
    sc, bi, oc = _f32(scale, dev), _f32(bias, dev), _f32(occ, dev)
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows // 8 + 2, dtype=torch.int32, device=dev)
    rc = _launcher(f"tiled_up2_into{route}_launch")(
        x.data_ptr(), x.shape[3], *x.shape[:3], wt.data_ptr(), cpad, cout,
        tiles.data_ptr(), n_rows, *tile_shape, *fshape, _ptr(sc), _ptr(bi),
        _ptr(oc), skip_c, dest.shape[3], int(relu_out), rows.data_ptr(),
        dest.data_ptr(), _stream())
    check(rc, "tiled_up2_into")
    _count(tiled_up2_into, route)
    return dest


tiled_up2_into.launches = tiled_up2_into.launches_f32 = 0


def tiled_block3d(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  tiles: torch.Tensor, *, tile_shape: Tuple[int, int, int],
                  scale1, bias1, scale2, bias2, occ: torch.Tensor, res_w=None,
                  res_scale=None, res_bias=None) -> torch.Tensor:
    """A whole BasicBlock over the listed tiles: ``relu(occ * bn2(conv2
    relu(occ * bn1(conv1 x))) + res)``, ``res`` the input (Cin == Cout) or
    the fused 1x1 downsample ``occ * ((x @ res_w) * res_scale + res_bias)``.
    ``w1`` (27, Cin, Mid), ``w2`` (27, Mid, Cout). Returns a new grid of x's
    shape with Cout channels, zeros outside the listed tiles. Counterpart of
    the JAX package's ``tiled_block3d`` (``ops/pallas/tiled_conv.py:977``),
    reading the margined occupancy grid instead of its expanded lane pack.
    On the card it is row 1's occupied-row GEMM twice over one compaction:
    conv1 writes the live rows' mid into a compact buffer, conv2 gathers
    its taps from it through a row map over the grid, so its output equals
    the two tiled_conv3d calls of ``BasicBlock.forward`` bit for bit."""
    _check_grid(x, "x")
    cin, mid, cout = x.shape[3], w1.shape[2], w2.shape[2]
    if w1.shape[:2] != (27, cin) or w2.shape[:2] != (27, mid):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if (res_w is None) != (res_scale is None) or (res_w is None) != (res_bias is None):
        raise ValueError("pass res_w, res_scale and res_bias together")
    if res_w is None and cin != cout:
        raise ValueError(f"the identity residual needs cin == cout, got {cin} -> {cout}")
    if res_w is not None and tuple(res_w.shape) != (cin, cout):
        raise ValueError(f"res_w {tuple(res_w.shape)} must be ({cin}, {cout})")
    _check_tiles(tiles, x, _interior(x.shape), tile_shape)
    if occ is None:
        raise ValueError("the block masks with the level's occupancy: pass occ")
    _check_occ(occ, x.shape[:3])
    kw = dict(tile_shape=tile_shape, scale1=scale1, bias1=bias1, scale2=scale2,
              bias2=bias2, occ=occ, res_w=res_w, res_scale=res_scale,
              res_bias=res_bias)
    route = _route(x)
    if route == "plain":
        return tiled_block3d_plain(x, w1, w2, tiles, **kw)
    _check_cells(x.shape)
    dev = x.device
    out = torch.zeros(x.shape[:3] + (cout,), dtype=x.dtype, device=dev)
    w1t, cpad1 = _k_major(w1, x.dtype, dev)
    w2t, cpad2 = _k_major(w2, x.dtype, dev)
    rwt, crpad = (None, 0) if res_w is None else _k_major(res_w[None], x.dtype, dev)
    f = [_f32(t, dev) for t in (scale1, bias1, scale2, bias2, occ, res_scale,
                                res_bias)]
    n_rows = tiles.shape[0] * tile_shape[0] * tile_shape[1] * tile_shape[2]
    rows = torch.empty(n_rows + 2, dtype=torch.int32, device=dev)
    row_map = torch.empty(x.shape[:3], dtype=torch.int32, device=dev)
    mid_rows = torch.empty(n_rows * mid, dtype=x.dtype, device=dev)
    s1, s2, part = _block_splits(cin, mid, cout, res_w is not None, n_rows, dev,
                                 park=bool(route))
    rc = _launcher(f"tiled_block3d{route}_launch")(
        x.data_ptr(), cin, *x.shape[:3], w1t.data_ptr(), cpad1, w2t.data_ptr(),
        cpad2, mid, cout, tiles.data_ptr(), n_rows, *tile_shape,
        *[_ptr(t) for t in f[:5]], _ptr(rwt), crpad, _ptr(f[5]), _ptr(f[6]),
        rows.data_ptr(), row_map.data_ptr(), mid_rows.data_ptr(),
        out.data_ptr(), _ptr(part), s1, s2, _stream())
    check(rc, "tiled_block3d")
    _count(tiled_block3d, route)
    return out


tiled_block3d.launches = tiled_block3d.launches_f32 = 0
