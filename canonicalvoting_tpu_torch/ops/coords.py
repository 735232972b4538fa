"""Host-side sparse-voxel coordinate manager: the gather-form kernel maps.

The port's copy of ``canonicalvoting_tpu/ops/coords.py`` (MinkowskiEngine's
CoordinateManager). The host builds, per scene, the coordinate pyramid
(stride 1, 2, 4, 8, 16) and every neighbor table of the U-Net, padded to
static capacities; the device then runs gathers and GEMMs
(``ops/sparse_conv.py``).

Neighbor tables are in gather form: for output row m and kernel offset k,
``nbr[m, k]`` is the input row whose coordinate equals ``out_coord[m] +
offset[k]``, or -1. Offsets are enumerated x-fastest, MinkowskiEngine's
kernel-region order, so converted checkpoints index weights identically.
Stride semantics: odd kernels are centered on the input lattice; the k=2
stride-2 down takes offsets ``{0, s}`` and outputs ``unique(floor(c / 2s) *
2s)``; the transposed up is the down table reversed, in gather form over
the fine rows.

Tables come from the native coordinate manager (``csrc/coords_native.c``,
built with ``cc`` on first use; a failed build raises) unless the caller
passes ``native=False``, which runs the NumPy path. Both give the same
arrays: downsampled coordinates are sorted by packed key on either path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

# Bit layout for packed coordinate keys (host int64): batch | x | y | z.
_AXIS_BITS = 18
_AXIS_OFF = 1 << (_AXIS_BITS - 1)  # shift so negatives pack fine

_I32P = ctypes.POINTER(ctypes.c_int32)
_NATIVE_ARGTYPES = {
    "build_nbr_table_native": (ctypes.c_int, [
        _I32P, ctypes.c_int64, _I32P, ctypes.c_int64, _I32P, ctypes.c_int64,
        _I32P, ctypes.c_int64]),
    "downsample_coords_native": (ctypes.c_int64, [
        _I32P, ctypes.c_int64, ctypes.c_int32, _I32P]),
}


def _native(name: str):
    """``libcoords_native.so``'s function ``name``, typed; the library is
    built with cc on first use, and a failed build raises."""
    from canonicalvoting_tpu_torch.ops.cuda_build import library

    fn = getattr(library("coords_native"), name)
    if fn.argtypes is None:
        fn.restype, fn.argtypes = _NATIVE_ARGTYPES[name]
    return fn


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def pack_coords(coords: np.ndarray) -> np.ndarray:
    """Pack (N, 4) int [b, x, y, z] into int64 keys."""
    c = coords.astype(np.int64)
    x = c[:, 1] + _AXIS_OFF
    y = c[:, 2] + _AXIS_OFF
    z = c[:, 3] + _AXIS_OFF
    if np.any((x | y | z) >> _AXIS_BITS):
        raise ValueError("coordinate exceeds 18-bit packing range")
    return (((c[:, 0] << _AXIS_BITS | x) << _AXIS_BITS | y) << _AXIS_BITS) | z


def kernel_offsets(kernel_size: int, stride_lattice: int, ndim: int = 3) -> np.ndarray:
    """(K, ndim) int64 offsets on the INPUT level's lattice, x-fastest. Odd
    kernels are centered; even kernels cover ``{0..k-1} * s``."""
    if kernel_size % 2 == 1:
        r = kernel_size // 2
        axis = np.arange(-r, r + 1) * stride_lattice
    else:
        axis = np.arange(kernel_size) * stride_lattice
    grids = np.meshgrid(*([axis] * ndim), indexing="ij")
    # 'ij' flattens with the LAST axis fastest: reverse the columns so x
    # (the first coordinate) varies fastest
    offs = np.stack([g.reshape(-1) for g in grids], axis=-1)[:, ::-1]
    return offs.astype(np.int64)


def build_nbr_table(in_coords: np.ndarray, out_coords: np.ndarray,
                    offsets: np.ndarray, in_valid: Optional[int] = None,
                    out_valid: Optional[int] = None,
                    native: bool = True) -> np.ndarray:
    """Gather-form neighbor table (N_out, K) int32; -1 = missing neighbor.

    Rows >= out_valid (padding) get all -1. Input rows >= in_valid are never
    matched."""
    n_in = len(in_coords) if in_valid is None else in_valid
    n_out = len(out_coords) if out_valid is None else out_valid
    K = len(offsets)
    nbr = np.full((len(out_coords), K), -1, np.int32)
    if native:
        in_c = np.ascontiguousarray(in_coords, np.int32)
        out_c = np.ascontiguousarray(out_coords, np.int32)
        offs = np.ascontiguousarray(offsets, np.int32)
        rc = _native("build_nbr_table_native")(
            _ptr(in_c), int(n_in), _ptr(out_c), int(n_out), _ptr(offs), K,
            _ptr(nbr), len(out_c))
        if rc != 0:
            raise MemoryError("build_nbr_table_native could not allocate its "
                              "hash table")
        return nbr
    keys_in = pack_coords(in_coords[:n_in])
    order = np.argsort(keys_in, kind="stable")
    sorted_keys = keys_in[order]
    if not len(sorted_keys):
        return nbr
    oc = out_coords[:n_out].astype(np.int64)
    for k in range(K):
        q = oc.copy()
        q[:, 1:] += offsets[k]
        qk = pack_coords(q)
        pos = np.minimum(np.searchsorted(sorted_keys, qk), len(sorted_keys) - 1)
        hit = sorted_keys[pos] == qk
        nbr[:n_out, k] = np.where(hit, order[pos].astype(np.int32), -1)
    return nbr


def downsample_coords(coords: np.ndarray, out_stride: int,
                      n_valid: Optional[int] = None,
                      native: bool = True) -> np.ndarray:
    """Coarse coordinate set: unique(floor(c / out_stride) * out_stride),
    sorted by packed key, int32. Batch column preserved."""
    n = len(coords) if n_valid is None else n_valid
    if native:
        c = np.ascontiguousarray(coords[:n], np.int32)
        out = np.empty_like(c)
        m = _native("downsample_coords_native")(_ptr(c), int(n),
                                                int(out_stride), _ptr(out))
        if m < 0:
            raise MemoryError("downsample_coords_native could not allocate "
                              "its hash table")
        got = out[:m]
        return got[np.argsort(pack_coords(got), kind="stable")]
    down = coords[:n].astype(np.int64)
    down[:, 1:] = (down[:, 1:] // out_stride) * out_stride
    _, idx = np.unique(pack_coords(down), return_index=True)
    return down[idx].astype(np.int32)


def pad_rows(arr: np.ndarray, capacity: int, fill) -> np.ndarray:
    if len(arr) > capacity:
        raise ValueError(f"{len(arr)} rows exceed capacity {capacity}")
    if len(arr) == capacity:
        return arr
    pad = np.full((capacity - len(arr),) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _pad_coords(coords: np.ndarray, capacity: int) -> np.ndarray:
    """Pad coordinates with unique far-away voxels that match no query."""
    n = len(coords)
    if n > capacity:
        raise ValueError(f"{n} coords exceed capacity {capacity}")
    if n == capacity:
        return coords
    pad = np.zeros((capacity - n, coords.shape[1]), coords.dtype)
    pad[:, 0] = coords[:, 0].max() + 1 if n else 0
    # spread in x so padded rows don't collide with each other either
    pad[:, 1] = (_AXIS_OFF - 8) - np.arange(capacity - n) * 8
    pad[:, 2] = _AXIS_OFF - 16
    pad[:, 3] = _AXIS_OFF - 16
    return np.concatenate([coords, pad], axis=0)


@dataclass
class PyramidSpec:
    """Static configuration of a UNet coordinate pyramid."""

    num_levels: int = 5
    stem_kernel: int = 5
    conv_kernel: int = 3
    down_kernel: int = 2
    # capacity per level; None = derive from the data
    capacities: Optional[Sequence[int]] = None
    # with capacities=None: round each level's row count up to a multiple of
    # this (1 = exact shapes)
    cap_multiple: int = 1


@dataclass
class PyramidArrays:
    """Host-side pyramid: everything the sparse UNet forward needs, as NumPy
    arrays padded to static shapes."""

    coords: List[np.ndarray]          # per level (cap_i, 4) int32
    nvalid: List[int]                 # per level true row counts
    nbr_stem: np.ndarray              # (cap_0, stem_kernel**3)
    nbr_conv: List[np.ndarray]        # per level (cap_i, conv_kernel**3)
    nbr_down: List[np.ndarray]        # L_i -> L_{i+1} (cap_{i+1}, 8)
    nbr_up: List[np.ndarray]          # L_{i+1} -> L_i (cap_i, 8)

    def tables(self) -> List[np.ndarray]:
        """Every neighbor table, in :meth:`to`'s order."""
        return [self.nbr_stem, *self.nbr_conv, *self.nbr_down, *self.nbr_up]

    def table_bytes(self) -> int:
        return sum(t.nbytes for t in self.tables())

    def to(self, device, extra: Sequence[np.ndarray] = ()):
        """The tables as int32 tensors on ``device``: the dict the sparse
        UNet takes (``models/minkunet.py``; the counterpart of the JAX
        package's ``as_jax_inputs``), with ``nvalid`` as host ints. Every
        table, and each float32 or int32 array of ``extra``, goes in ONE
        copy from one pinned host buffer (non-blocking on the card); the
        second value is ``extra`` on the device, in its order."""
        device = torch.device(device)
        arrays = self.tables() + list(extra)
        for a in arrays:
            if a.dtype not in (np.int32, np.float32):
                raise TypeError(f"{a.dtype} array: the upload takes int32 "
                                "and float32 only")
        sizes = [a.size for a in arrays]
        host = torch.empty(sum(sizes), dtype=torch.int32,
                           pin_memory=device.type == "cuda")
        flat = host.numpy()
        o = 0
        for a, n in zip(arrays, sizes):
            flat[o:o + n] = np.ascontiguousarray(a).reshape(-1).view(np.int32)
            o += n
        dev = host.to(device, non_blocking=True)
        out, o = [], 0
        for a, n in zip(arrays, sizes):
            t = dev[o:o + n].view(a.shape)
            out.append(t.view(torch.float32) if a.dtype == np.float32 else t)
            o += n
        L = len(self.nbr_conv)
        tabs = {"nbr_stem": out[0], "nbr_conv": tuple(out[1:1 + L]),
                "nbr_down": tuple(out[1 + L:2 * L]),
                "nbr_up": tuple(out[2 * L:3 * L - 1]),
                "nvalid": tuple(int(v) for v in self.nvalid)}
        return tabs, out[3 * L - 1:]


def build_pyramid(coords0: np.ndarray, spec: PyramidSpec = PyramidSpec(),
                  native: bool = True) -> PyramidArrays:
    """The coordinate pyramid and neighbor tables of one batch.

    ``coords0``: (N, 4) int32 batched voxel coords [b, x, y, z] at stride 1
    (``ops/voxelize.py:batched_coordinates``). ``native=False`` runs the
    NumPy path."""
    L = spec.num_levels
    caps = spec.capacities
    coords: List[np.ndarray] = []
    nvalid: List[int] = []

    cur = coords0.astype(np.int32)
    for lvl in range(L):
        n = len(cur)
        if caps is not None:
            cap = caps[lvl]
        else:
            m = max(spec.cap_multiple, 1)
            cap = int(np.ceil(max(n, 1) / m) * m)
        coords.append(_pad_coords(cur, cap))
        nvalid.append(n)
        if lvl + 1 < L:
            cur = downsample_coords(cur, 1 << (lvl + 1), native=native)

    def table(lin, lout, offs):
        return build_nbr_table(coords[lin], coords[lout], offs,
                               in_valid=nvalid[lin], out_valid=nvalid[lout],
                               native=native)

    nbr_conv = [table(lvl, lvl, kernel_offsets(spec.conv_kernel, 1 << lvl))
                for lvl in range(L)]
    nbr_stem = table(0, 0, kernel_offsets(spec.stem_kernel, 1))
    nbr_down, nbr_up = [], []
    for lvl in range(L - 1):
        offs = kernel_offsets(spec.down_kernel, 1 << lvl)
        nbr_down.append(table(lvl, lvl + 1, offs))
        # transposed conv: fine = coarse + off, so coarse = fine - off; only
        # the offset whose coarse cell is on the 2s lattice can hit
        nbr_up.append(table(lvl + 1, lvl, -offs))
    return PyramidArrays(coords=coords, nvalid=nvalid, nbr_stem=nbr_stem,
                         nbr_conv=nbr_conv, nbr_down=nbr_down, nbr_up=nbr_up)

