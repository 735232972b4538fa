"""Point-cloud voxelization (host-side NumPy).

The port's copy of ``canonicalvoting_tpu/ops/voxelize.py`` (the replacement
for ``ME.utils.sparse_quantize`` / ``ME.utils.batched_coordinates``). It keeps
only the NumPy path: coordinates are ``floor(p / res)`` computed in float32,
which is what the JAX package's C helper computes, so both packages return
identical arrays.

Deterministic: each occupied voxel keeps its FIRST point in input order, and
output voxels are sorted lexicographically by (x, y, z).
"""

from __future__ import annotations

import numpy as np


def quantize_keys(coords: np.ndarray) -> np.ndarray:
    """Pack integer (N, 3) voxel coords into int64 keys."""
    coords = coords.astype(np.int64)
    shifted = coords - coords.min(0)
    if np.any(shifted.max(0) >= (1 << 21)):
        raise ValueError("voxel grid exceeds 2^21 per axis")
    return (shifted[:, 0] << 42) | (shifted[:, 1] << 21) | shifted[:, 2]


def sparse_quantize(points: np.ndarray, quantization_size: float = 1.0,
                    return_index: bool = True):
    """(coords (M, 3) int32, index (M,)) of the unique voxels of ``points``.

    ``index`` selects, for each voxel, the first point that landed in it.
    """
    p = np.ascontiguousarray(np.asarray(points)[:, :3], np.float32)
    vox = np.floor(p / np.float32(quantization_size)).astype(np.int64)
    keys = quantize_keys(vox)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    first_of_group = np.ones(len(keys), dtype=bool)
    first_of_group[1:] = sorted_keys[1:] != sorted_keys[:-1]
    index = order[first_of_group]
    coords = vox[index].astype(np.int32)
    if return_index:
        return coords, index
    return coords


def batched_coordinates(coords_list) -> np.ndarray:
    """Prepend batch indices and concatenate: [(Ni, 3)] -> (sum Ni, 4) int32."""
    out = []
    for b, c in enumerate(coords_list):
        c = np.asarray(c)
        bcol = np.full((c.shape[0], 1), b, dtype=np.int32)
        out.append(np.concatenate([bcol, c.astype(np.int32)], axis=1))
    return np.concatenate(out, axis=0)
