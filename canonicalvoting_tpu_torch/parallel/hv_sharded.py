"""Point-sharded canonical Hough voting.

Counterpart of ``canonicalvoting_tpu/parallel/hv_sharded.py``. Votes are
additive, so a scene whose points exceed one device's budget shards its
points over the ranks of a mesh: each rank splats its block of rows into a
full local grid and one all-reduce sums the grids.

The JAX package sums each shard's normalized grids after un-normalizing
them (``hv_sharded.py:55-67``); here the ranks reduce the splat's raw sums
and normalize once, which is the same function. On the card the sums
reduced are the vote kernel's int64 fixed point (``ops/hv_splat.py``:
``hv_splat6_sums``), whose integer sums do not depend on their order: the
sharded grids are bit for bit the single-device ``hough_voting``'s. On the
CPU the plain version's float64 sums are reduced and then rounded to
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from canonicalvoting_tpu_torch.ops.hough_voting import (
    clipped_grid_dims, normalized_grids)
from canonicalvoting_tpu_torch.ops.hv_splat import hv_splat6_sums, sums_to_float
from canonicalvoting_tpu_torch.parallel.mesh import Mesh, make_mesh


def hough_voting_sharded(points, xyz, scale, obj, corners, *, res: float,
                         num_rots: int, grid_shape: Tuple[int, int, int],
                         mesh: Optional[Mesh] = None, device=None,
                         valid: Optional[torch.Tensor] = None):
    """``ops.hough_voting.hough_voting`` with the points sharded over the
    mesh's ``data`` ranks: (grid_obj, grid_rot, grid_scale) on every rank,
    on its device.

    Every rank is given the whole (N, ...) arrays (tensors or numpy, on any
    device) and moves only its block to its device: rank r holds rows
    ``[r * N / D, (r + 1) * N / D)``, as the JAX package's ``P(axis)``
    shards them. N must divide by D (pad, and mask with ``valid``), and
    ``corners`` must be explicit (2, 3): the bounding box cannot be
    derived from one block. The mesh (default: every rank of the default
    group, on ``device``, as :func:`parallel.mesh.make_mesh` takes it)
    must have a ``model`` axis of 1."""
    mesh = mesh or make_mesh(data=dist.get_world_size(), device=device)
    if mesh.model != 1:
        raise ValueError("points shard over the data axis; the mesh's model "
                         f"axis must be 1, got {mesh.model}")
    n, d = len(points), mesh.data
    if n % d:
        raise ValueError(f"{n} points do not divide over {d} ranks: pad them "
                         "and mask the padding with valid")
    corners = torch.as_tensor(corners).to(mesh.device, torch.float32)
    if tuple(corners.shape) != (2, 3):
        raise ValueError(f"corners must be explicit (2, 3), got "
                         f"{tuple(corners.shape)}")
    lo, hi = mesh.rank * n // d, (mesh.rank + 1) * n // d

    def block(t):
        return torch.as_tensor(t)[lo:hi].to(mesh.device, torch.float32)

    p, x, s, o = (block(t) for t in (points, xyz, scale, obj))
    v = None if valid is None else block(valid)
    dims = clipped_grid_dims(corners, res, grid_shape)
    sums = hv_splat6_sums(p, x, s, o, corners[0], dims, res,
                          num_rots=num_rots, grid_shape=tuple(grid_shape),
                          valid=v)
    dist.all_reduce(sums, group=mesh.group)
    return normalized_grids(sums_to_float(sums))
