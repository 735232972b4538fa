"""Scatter -> dense conv -> gather: the scatter-dense conv engine.

The port's counterpart of ``canonicalvoting_tpu/ops/scatter_conv.py``. The
gather-form sparse conv (``ops/sparse_conv.py``) reads K source rows for
every output row (the k=5 stem: 125 rows a row). This engine keeps the
activations as point rows between layers but runs a conv site densely:

    grid = scatter(rows, the level's flat cell ids)     # zeros elsewhere
    grid = conv3d(grid, W)                               # sub / down / up
    rows_out = grid[the output level's flat cell ids]

The outputs are the gather form's: a missing neighbor reads the grid's
zeros, and only the gathered output cells are kept. The JAX package runs
the dense conv with ``lax.conv_general_dilated``, outside any Pallas
kernel; the port runs ``torch.nn.functional.conv3d`` (cuDNN on the card,
channels-last), and the up, the JAX package's dilated conv with the
flipped kernel, as ``conv_transpose3d`` with the kernel as it is (the same
sums: ``out[2p + d] += W[d] @ in[p]``). The product is in the compute dtype
(bfloat16 products with float32 sums, a bfloat16 grid out, as JAX's
``preferred_element_type``); the gathered rows are float32. Float32 convs
take no TF32 on the card (``train/steps.py:exact_float32_convs``).

Only the scatter is checkpointed, as the JAX package's ``jax.checkpoint``
around it intends: the conv's backward needs its input grid, and the
backward scatters it again from the rows instead of keeping it from the
forward (a ``saved_tensors_hooks`` pair around the conv: the grid it saves
is kept as the rows it was scattered from). The k=5 stem with three input
channels runs folded (``kind="stem_fold"``, JAX ``_stem_fold_conv``): the
channels are scattered as scalar grids, the 25 (dy, dz) taps x 3 channels
folded into 75 columns by shifted slices, and the conv is 5 dx-shifted row
gathers and products; nothing it records for the backward holds a grid.
The JAX package pads those 75 columns to 128 TPU lanes; the port does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from canonicalvoting_tpu_torch.ops.sparse_conv import CastMatmul, compute_dtype_of


@dataclass(frozen=True)
class DensePlan:
    """One conv site of the engine: ``kind`` "sub" (stride 1, odd ``k``),
    "stem_fold" (the folded stem), "down" (k=2, stride 2) or "up" (k=2,
    transposed); ``grid_shape`` the INPUT level's (B, X, Y, Z); ``flat_in``
    / ``flat_out`` (rows,) int32 cell ids into the stacked B * cells space
    of the input and output levels, -1 for padding rows."""

    flat_in: torch.Tensor
    flat_out: torch.Tensor
    kind: str = "sub"
    k: int = 3
    grid_shape: Tuple[int, int, int, int] = ()

    @property
    def shape(self):
        # as a neighbor table's: (rows, taps)
        return (0, self.k ** 3)


def scatter_to_grid(rows: torch.Tensor, flat: torch.Tensor,
                    grid_shape) -> torch.Tensor:
    """(N, C) rows -> (B, X, Y, Z, C) grid, zeros elsewhere; rows whose id
    is -1 are dropped."""
    B, X, Y, Z = grid_shape
    n_cells = B * X * Y * Z
    idx = torch.where(flat >= 0, flat.long(), n_cells)  # -1: a dropped row
    g = rows.new_zeros(n_cells + 1, rows.shape[1]).index_copy(0, idx, rows)
    return g[:n_cells].view(B, X, Y, Z, rows.shape[1])


def gather_rows(grid: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) grid -> (N, C) rows at ``flat`` (0 where -1)."""
    C = grid.shape[-1]
    n_cells = grid.numel() // C
    rows = grid.reshape(n_cells, C).index_select(
        0, flat.long().clamp(0, n_cells - 1))
    return torch.where((flat >= 0)[:, None], rows, rows.new_zeros(()))


def _grid_kernel(w: torch.Tensor, k: int, transposed: bool) -> torch.Tensor:
    """(K, Cin, Cout) with x-fastest offsets -> conv3d's (Cout, Cin, kx,
    ky, kz), or conv_transpose3d's (Cin, Cout, kx, ky, kz)."""
    w5 = w.reshape(k, k, k, w.shape[1], w.shape[2])  # (iz, iy, ix, ci, co)
    return w5.permute(3, 4, 2, 1, 0) if transposed else w5.permute(4, 3, 2, 1, 0)


def _conv_scattered(rows, plan: DensePlan, dt, conv) -> torch.Tensor:
    """``conv`` (NCXYZ -> NCXYZ) of the grid scattered from ``rows``, as a
    channels-last (B, X', Y', Z', Cout) grid. The grid the conv saves for
    its backward is kept as ``rows`` and scattered again there."""
    grid = scatter_to_grid(rows.to(dt), plan.flat_in, plan.grid_shape)
    ptr, size = grid.data_ptr(), grid.numel()

    def pack(t):
        if t.data_ptr() == ptr and t.numel() == size:
            return (t.shape, t.stride())
        return t

    def unpack(p):
        if isinstance(p, tuple):
            with torch.no_grad():
                g = scatter_to_grid(rows.detach().to(dt), plan.flat_in,
                                    plan.grid_shape)
            return g.as_strided(*p)
        return p

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        out = conv(grid.permute(0, 4, 1, 2, 3))
    return out.permute(0, 2, 3, 4, 1)


def _stem_fold_conv(rows, w, bias, plan: DensePlan, dt) -> torch.Tensor:
    """The k=5 stem over the folded scalar grids (JAX ``_stem_fold_conv``)."""
    k, cin, cout = plan.k, w.shape[1], w.shape[2]
    h = k // 2
    B, X, Y, Z = plan.grid_shape
    g = scatter_to_grid(rows.to(dt), plan.flat_in, plan.grid_shape)
    g = F.pad(g, (0, 0, h, h, h, h, h, h))  # (B, X + 2h, Y + 2h, Z + 2h, cin)
    # lanes in (c, dz, dy) order
    xf = torch.stack([g[:, :, dy:dy + Y, dz:dz + Z, c] for c in range(cin)
                      for dz in range(k) for dy in range(k)], -1)
    xf = xf.reshape(-1, k * k * cin)  # (B * (X + 2h) * Y * Z, lanes)
    flat = plan.flat_out.long()
    ok = flat >= 0
    safe = torch.where(ok, flat, 0)
    n_cells = X * Y * Z
    b, r = safe // n_cells, safe % n_cells
    base = b * ((X + 2 * h) * Y * Z) + (r // (Y * Z)) * (Y * Z) + r % (Y * Z)
    # weight rows per dx in the fold's lane order
    wdx = w.reshape(k, k, k, cin, cout).permute(2, 3, 0, 1, 4).reshape(
        k, k * k * cin, cout).to(dt)
    out = None
    for dx in range(k):
        part = CastMatmul.apply(xf.index_select(0, base + dx * (Y * Z)), wdx[dx])
        out = part if out is None else out + part
    out = torch.where(ok[:, None], out, out.new_zeros(()))
    return out if bias is None else out + bias


def scatter_dense_conv(rows: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor], plan: DensePlan,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """One conv site through the dense grid: ``rows`` (N_in, Cin) ->
    (N_out, Cout) float32, ``w`` (K, Cin, Cout), optional ``bias``."""
    k, dt = plan.k, compute_dtype_of(compute_dtype)
    if plan.kind == "stem_fold":
        return _stem_fold_conv(rows, w, bias, plan, dt)
    if plan.kind == "sub":
        wk = _grid_kernel(w, k, False).to(dt)
        out = _conv_scattered(rows, plan, dt,
                              lambda x: F.conv3d(x, wk, padding=k // 2))
    elif plan.kind == "down":
        assert k == 2
        wk = _grid_kernel(w, k, False).to(dt)
        out = _conv_scattered(rows, plan, dt, lambda x: F.conv3d(x, wk, stride=2))
    elif plan.kind == "up":
        assert k == 2
        wk = _grid_kernel(w, k, True).to(dt)
        out = _conv_scattered(rows, plan, dt,
                              lambda x: F.conv_transpose3d(x, wk, stride=2))
    else:
        raise ValueError(f"unknown dense plan kind {plan.kind!r}")
    rows_out = gather_rows(out, plan.flat_out).float()
    return rows_out if bias is None else rows_out + bias
