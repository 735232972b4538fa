"""Dense-execution MinkUNet, inference forward on the occupied-tile kernels.

Counterpart of ``canonicalvoting_tpu/models/dense_unet.py:DenseMinkUNet``
with ``conv_impl="tiled"`` in eval mode. Submanifold sparse convolution is a
dense convolution whose outputs are masked by the level's occupancy; every
conv of the U-Net runs through ``ops/tiled_conv.py`` on the occupied tiles
only, with BatchNorm folded into the kernels' epilogues.

Parameter and buffer names follow the JAX parameter tree (``conv0p1s1.kernel``,
``block1_0.conv1.kernel``, ``bn0.scale``, ``bn0.mean``, ``bntr4.var``,
``final.bias``, ...), so ``utils/weights.py`` copies a JAX variables tree in
without renaming. Kernels are (K, Cin, Cout) with x-fastest offsets.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from canonicalvoting_tpu_torch.data.dense_prep import (
    CONV_KEY_OFF, MX, MY, MZ, STEM_KEY, TRANS_KEYS)
from canonicalvoting_tpu_torch.ops.tiled_conv import (
    tiled_conv3d, tiled_down2, tiled_up2)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Conv(nn.Module):
    """A conv's (K, Cin, Cout) kernel (and optional bias); the tiled kernels
    apply it."""

    def __init__(self, cin: int, cout: int, k: int, use_bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k ** 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        nn.init.kaiming_normal_(self.kernel, mode="fan_out")


class BatchNorm(nn.Module):
    """Inference BatchNorm: ``scale``/``bias`` parameters and ``mean``/``var``
    running statistics, folded to a per-channel affine."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        a = torch.rsqrt(self.var + self.eps) * self.scale
        return a, self.bias - self.mean * a


class BasicBlock(nn.Module):
    """Two fused k=3 convs: ``relu(occ * bn1(conv1 x))``, then
    ``relu(occ * bn2(conv2 .) + res)`` with ``res`` = x or the fused 1x1
    downsample ``occ * bn(x @ W)``."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3)
        self.norm1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3)
        self.norm2 = BatchNorm(planes)
        self.downsample = cin != planes
        if self.downsample:
            self.downsample_conv = Conv(cin, planes, 1)
            self.downsample_norm = BatchNorm(planes)

    def forward(self, x, occ, tiles, tile_shape):
        a1, b1 = self.norm1.affine()
        a2, b2 = self.norm2.affine()
        out = tiled_conv3d(x, self.conv1.kernel, tiles, tile_shape=tile_shape,
                           kernel_size=3, scale=a1, bias=b1, occ=occ,
                           relu_out=True)
        rw = rs = rb = None
        if self.downsample:
            rw = self.downsample_conv.kernel[0]
            rs, rb = self.downsample_norm.affine()
        return tiled_conv3d(out, self.conv2.kernel, tiles, tile_shape=tile_shape,
                            kernel_size=3, scale=a2, bias=b2, occ=occ,
                            residual=x, res_w=rw, res_scale=rs, res_bias=rb,
                            relu_out=True)


class DenseMinkUNet(nn.Module):
    """MinkUNet (basic blocks) on margined dense grids.

    ``forward(feats, flat_idx, valid, grid_dims, tiles, tile_shapes)``:
    ``feats`` (N, Cin) point rows, ``flat_idx`` (N,) MARGINED L0 cell ids
    (``data.dense_prep.dense_flat_ids``; -1 when outside), ``valid`` (N,),
    ``grid_dims`` the interior (X, Y, Z), ``tiles`` {key: (T, 3) int32} and
    ``tile_shapes`` {key: tile shape} from ``data.dense_prep.level_tiles``.
    Returns (N, Cout) float32 rows, zero at invalid rows.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 init_dim: int = 32, stem_kernel: int = 5,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.init_dim, self.stem_kernel = init_dim, stem_kernel
        self.compute_dtype = compute_dtype
        self.conv0p1s1 = Conv(in_channels, init_dim, stem_kernel)
        self.bn0 = BatchNorm(init_dim)
        ch = init_dim
        for i in range(4):
            self.add_module(f"conv{i + 1}p{1 << i}s2", Conv(ch, ch, 2))
            self.add_module(f"bn{i + 1}", BatchNorm(ch))
            ch = self._add_blocks(f"block{i + 1}", ch, planes[i], layers[i])
        skip_chs = [init_dim] + list(planes[:3])
        for d in range(4):
            lvl = 3 - d
            self.add_module(f"convtr{4 + d}p{1 << (lvl + 1)}s2",
                            Conv(ch, planes[4 + d], 2))
            self.add_module(f"bntr{4 + d}", BatchNorm(planes[4 + d]))
            ch = self._add_blocks(f"block{5 + d}", planes[4 + d] + skip_chs[lvl],
                                  planes[4 + d], layers[4 + d])
        self.final = Conv(ch, out_channels, 1, use_bias=True)

    def _add_blocks(self, name, cin, planes, n) -> int:
        for j in range(n):
            self.add_module(f"{name}_{j}", BasicBlock(cin, planes))
            cin = planes
        return planes

    def _blocks(self, name, n, x, occ, tiles, ts):
        for j in range(n):
            x = getattr(self, f"{name}_{j}")(x, occ, tiles, ts)
        return x

    @staticmethod
    def occupancy_pyramid(occ0: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
        """Margined occupancy per level: 2x2x2 max-pool of the interior."""
        occ = [occ0]
        for _ in range(levels - 1):
            o = occ[-1][MX:-MX, MY:-MY, MZ:-MZ]
            o = F.max_pool3d(o[None, None], 2)[0, 0]
            occ.append(F.pad(o, (MZ, MZ, MY, MY, MX, MX)))
        return occ

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, flat_idx: torch.Tensor,
                valid: torch.Tensor, grid_dims: Tuple[int, int, int],
                tiles: Dict[int, torch.Tensor],
                tile_shapes: Dict[int, Tuple[int, int, int]]) -> torch.Tensor:
        dt = _DTYPES[self.compute_dtype]
        dev = feats.device
        gx, gy, gz = grid_dims
        shape = (gx + 2 * MX, gy + 2 * MY, gz + 2 * MZ)
        n_cells = shape[0] * shape[1] * shape[2]
        keep = (valid > 0) & (flat_idx >= 0)
        ids = flat_idx[keep].long()
        x = torch.zeros(n_cells, self.in_channels, dtype=dt, device=dev)
        x[ids] = feats[keep].to(dt)
        occ0 = torch.zeros(n_cells, dtype=torch.float32, device=dev)
        occ0[ids] = 1.0
        occ = self.occupancy_pyramid(occ0.view(shape))
        x = x.view(shape + (self.in_channels,))

        def conv_key(lvl):
            return CONV_KEY_OFF + lvl if CONV_KEY_OFF + lvl in tiles else lvl

        a, b = self.bn0.affine()
        out_p1 = tiled_conv3d(x, self.conv0p1s1.kernel, tiles[STEM_KEY],
                              tile_shape=tile_shapes[STEM_KEY],
                              kernel_size=self.stem_kernel, scale=a, bias=b,
                              occ=occ[0], relu_out=True)
        skips = []
        x = out_p1
        for i in range(4):
            key = TRANS_KEYS.get(("down", i + 1), i + 1)
            a, b = getattr(self, f"bn{i + 1}").affine()
            x = tiled_down2(x, getattr(self, f"conv{i + 1}p{1 << i}s2").kernel,
                            tiles[key], tile_shape=tile_shapes[key], scale=a,
                            bias=b, occ=occ[i + 1], relu_out=True)
            ck = conv_key(i + 1)
            x = self._blocks(f"block{i + 1}", self.layers[i], x, occ[i + 1],
                             tiles[ck], tile_shapes[ck])
            skips.append(x)
        skip_chs = [self.init_dim] + list(self.planes[:3])
        for d in range(4):
            lvl = 3 - d
            key = TRANS_KEYS.get(("up", lvl), lvl)
            skip = skips[lvl - 1] if lvl >= 1 else out_p1
            a, b = getattr(self, f"bntr{4 + d}").affine()
            up = getattr(self, f"convtr{4 + d}p{1 << (lvl + 1)}s2")
            x = tiled_up2(x, up.kernel, tiles[key], tile_shape=tile_shapes[key],
                          scale=a, bias=b, occ=occ[lvl], skip=skip,
                          skip_c=skip_chs[lvl], relu_out=True)
            ck = conv_key(lvl)
            x = self._blocks(f"block{5 + d}", self.layers[4 + d], x, occ[lvl],
                             tiles[ck], tile_shapes[ck])
        # gather the point rows first; the 1x1 head runs on those rows only
        rows = x.reshape(n_cells, x.shape[-1])[flat_idx.long().clamp(0, n_cells - 1)]
        out = (rows @ self.final.kernel[0].to(dt)).float() + self.final.bias
        return torch.where((valid > 0)[:, None], out, torch.zeros_like(out))
