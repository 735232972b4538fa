"""Dense-execution MinkUNet, inference forward on the occupied-tile kernels.

Counterpart of ``canonicalvoting_tpu/models/dense_unet.py:DenseMinkUNet``
with ``conv_impl="tiled"`` in eval mode. Submanifold sparse convolution is a
dense convolution whose outputs are masked by the level's occupancy; every
conv of the U-Net runs through ``ops/tiled_conv.py`` on the occupied tiles
only, with BatchNorm folded into the kernels' epilogues.

The k=5 stem runs through ``tiled_conv3d`` over the 3-channel grid
(``stem_impl="tiled"``), or through ``tiled_conv3d_prefolded`` over the
grid's (dy, dz) fold (``stem_impl="prefold"``, the separate evaluator's
default), its kernel folded K-major by the caller once per set of weights
(:meth:`DenseMinkUNet.fold_stem`, passed as ``forward(..., stem_wt=)``) or
else by the wrapper on each call; the four down convs' kernels are laid out
K-major the same way (:meth:`DenseMinkUNet.fold_downs`, ``forward(...,
down_wt=)``). The
decoder's up-convs into L0 and L1 run ``tiled_up2`` with the
skip concat fused in (``up_impl="concat"``), or ``tiled_up2_into`` into a
grid that holds the skip (``up_impl="into"``, the JAX package's
``CV_UP2V2=1`` route, ``models/dense_unet.py:503-525``, ``:950-980``); its
layout is ``[skip | conv]``, so the level's first block permutes the input
rows of its conv1 and downsample kernels at use time, and the stored
parameters keep the reference layout. :func:`shared_scene_grids` builds
the weight-independent grids of a scene once, so several models over one
scene share them (``forward(..., shared=)``).

:meth:`DenseMinkUNet.train_forward` is the training route, the JAX
package's ``conv_impl="xla"`` branch (``models/dense_unet.py:196``,
``:270-310``), which runs outside any Pallas kernel there: masked dense
convolutions over the batched margined grids (``F.conv3d`` for the
stride-1 and the stride-2 convs, ``F.conv_transpose3d`` for the ups;
library calls, not ports of a TPU kernel), each output masked by its
level's occupancy and normalized by the train-mode ``DenseBatchNorm``
(:class:`MaskedGridNorm`: float32 sums over the occupied cells, re-masked
output), for ``n_scenes`` scenes stacked on a leading axis. With ``remat``
each residual block is recomputed in the backward (``models/norm.py:
remat``). Its gradients flow into the same parameters as the inference
route's, so a model trained here runs on the kernels as it is.

Parameter and buffer names follow the JAX parameter tree (``conv0p1s1.kernel``,
``block1_0.conv1.kernel``, ``bn0.scale``, ``bn0.mean``, ``bntr4.var``,
``final.bias``, ...), so ``utils/weights.py`` copies a JAX variables tree in
without renaming. Kernels are (K, Cin, Cout) with x-fastest offsets.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from canonicalvoting_tpu_torch.data.dense_prep import (
    CONV_KEY_OFF, MX, MY, MZ, STEM_KEY, TRANS_KEYS)
from canonicalvoting_tpu_torch.models.norm import remat, running_updates
from canonicalvoting_tpu_torch.ops.tiled_conv import (
    UP_INTO_MAX_CHANNELS, down2_weights, fold_dydz, prefold_stem_weights,
    tiled_conv3d, tiled_conv3d_prefolded, tiled_down2, tiled_up2,
    tiled_up2_into)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STEM_IMPLS = ("tiled", "prefold")
UP_IMPLS = ("concat", "into")
# the four down convs' kernels, into L1 to L4
DOWN_KERNELS = tuple(f"conv{i + 1}p{1 << i}s2.kernel" for i in range(4))
# the levels whose up-conv runs tiled_up2_into on up_impl="into" (the JAX
# package's v2_keys, dense_unet.py:510)
INTO_LEVELS = (0, 1)


def default_up_impl() -> str:
    """"into" when CV_UP2V2 is set, as the JAX package decides
    (``models/dense_unet.py:509``), else "concat"."""
    return "into" if os.environ.get("CV_UP2V2") else "concat"


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

    def grid(self, y: torch.Tensor, occ: torch.Tensor,
             momentum: float) -> torch.Tensor:
        """The JAX package's train-mode ``DenseBatchNorm`` over a
        channel-last grid ``y`` (conv output, in the compute dtype) after
        the conv's mask: ``occ * ((y * occ - mean) * inv * scale + bias)``
        with the batch statistics over the occupied cells
        (:class:`MaskedGridNorm`)."""
        return MaskedGridNorm.apply(y, occ, self.scale, self.bias, self,
                                    momentum)


class MaskedGridNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the occupied cells of a dense grid (JAX
    ``models/dense_unet.py:75-131``), fused with the conv's mask that
    precedes it: x = y * occ in y's dtype; n = max(sum occ, 1); mean and
    the biased variance from float32 sums over the occupied cells; out =
    occ * ((x - mean) * rsqrt(var + eps) * scale + bias) in y's dtype; the
    running statistics take the mean and the unbiased variance with the
    step's momentum (not inside :func:`frozen_running_stats`). It saves y
    alone of the grids, and its backward is BatchNorm's over the occupied
    cells, zero elsewhere: the autograd of the formula would keep several
    float32 grids a norm."""

    @staticmethod
    def forward(ctx, y, occ, scale, bias, norm, momentum):
        o = occ[..., None]
        xf = (y * o.to(y.dtype)).float()  # a fresh grid: updated in place
        axes = tuple(range(y.dim() - 1))
        n = torch.clamp_min(occ.sum(), 1.0)
        mean = xf.sum(axes) / n
        var = torch.clamp_min((xf * xf).sum(axes) / n - mean * mean, 0.0)
        if running_updates():
            unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
            norm.mean.mul_(1.0 - momentum).add_(momentum * mean)
            norm.var.mul_(1.0 - momentum).add_(momentum * unbiased)
        inv = torch.rsqrt(var + norm.eps)
        # o is 0 or 1: (t + bias) * o equals JAX's t * o + bias * o
        out = xf.sub_(mean).mul_(inv).mul_(scale).add_(bias).mul_(o)
        ctx.save_for_backward(y, occ, mean, inv, scale, n)
        return out.to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        y, occ, mean, inv, scale, n = ctx.saved_tensors
        o = occ[..., None]
        axes = tuple(range(y.dim() - 1))
        g = grad.float() * o  # not in place: grad may be float32 already
        xhat = (y * o.to(y.dtype)).float().sub_(mean).mul_(inv)
        d_bias = g.sum(axes)
        d_scale = (g * xhat).sum(axes)
        dx = xhat.mul_(-d_scale / n).add_(g).sub_(d_bias / n)
        dx = dx.mul_(inv * scale).mul_(o)
        return dx.to(y.dtype), None, d_scale, d_bias, None, None


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

    def forward(self, x, occ, tiles, tile_shape, in_perm=None):
        """``in_perm`` reorders the input rows of conv1 and the downsample
        kernel for an input laid out otherwise than the reference (input
        channel j is reference channel ``in_perm[j]``)."""
        a1, b1 = self.norm1.affine()
        a2, b2 = self.norm2.affine()
        w1 = self.conv1.kernel
        if in_perm is not None:
            w1 = w1[:, in_perm]
        out = tiled_conv3d(x, w1, tiles, tile_shape=tile_shape,
                           kernel_size=3, scale=a1, bias=b1, occ=occ,
                           relu_out=True)
        rw = rs = rb = None
        if self.downsample:
            rw = self.downsample_conv.kernel[0]
            if in_perm is not None:
                rw = rw[in_perm]
            rs, rb = self.downsample_norm.affine()
        return tiled_conv3d(out, self.conv2.kernel, tiles, tile_shape=tile_shape,
                            kernel_size=3, scale=a2, bias=b2, occ=occ,
                            residual=x, res_w=rw, res_scale=rs, res_bias=rb,
                            relu_out=True)

    def dense(self, x, occ, momentum: float, dt):
        """The JAX ``DenseBasicBlock``'s XLA route in train mode over
        batched grids: ``relu(bn2(conv2 relu(bn1(conv1 x))) + res)``, each
        conv masked by occ before its norm; res = x or ``bn(x @ W)``."""
        out = self.norm1.grid(dense_conv(x, self.conv1.kernel, 3, dt), occ,
                              momentum)
        out = self.norm2.grid(dense_conv(torch.relu(out), self.conv2.kernel,
                                         3, dt), occ, momentum)
        res = x
        if self.downsample:
            res = self.downsample_norm.grid(
                torch.matmul(x, self.downsample_conv.kernel[0].to(dt)), occ,
                momentum)
        return torch.relu(out + res)


def dense_kernel(w: torch.Tensor, k: int, dt, transpose: bool = False):
    """A (k^3, Cin, Cout) kernel with x-fastest offsets as a torch conv
    weight over (B, C, X, Y, Z) grids, in ``dt``: (Cout, Cin, kx, ky, kz),
    or (Cin, Cout, kx, ky, kz) for ``conv_transpose3d`` (JAX
    ``_to_dense_kernel``: offset ``ix + k*iy + k*k*iz``)."""
    w = w.reshape(k, k, k, w.shape[1], w.shape[2])  # (iz, iy, ix, ci, co)
    return w.permute(*((3, 4) if transpose else (4, 3)), 2, 1, 0).to(dt)


def dense_conv(x: torch.Tensor, w: torch.Tensor, k: int, dt, *,
               stride: int = 1, transpose: bool = False) -> torch.Tensor:
    """A dense conv of a (B, Xm, Ym, Zm, C) margined grid in ``dt``, as
    the JAX package's XLA convs map margined grids to margined grids:
    stride 1 pads k // 2; the stride-2 k=2 down pads the margins (coarse
    interior o reads fine cells 2o + d); the k=2 transposed up crops them
    (fine cell 2p + d receives coarse p through W[d]). The grid is viewed
    channels-first over its channel-last storage (channels_last_3d), and
    the output viewed back."""
    xs = x.to(dt).permute(0, 4, 1, 2, 3)
    if transpose:
        out = F.conv_transpose3d(xs, dense_kernel(w, k, dt, True), stride=2,
                                 padding=(MX, MY, MZ))
    elif stride == 2:
        out = F.conv3d(xs, dense_kernel(w, k, dt), stride=2,
                       padding=(MX, MY, MZ))
    else:
        out = F.conv3d(xs, dense_kernel(w, k, dt), padding=k // 2)
    return out.permute(0, 2, 3, 4, 1)


def into_dest(skip: torch.Tensor, skip_c: int, cout: int) -> torch.Tensor:
    """tiled_up2_into's dest: a fresh grid of skip_c + cout channels holding
    the skip in [0, skip_c) and zeros after. This copy is the concat that
    the JAX kernel avoids by writing into the skip producer's own donated
    buffer."""
    dest = skip.new_zeros(skip.shape[:3] + (skip_c + cout,))
    dest[..., :skip_c] = skip[..., :skip_c]
    return dest


def occupancy_pyramid(occ0: torch.Tensor, levels: int = 5) -> List[torch.Tensor]:
    """Margined occupancy per level: 2x2x2 max-pool of the interior."""
    occ = [occ0]
    for _ in range(levels - 1):
        o = occ[-1][MX:-MX, MY:-MY, MZ:-MZ]
        o = F.max_pool3d(o[None, None], 2)[0, 0]
        occ.append(F.pad(o, (MZ, MZ, MY, MY, MX, MX)))
    return occ


@torch.no_grad()
def shared_scene_grids(feats: torch.Tensor, flat_idx: torch.Tensor,
                       valid: torch.Tensor, grid_dims: Tuple[int, int, int], *,
                       in_channels: int, stem_kernel: int = 5,
                       compute_dtype: str = "bfloat16",
                       stem_impl: str = "tiled") -> Dict[str, object]:
    """The grids of a scene that no weight touches: ``x`` the margined
    (Xm, Ym, Zm, Cin) scatter of the point rows, ``occ`` the occupancy
    pyramid and, for ``stem_impl="prefold"``, ``x_folded`` its (dy, dz)
    fold. Counterpart of the JAX package's ``shared_scene_grids``
    (``models/dense_unet.py:554``): the separate evaluator builds them once
    per scene for its nine models. The JAX package's ``fresh_l0_donors``
    has no counterpart: it lets XLA reuse dead grids as kernel outputs and
    changes no value, and PyTorch's caching allocator reuses the freed grids
    of one model for the next anyway."""
    dt = _DTYPES[compute_dtype]
    gx, gy, gz = grid_dims
    shape = (gx + 2 * MX, gy + 2 * MY, gz + 2 * MZ)
    n_cells = shape[0] * shape[1] * shape[2]
    keep = (valid > 0) & (flat_idx >= 0)
    ids = flat_idx[keep].long()
    x = torch.zeros(n_cells, in_channels, dtype=dt, device=feats.device)
    x[ids] = feats[keep].to(dt)
    occ0 = torch.zeros(n_cells, dtype=torch.float32, device=feats.device)
    occ0[ids] = 1.0
    x = x.view(shape + (in_channels,))
    out = {"x": x, "occ": occupancy_pyramid(occ0.view(shape))}
    if stem_impl == "prefold":
        out["x_folded"] = fold_dydz(x, stem_kernel)
    return out


class DenseMinkUNet(nn.Module):
    """MinkUNet (basic blocks) on margined dense grids.

    ``forward(feats, flat_idx, valid, grid_dims, tiles, tile_shapes)``:
    ``feats`` (N, Cin) point rows, ``flat_idx`` (N,) MARGINED L0 cell ids
    (``data.dense_prep.dense_flat_ids``; -1 when outside), ``valid`` (N,),
    ``grid_dims`` the interior (X, Y, Z), ``tiles`` {key: (T, 3) int32} and
    ``tile_shapes`` {key: tile shape} from ``data.dense_prep.level_tiles``.
    Returns (N, Cout) float32 rows, zero at invalid rows. ``shared`` takes
    the scene's :func:`shared_scene_grids` (built here when not given).
    ``stem_impl`` is "tiled" or "prefold", ``up_impl`` "concat" or "into"
    (None: :func:`default_up_impl`); neither changes a parameter. With
    "prefold", ``stem_wt`` takes the stem's folded weights
    (:meth:`fold_stem`) where the caller keeps them (the separate
    evaluator, once per category); else the wrapper folds the stem kernel
    on each call. ``down_wt`` takes the four down convs' K-major weights
    (:meth:`fold_downs`) the same way.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 init_dim: int = 32, stem_kernel: int = 5,
                 compute_dtype: str = "bfloat16", stem_impl: str = "tiled",
                 up_impl: Optional[str] = None):
        super().__init__()
        self.remat = False  # train_forward's block remat (create_train_state)
        if stem_impl not in STEM_IMPLS:
            raise ValueError(f"stem_impl must be one of {STEM_IMPLS}, got {stem_impl!r}")
        up_impl = default_up_impl() if up_impl is None else up_impl
        if up_impl not in UP_IMPLS:
            raise ValueError(f"up_impl must be one of {UP_IMPLS}, got {up_impl!r}")
        skip_chs = [init_dim] + list(planes[:3])
        if up_impl == "into":
            for lvl in INTO_LEVELS:
                width = planes[7 - lvl] + skip_chs[lvl]
                if width > UP_INTO_MAX_CHANNELS:
                    raise ValueError(
                        f"up_impl='into' writes [skip | conv] into at most "
                        f"{UP_INTO_MAX_CHANNELS} channels, as the JAX kernel "
                        f"does; level {lvl} needs {width} (a grouped net "
                        f"exceeds it): use up_impl='concat'")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.init_dim, self.stem_kernel = init_dim, stem_kernel
        self.compute_dtype, self.stem_impl = compute_dtype, stem_impl
        self.up_impl = up_impl
        self.conv0p1s1 = Conv(in_channels, init_dim, stem_kernel)
        self.bn0 = BatchNorm(init_dim)
        ch = init_dim
        for i in range(4):
            self.add_module(f"conv{i + 1}p{1 << i}s2", Conv(ch, ch, 2))
            self.add_module(f"bn{i + 1}", BatchNorm(ch))
            ch = self._add_blocks(f"block{i + 1}", ch, planes[i], layers[i])
        for d in range(4):
            lvl = 3 - d
            self.add_module(f"convtr{4 + d}p{1 << (lvl + 1)}s2",
                            Conv(ch, planes[4 + d], 2))
            self.add_module(f"bntr{4 + d}", BatchNorm(planes[4 + d]))
            ch = self._add_blocks(f"block{5 + d}", planes[4 + d] + skip_chs[lvl],
                                  planes[4 + d], layers[4 + d])
        self.final = Conv(ch, out_channels, 1, use_bias=True)

    def config(self) -> Dict[str, object]:
        """The constructor's keywords: a twin of this model."""
        return dict(in_channels=self.in_channels,
                    out_channels=self.out_channels, layers=self.layers,
                    planes=self.planes, init_dim=self.init_dim,
                    stem_kernel=self.stem_kernel,
                    compute_dtype=self.compute_dtype, stem_impl=self.stem_impl,
                    up_impl=self.up_impl)

    def _add_blocks(self, name, cin, planes, n) -> int:
        for j in range(n):
            self.add_module(f"{name}_{j}", BasicBlock(cin, planes))
            cin = planes
        return planes

    def fold_stem(self, w: torch.Tensor) -> torch.Tensor:
        """A (k^3, Cin, Cout) stem kernel folded K-major for
        ``tiled_conv3d_prefolded`` (``prefold_stem_weights``), in the compute
        dtype on w's device."""
        return prefold_stem_weights(w.detach(), self.stem_kernel,
                                    dtype=_DTYPES[self.compute_dtype],
                                    device=w.device)

    def fold_downs(self, kernels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The four down convs' (8, Cin, Cout) kernels (``DOWN_KERNELS``'
        order) laid out K-major for ``tiled_down2`` (``down2_weights``), in
        the compute dtype on each kernel's device."""
        return [down2_weights(w.detach(), dtype=_DTYPES[self.compute_dtype],
                              device=w.device) for w in kernels]

    def _blocks(self, name, n, x, occ, tiles, ts, in_perm=None):
        for j in range(n):
            x = getattr(self, f"{name}_{j}")(x, occ, tiles, ts,
                                             in_perm if j == 0 else None)
        return x

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, flat_idx: torch.Tensor,
                valid: torch.Tensor, grid_dims: Tuple[int, int, int],
                tiles: Dict[int, torch.Tensor],
                tile_shapes: Dict[int, Tuple[int, int, int]],
                shared: Optional[Dict[str, object]] = None,
                stem_wt: Optional[torch.Tensor] = None,
                down_wt: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        dt = _DTYPES[self.compute_dtype]
        if shared is None:
            shared = shared_scene_grids(
                feats, flat_idx, valid, grid_dims, in_channels=self.in_channels,
                stem_kernel=self.stem_kernel, compute_dtype=self.compute_dtype,
                stem_impl=self.stem_impl)
        x, occ = shared["x"], shared["occ"]
        n_cells = occ[0].numel()

        def conv_key(lvl):
            return CONV_KEY_OFF + lvl if CONV_KEY_OFF + lvl in tiles else lvl

        a, b = self.bn0.affine()
        stem = dict(tile_shape=tile_shapes[STEM_KEY],
                    kernel_size=self.stem_kernel, scale=a, bias=b, occ=occ[0],
                    relu_out=True)
        if self.stem_impl == "prefold":
            out_p1 = tiled_conv3d_prefolded(
                shared["x_folded"], self.conv0p1s1.kernel, tiles[STEM_KEY],
                wt=stem_wt, **stem)
        else:
            out_p1 = tiled_conv3d(x, self.conv0p1s1.kernel, tiles[STEM_KEY], **stem)
        skips = []
        x = out_p1
        for i in range(4):
            key = TRANS_KEYS.get(("down", i + 1), i + 1)
            a, b = getattr(self, f"bn{i + 1}").affine()
            x = tiled_down2(x, getattr(self, f"conv{i + 1}p{1 << i}s2").kernel,
                            tiles[key], tile_shape=tile_shapes[key], scale=a,
                            bias=b, occ=occ[i + 1], relu_out=True,
                            wt=None if down_wt is None else down_wt[i])
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
            kw = dict(tile_shape=tile_shapes[key], scale=a, bias=b,
                      occ=occ[lvl], relu_out=True)
            skc, cout = skip_chs[lvl], self.planes[4 + d]
            in_perm = None
            if self.up_impl == "into" and lvl in INTO_LEVELS:
                x = tiled_up2_into(x, up.kernel, tiles[key],
                                   dest=into_dest(skip, skc, cout),
                                   skip_c=skc, **kw)
                # input channel j holds skip channel j (j < skc, reference
                # row cout + j) or conv channel j - skc (reference row j - skc)
                in_perm = torch.cat([torch.arange(cout, cout + skc),
                                     torch.arange(cout)]).to(x.device)
            else:
                x = tiled_up2(x, up.kernel, tiles[key], skip=skip, skip_c=skc,
                              **kw)
            ck = conv_key(lvl)
            x = self._blocks(f"block{5 + d}", self.layers[4 + d], x, occ[lvl],
                             tiles[ck], tile_shapes[ck], in_perm)
        # gather the point rows first; the 1x1 head runs on those rows only
        rows = x.reshape(n_cells, x.shape[-1])[flat_idx.long().clamp(0, n_cells - 1)]
        out = (rows @ self.final.kernel[0].to(dt)).float() + self.final.bias
        return torch.where((valid > 0)[:, None], out, torch.zeros_like(out))

    def train_forward(self, feats: torch.Tensor, flat_idx: torch.Tensor,
                      valid: torch.Tensor, grid_dims: Tuple[int, int, int],
                      bn_momentum: float = 0.1,
                      n_scenes: int = 1) -> torch.Tensor:
        """The training route (the JAX package's ``conv_impl="xla"``
        forward, ``apply(..., True, bn_momentum, n_scenes=B)``): the point
        rows scattered into B stacked margined grids (``flat_idx`` carries
        scene s's offset s * n_cells, ``data.dense_prep.
        dense_flat_ids_batched``), masked dense convs, train-mode norms
        that update the running statistics with ``bn_momentum``, the 1x1
        head on the gathered rows. Returns (N, Cout) float32 rows, zero at
        invalid rows. With ``remat`` and autograd on, each residual block
        is recomputed in the backward."""
        dt = _DTYPES[self.compute_dtype]
        dx, dy, dz = grid_dims
        if dx % 16 or dy % 16 or dz % 16:
            raise ValueError(f"grid dims {grid_dims} must be multiples of 16")
        shape = (n_scenes, dx + 2 * MX, dy + 2 * MY, dz + 2 * MZ)
        n_cells = shape[0] * shape[1] * shape[2] * shape[3]
        keep = (valid > 0) & (flat_idx >= 0)
        ids = flat_idx[keep].long()
        x = feats.new_zeros((n_cells, self.in_channels), dtype=dt)
        x = x.index_put((ids,), feats[keep].to(dt)).view(shape + (-1,))
        occ0 = torch.zeros(n_cells, dtype=torch.float32, device=feats.device)
        occ0[ids] = 1.0
        occ = [occ0.view(shape)]
        for _ in range(4):
            o = occ[-1][:, MX:-MX, MY:-MY, MZ:-MZ]
            occ.append(F.pad(F.max_pool3d(o[:, None], 2)[:, 0],
                             (MZ, MZ, MY, MY, MX, MX)))
        mom = bn_momentum
        use_remat = self.remat and torch.is_grad_enabled()

        def blocks(name, n, x, o):
            for j in range(n):
                blk = getattr(self, f"{name}_{j}")
                x = (remat(blk.dense, x, o, mom, dt) if use_remat
                     else blk.dense(x, o, mom, dt))
            return x

        x = dense_conv(x, self.conv0p1s1.kernel, self.stem_kernel, dt)
        out_p1 = torch.relu(self.bn0.grid(x, occ[0], mom))
        skips, x = [], out_p1
        for i in range(4):
            x = dense_conv(x, getattr(self, f"conv{i + 1}p{1 << i}s2").kernel,
                           2, dt, stride=2)
            x = torch.relu(getattr(self, f"bn{i + 1}").grid(x, occ[i + 1], mom))
            x = blocks(f"block{i + 1}", self.layers[i], x, occ[i + 1])
            skips.append(x)
        skip_chs = [self.init_dim] + list(self.planes[:3])
        for d in range(4):
            lvl = 3 - d
            up = getattr(self, f"convtr{4 + d}p{1 << (lvl + 1)}s2")
            x = dense_conv(x, up.kernel, 2, dt, transpose=True)
            x = torch.relu(getattr(self, f"bntr{4 + d}").grid(x, occ[lvl], mom))
            skip = skips[lvl - 1] if lvl >= 1 else out_p1
            x = torch.cat([x, skip[..., :skip_chs[lvl]]], -1)
            x = blocks(f"block{5 + d}", self.layers[4 + d], x, occ[lvl])
        rows = x.reshape(n_cells, x.shape[-1])[flat_idx.long().clamp(0, n_cells - 1)]
        out = (rows @ self.final.kernel[0].to(dt)).float() + self.final.bias
        return torch.where((valid > 0)[:, None], out, torch.zeros_like(out))
