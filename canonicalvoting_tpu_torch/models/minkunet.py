"""The MinkUNet family over the gather-form sparse convolution.

The port's counterpart of ``canonicalvoting_tpu/models/minkunet.py``
(upstream ``utils/minkunet.py``): a sparse U-Net with a kernel-5 stem, four
stride-2 down stages with residual-block stacks, four transposed-conv up
stages with skip concats and a 1x1 head, over the host-built coordinate
pyramid (``ops/coords.py``). Every conv is a gather and one GEMM
(``ops/sparse_conv.py``); every transposed conv reads the reversed down
table; a skip connection is a channel concat over the same rows. The
variant zoo (14/18/34/50/101 and A/B/C/D) and ``MinkUNet34CF`` with its five
endpoints are here.

Module names are the JAX tree's (``conv0p1s1``, ``bn0``, ``block1_0``,
``convtr4p16s2``, ``final``, ...), which ``DenseMinkUNet`` shares: one state
dict loads into either model (basic blocks): :func:`sparse_twin` runs a
dense model's weights on the gather-form backbone, :func:`dense_twin` a
sparse model's (a trained one) on the dense backbone.

The forward takes the pyramid's tables on the device (``PyramidArrays.to``):
rows past ``nvalid`` are padding, which no valid row reads; their outputs
are not zero, and callers mask them with the valid rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm
from canonicalvoting_tpu_torch.models.resnet import BLOCKS, SparseConv


class MinkUNetBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 init_dim: int = 32, stem_kernel: int = 5,
                 compute_dtype: str = "bfloat16", return_endpoints: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.block, self.layers, self.planes = block, tuple(layers), tuple(planes)
        self.init_dim, self.stem_kernel = init_dim, stem_kernel
        self.compute_dtype = compute_dtype
        self.return_endpoints = return_endpoints
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        exp = BLOCKS[block].expansion
        self.conv0p1s1 = SparseConv(in_channels, init_dim, stem_kernel ** 3, **kw)
        self.bn0 = MaskedBatchNorm(init_dim)
        ch = init_dim
        for i in range(4):
            self.add_module(f"conv{i + 1}p{1 << i}s2", SparseConv(ch, ch, 8, **kw))
            self.add_module(f"bn{i + 1}", MaskedBatchNorm(ch))
            ch = self._add_blocks(f"block{i + 1}", ch, planes[i], layers[i], kw)
        skip_chs = [init_dim] + [planes[i] * exp for i in range(3)]
        for d in range(4):
            lvl = 3 - d
            self.add_module(f"convtr{4 + d}p{1 << (lvl + 1)}s2",
                            SparseConv(ch, planes[4 + d], 8, **kw))
            self.add_module(f"bntr{4 + d}", MaskedBatchNorm(planes[4 + d]))
            ch = self._add_blocks(f"block{5 + d}", planes[4 + d] + skip_chs[lvl],
                                  planes[4 + d], layers[4 + d], kw)
        self.final = SparseConv(ch, out_channels, 1, use_bias=True, **kw)

    def _add_blocks(self, name, ch, planes, n, kw) -> int:
        blk = BLOCKS[self.block]
        for j in range(n):
            self.add_module(f"{name}_{j}", blk(ch, planes, **kw))
            ch = planes * blk.expansion
        return ch

    def config(self) -> Dict[str, object]:
        """The constructor's keywords: a twin of this model."""
        return dict(in_channels=self.in_channels, out_channels=self.out_channels,
                    block=self.block, layers=self.layers, planes=self.planes,
                    init_dim=self.init_dim, stem_kernel=self.stem_kernel,
                    compute_dtype=self.compute_dtype,
                    return_endpoints=self.return_endpoints)

    def _blocks(self, name, n, x, nbr, nvalid, train, mom):
        for j in range(n):
            x = getattr(self, f"{name}_{j}")(x, nbr, nvalid, train, mom)
        return x

    def forward(self, feats: torch.Tensor, pyramid: Dict[str, object],
                train: bool = False, bn_momentum: float = 0.1):
        """``feats`` (N0, in_channels); ``pyramid`` the tables of
        ``PyramidArrays.to``. (N0, out_channels) float32 rows, and with
        ``return_endpoints`` first the five endpoints."""
        P, mom = pyramid, bn_momentum
        nv = P["nvalid"]
        endpoints = []
        x = self.conv0p1s1(feats, P["nbr_stem"])
        out_p1 = torch.relu(self.bn0(x, nv[0], train, mom))
        skips = []
        x = out_p1
        for i in range(4):
            x = getattr(self, f"conv{i + 1}p{1 << i}s2")(x, P["nbr_down"][i])
            if self.return_endpoints and i == 3:
                # the stride-16 encoder conv output, before its BN: the
                # first of 34CF's five endpoints (upstream minkunet.py:273)
                endpoints.append(x)
            x = torch.relu(getattr(self, f"bn{i + 1}")(x, nv[i + 1], train, mom))
            x = self._blocks(f"block{i + 1}", self.layers[i], x,
                             P["nbr_conv"][i + 1], nv[i + 1], train, mom)
            skips.append(x)
        x = skips[3]
        for d in range(4):
            lvl = 3 - d
            x_up = getattr(self, f"convtr{4 + d}p{1 << (lvl + 1)}s2")(
                x, P["nbr_up"][lvl])
            if self.return_endpoints:
                endpoints.append(x_up)
            x_up = torch.relu(getattr(self, f"bntr{4 + d}")(x_up, nv[lvl],
                                                            train, mom))
            skip = skips[lvl - 1] if lvl >= 1 else out_p1
            x = self._blocks(f"block{5 + d}", self.layers[4 + d],
                             torch.cat([x_up, skip], -1), P["nbr_conv"][lvl],
                             nv[lvl], train, mom)
        out = self.final(x, None)
        return (endpoints, out) if self.return_endpoints else out


def _variant(name, block, layers, planes):
    def make(in_channels, out_channels, **kw):
        return MinkUNetBase(in_channels, out_channels, block=block,
                            layers=layers, planes=planes, **kw)

    make.__name__ = name
    return make


_L14 = (1, 1, 1, 1, 1, 1, 1, 1)
_L18 = (2, 2, 2, 2, 2, 2, 2, 2)
_L34 = (2, 3, 4, 6, 2, 2, 2, 2)
_L101 = (2, 3, 4, 23, 2, 2, 2, 2)
_P_DEFAULT = (32, 64, 128, 256, 256, 128, 96, 96)

# the variant zoo (upstream utils/minkunet.py:183-249)
MinkUNet14 = _variant("MinkUNet14", "basic", _L14, _P_DEFAULT)
MinkUNet18 = _variant("MinkUNet18", "basic", _L18, _P_DEFAULT)
MinkUNet34 = _variant("MinkUNet34", "basic", _L34, _P_DEFAULT)
MinkUNet50 = _variant("MinkUNet50", "bottleneck", _L34, _P_DEFAULT)
MinkUNet101 = _variant("MinkUNet101", "bottleneck", _L101, _P_DEFAULT)

MinkUNet14A = _variant("MinkUNet14A", "basic", _L14, (32, 64, 128, 256, 128, 128, 96, 96))
MinkUNet14B = _variant("MinkUNet14B", "basic", _L14, (32, 64, 128, 256, 128, 128, 128, 128))
MinkUNet14C = _variant("MinkUNet14C", "basic", _L14, (32, 64, 128, 256, 192, 192, 128, 128))
MinkUNet14D = _variant("MinkUNet14D", "basic", _L14, (32, 64, 128, 256, 384, 384, 384, 384))
MinkUNet18A = _variant("MinkUNet18A", "basic", _L18, (32, 64, 128, 256, 128, 128, 96, 96))
MinkUNet18B = _variant("MinkUNet18B", "basic", _L18, (32, 64, 128, 256, 128, 128, 128, 128))
MinkUNet18D = _variant("MinkUNet18D", "basic", _L18, (32, 64, 128, 256, 384, 384, 384, 384))
MinkUNet34A = _variant("MinkUNet34A", "basic", _L34, (32, 64, 128, 256, 256, 128, 64, 64))
MinkUNet34B = _variant("MinkUNet34B", "basic", _L34, (32, 64, 128, 256, 256, 128, 64, 32))
MinkUNet34C = _variant("MinkUNet34C", "basic", _L34, _P_DEFAULT)


def MinkUNet34CF(in_channels, out_channels, **kw):
    """34C returning the decoder endpoints (upstream minkunet.py:248-315)."""
    return MinkUNetBase(in_channels, out_channels, block="basic", layers=_L34,
                        planes=_P_DEFAULT, return_endpoints=True, **kw)


def sparse_plan(dense: DenseMinkUNet) -> MinkUNetBase:
    """A ``MinkUNetBase`` with ``dense``'s plan (a ``DenseMinkUNet``): its
    own random weights, on the CPU."""
    return MinkUNetBase(dense.in_channels, dense.out_channels,
                        layers=dense.layers, planes=dense.planes,
                        init_dim=dense.init_dim, stem_kernel=dense.stem_kernel,
                        compute_dtype=dense.compute_dtype)


def sparse_twin(dense: DenseMinkUNet) -> MinkUNetBase:
    """:func:`sparse_plan` with ``dense``'s weights, on its device."""
    m = sparse_plan(dense)
    m.load_state_dict(dense.state_dict(), strict=True)
    return m.to(next(dense.parameters()).device)


def dense_twin(sparse: MinkUNetBase) -> DenseMinkUNet:
    """A ``DenseMinkUNet`` with ``sparse``'s plan and weights (a copy), on
    its device: the dense backbone of the evaluators runs a model trained on
    the gather form. Basic blocks only, as the dense model has."""
    if sparse.block != "basic":
        raise ValueError(f"the dense backbone has basic blocks only, not "
                         f"{sparse.block!r}")
    m = DenseMinkUNet(sparse.in_channels, sparse.out_channels,
                      layers=sparse.layers, planes=sparse.planes,
                      init_dim=sparse.init_dim, stem_kernel=sparse.stem_kernel,
                      compute_dtype=sparse.compute_dtype)
    m.load_state_dict({k: v.detach().cpu() for k, v in sparse.state_dict().items()},
                      strict=True)
    return m.to(next(sparse.parameters()).device)

