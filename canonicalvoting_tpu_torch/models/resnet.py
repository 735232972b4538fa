"""Sparse ResNet blocks over the gather-form convolution.

The port's counterpart of ``canonicalvoting_tpu/models/resnet.py``
(MinkowskiEngine's BasicBlock / Bottleneck upstream) on
``ops/sparse_conv.py``. Every conv inside a block is stride 1, so a block's
convs share one neighbor table; the 1x1 downsample shortcut is a plain
product. Module and parameter names are the JAX tree's (``conv1.kernel``,
``norm1.scale``, ``downsample_conv.kernel``, ...), so ``utils/weights.py``
loads one state dict into this model or into ``DenseMinkUNet``.

Kernels are initialised Kaiming-normal over fan-out (``K * Cout``), drawn
from the caller's ``torch.Generator`` (the global generator when None).

A conv given a ``DensePlan`` in place of its neighbor table runs through
the scatter-dense engine (``ops/scatter_conv.py``), as the JAX package's
``SparseConv`` does. Under mesh training a conv whose kernel is split
over the model group (``parallel/data_parallel.py:shard_train_state``
sets ``tp_mesh`` and leaves ``kernel`` this rank's column slice) runs
column-parallel (``ops/sparse_conv.py:column_parallel_conv``), the bias,
replicated, added after; the mesh path collates no dense plans, as the
JAX package's does not.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm
from canonicalvoting_tpu_torch.ops.scatter_conv import DensePlan, scatter_dense_conv
from canonicalvoting_tpu_torch.ops.sparse_conv import (
    column_parallel_conv, sparse_conv1x1, sparse_conv_apply)


def kernel_init(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Kaiming-normal over fan-out of a (K, Cin, Cout) kernel."""
    std = (2.0 / (shape[0] * shape[2])) ** 0.5
    return std * torch.randn(shape, generator=generator)


class SparseConv(nn.Module):
    """A sparse conv of ``kernel_volume`` taps (no bias unless asked)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 use_bias: bool = False, compute_dtype: str = "bfloat16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_volume, self.compute_dtype = kernel_volume, compute_dtype
        self.kernel = nn.Parameter(kernel_init(
            (kernel_volume, in_channels, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        self.tp_mesh = None  # the mesh of a column-split kernel

    def _conv(self, x, nbr, bias):
        if self.kernel_volume == 1:
            return sparse_conv1x1(x, self.kernel, bias, self.compute_dtype)
        if isinstance(nbr, DensePlan):
            return scatter_dense_conv(x, self.kernel, bias, nbr,
                                      self.compute_dtype)
        return sparse_conv_apply(x, nbr, self.kernel, bias, self.compute_dtype)

    def forward(self, x: torch.Tensor, nbr) -> torch.Tensor:
        if self.tp_mesh is None:
            return self._conv(x, nbr, self.bias)
        if isinstance(nbr, DensePlan):
            raise ValueError("a column-parallel conv runs the gather form; "
                             "mesh training takes no dense plans")
        out = column_parallel_conv(x, None if self.kernel_volume == 1 else nbr,
                                   self.kernel, self.tp_mesh, self.compute_dtype)
        return out if self.bias is None else out + self.bias


class _Block(nn.Module):
    expansion = 1

    def _shortcut(self, in_channels, planes, compute_dtype, generator):
        out = planes * self.expansion
        self.has_downsample = in_channels != out
        if self.has_downsample:
            self.downsample_conv = SparseConv(in_channels, out, 1,
                                              compute_dtype=compute_dtype,
                                              generator=generator)
            self.downsample_norm = MaskedBatchNorm(out)

    def _residual(self, x, nvalid, train, momentum):
        if not self.has_downsample:
            return x
        return self.downsample_norm(self.downsample_conv(x, None), nvalid,
                                    train, momentum)


class BasicBlock(_Block):
    """conv3 - bn - relu - conv3 - bn, plus the shortcut; expansion 1."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int,
                 compute_dtype: str = "bfloat16", kernel_volume: int = 27,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = SparseConv(in_channels, planes, kernel_volume, **kw)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, kernel_volume, **kw)
        self.norm2 = MaskedBatchNorm(planes)
        self._shortcut(in_channels, planes, **kw)

    def forward(self, x, nbr, nvalid: int, train: bool = False,
                momentum: float = 0.1):
        out = torch.relu(self.norm1(self.conv1(x, nbr), nvalid, train, momentum))
        out = self.norm2(self.conv2(out, nbr), nvalid, train, momentum)
        return torch.relu(out + self._residual(x, nvalid, train, momentum))


class Bottleneck(_Block):
    """1x1 -> 3x3 -> 1x1 with expansion 4 (MinkUNet50/101)."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int,
                 compute_dtype: str = "bfloat16", kernel_volume: int = 27,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = SparseConv(in_channels, planes, 1, **kw)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, kernel_volume, **kw)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = SparseConv(planes, planes * self.expansion, 1, **kw)
        self.norm3 = MaskedBatchNorm(planes * self.expansion)
        self._shortcut(in_channels, planes, **kw)

    def forward(self, x, nbr, nvalid: int, train: bool = False,
                momentum: float = 0.1):
        out = torch.relu(self.norm1(self.conv1(x, None), nvalid, train, momentum))
        out = torch.relu(self.norm2(self.conv2(out, nbr), nvalid, train, momentum))
        out = self.norm3(self.conv3(out, None), nvalid, train, momentum)
        return torch.relu(out + self._residual(x, nvalid, train, momentum))


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}

