"""Backbones of the port: the dense MinkUNet on the occupied-tile kernels,
its 34C configuration, and the gather-form sparse MinkUNet family."""

from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import (  # noqa: F401
    MinkUNet14,
    MinkUNet14A,
    MinkUNet14B,
    MinkUNet14C,
    MinkUNet14D,
    MinkUNet18,
    MinkUNet18A,
    MinkUNet18B,
    MinkUNet18D,
    MinkUNet34,
    MinkUNet34A,
    MinkUNet34B,
    MinkUNet34C,
    MinkUNet34CF,
    MinkUNet50,
    MinkUNet101,
    MinkUNetBase,
    sparse_plan,
    sparse_twin,
)
from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm  # noqa: F401

# MinkUNet34C (canonicalvoting_tpu/models/minkunet.py; upstream
# utils/minkunet.py): basic blocks, k=5 stem
MINKUNET34C = dict(layers=(2, 3, 4, 6, 2, 2, 2, 2),
                   planes=(32, 64, 128, 256, 256, 128, 96, 96),
                   init_dim=32, stem_kernel=5)


def DenseMinkUNet34C(in_channels: int, out_channels: int, **kw) -> DenseMinkUNet:
    return DenseMinkUNet(in_channels, out_channels, **MINKUNET34C, **kw)
