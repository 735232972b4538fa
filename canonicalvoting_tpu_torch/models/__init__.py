"""Backbones of the port: the dense MinkUNet and its 34C configuration."""

from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet

# MinkUNet34C (canonicalvoting_tpu/models/minkunet.py; upstream
# utils/minkunet.py): basic blocks, k=5 stem
MINKUNET34C = dict(layers=(2, 3, 4, 6, 2, 2, 2, 2),
                   planes=(32, 64, 128, 256, 256, 128, 96, 96),
                   init_dim=32, stem_kernel=5)


def DenseMinkUNet34C(in_channels: int, out_channels: int, **kw) -> DenseMinkUNet:
    return DenseMinkUNet(in_channels, out_channels, **MINKUNET34C, **kw)
