"""Masked BatchNorm over the valid rows, with PyTorch momentum semantics.

The port's counterpart of ``canonicalvoting_tpu/models/norm.py``
(``ME.MinkowskiBatchNorm`` upstream). In training, batch statistics are
taken over the rows below ``nvalid`` only (padding rows excluded), and the
running statistics follow torch's convention ``running = (1 - momentum) *
running + momentum * batch_stat`` with the unbiased variance in the update.
In evaluation the running statistics normalize. There is no sync-BN axis.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """``scale``/``bias`` parameters, ``mean``/``var`` running statistics
    (the JAX tree's names)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.features, self.eps = features, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, nvalid: int, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        if train:
            mask = (torch.arange(x.shape[0], device=x.device)[:, None]
                    < nvalid).to(x.dtype)
            n = torch.clamp_min(mask.sum(), 1.0)
            mean = (x * mask).sum(0) / n
            var = torch.clamp_min(((x * x) * mask).sum(0) / n - mean * mean,
                                  0.0)  # biased
            with torch.no_grad():
                unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
                self.mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.var.mul_(1.0 - momentum).add_(momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.scale + self.bias
