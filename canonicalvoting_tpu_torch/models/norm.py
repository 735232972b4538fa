"""Masked BatchNorm over the valid rows, with PyTorch momentum semantics.

The port's counterpart of ``canonicalvoting_tpu/models/norm.py``
(``ME.MinkowskiBatchNorm`` upstream). In training, batch statistics are
taken over the rows below ``nvalid`` only (padding rows excluded), and the
running statistics follow torch's convention ``running = (1 - momentum) *
running + momentum * batch_stat`` with the unbiased variance in the update.
In evaluation the running statistics normalize. There is no sync-BN axis.

:func:`remat` runs a residual block under ``torch.utils.checkpoint``
(``tpu.train_remat``, the JAX package's ``nn.remat``): the backward
recomputes the block's forward from its input. A recomputed train-mode
norm would update its running statistics a second time, where JAX's remat
discards the recompute's updates; so the recompute runs inside
:func:`frozen_running_stats`, and every norm's running statistics move once
a forward.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_frozen = threading.local()


def running_updates() -> bool:
    """Whether a train-mode norm updates its running statistics here."""
    return not getattr(_frozen, "on", False)


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode norms inside normalize with their batch statistics and
    leave their running statistics as they are."""
    old = getattr(_frozen, "on", False)
    _frozen.on = True
    try:
        yield
    finally:
        _frozen.on = old


def remat(block, *args):
    """``block(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant: the autograd graph is the
    one a plain call records, so the gradients are summed in the same
    order). The first run updates the running statistics; the recompute,
    inside :func:`frozen_running_stats`, does not."""
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          frozen_running_stats()))


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
            if running_updates():
                with torch.no_grad():
                    unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
                    self.mean.mul_(1.0 - momentum).add_(momentum * mean)
                    self.var.mul_(1.0 - momentum).add_(momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.scale + self.bias
