"""Masked BatchNorm over the valid rows, with PyTorch momentum semantics.

The port's counterpart of ``canonicalvoting_tpu/models/norm.py``
(``ME.MinkowskiBatchNorm`` upstream). In training, batch statistics are
taken over the rows below ``nvalid`` only (padding rows excluded), and the
running statistics follow torch's convention ``running = (1 - momentum) *
running + momentum * batch_stat`` with the unbiased variance in the update.
In evaluation the running statistics normalize.

Sync-BN (the JAX package's ``axis_name``, psummed over the vmapped scene
axis of its data-parallel step): :func:`sync_batch_norm` gives every norm
of a model a mesh whose data group it reduces over (the module tree, and
so the state dict, is unchanged). A train-mode norm with a group reduces its
packed ``[n, s1, s2]`` over the group in ONE differentiable all-reduce
(``parallel/collectives.py:sum_over``: the backward all-reduces the
gradients, right here since every rank's loss depends on the global
statistics) and then clamps ``n``, as JAX clamps after its psum; alone,
the same sums.

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

from canonicalvoting_tpu_torch.parallel.collectives import sum_over

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


def sync_stats(packed: torch.Tensor, group) -> torch.Tensor:
    """``packed`` summed over the ranks of ``group``, differentiably."""
    return sum_over(packed, group)


def sync_batch_norm(model: nn.Module, mesh) -> nn.Module:
    """Every ``MaskedBatchNorm`` of ``model`` takes its batch statistics
    over ``mesh``'s data group (a ``parallel.mesh.Mesh``; None, or a data
    group of one rank: each rank its own), as JAX's
    ``model.clone(bn_axis="batch")``; returns ``model``."""
    mesh = mesh if mesh is not None and mesh.data > 1 else None
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.sync_mesh = mesh
    return model


class MaskedBatchNorm(nn.Module):
    """``scale``/``bias`` parameters, ``mean``/``var`` running statistics
    (the JAX tree's names); ``sync_mesh`` (see :func:`sync_batch_norm`)
    is no part of the state."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.features, self.eps = features, eps
        self.sync_mesh = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, nvalid: int, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        if train:
            mask = (torch.arange(x.shape[0], device=x.device)[:, None]
                    < nvalid).to(x.dtype)
            n, s1, s2 = mask.sum(), (x * mask).sum(0), ((x * x) * mask).sum(0)
            if self.sync_mesh is not None:
                f = self.features
                packed = sync_stats(torch.cat([n.reshape(1), s1, s2]),
                                    self.sync_mesh.data_group)
                n, s1, s2 = packed[0], packed[1:1 + f], packed[1 + f:]
            n = torch.clamp_min(n, 1.0)
            mean = s1 / n
            var = torch.clamp_min(s2 / n - mean * mean, 0.0)  # biased
            if running_updates():
                with torch.no_grad():
                    unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
                    self.mean.mul_(1.0 - momentum).add_(momentum * mean)
                    self.var.mul_(1.0 - momentum).add_(momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.scale + self.bias
