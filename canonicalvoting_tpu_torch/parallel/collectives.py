"""Collectives of mesh training (``parallel/data_parallel.py``).

:func:`sum_over` is sync-BN's (its statistics over a mesh's data group):
an all-reduce in the forward and an all-reduce of the gradients in the
backward, since every rank's loss depends on the sum.
``torch.distributed.nn.functional.all_reduce`` does the same; it is
deprecated, so the Function is here.

:func:`all_gather_columns` and :func:`column_slice` move a column-split
tensor (a conv kernel or its output) between this rank's slice and the
whole over a mesh's model group; ``ops/sparse_conv.py:ColumnGatherMatmul``
and ``parallel/data_parallel.py`` use them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, differentiably."""
    return _SumOver.apply(t, group)


def all_gather_columns(t: torch.Tensor, mesh) -> torch.Tensor:
    """The last dim of ``t`` (this rank's column slice) all-gathered over
    ``mesh``'s model group, in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, -1)


def column_slice(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of the last dim of ``t`` (the columns ``m * c``
    to ``(m + 1) * c`` of ``mesh.model`` slices)."""
    c = t.shape[-1] // mesh.model
    m = mesh.coords[1]
    return t[..., m * c:(m + 1) * c]
