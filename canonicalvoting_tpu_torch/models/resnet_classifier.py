"""A sparse ResNet classifier over the gather-form convolution.

The port's counterpart of ``canonicalvoting_tpu/models/resnet_classifier.py``
(upstream ``utils/resnet.py:ResNetBase``, a demo network): a k=5 stem conv
on L0, four stages each entered by a stride-2 conv (L0 -> L1 ... L3 -> L4)
and followed by residual blocks, a global max pool over the valid L4 rows,
and a linear head. As in the JAX package, upstream's last stride-3 stage
is a stride-2 one (the coordinate pyramid is built in powers of two). Module
and parameter names are the JAX tree's (``conv1``, ``bn1``, ``down1``,
``layer1_0``, ``final.kernel`` (Cin, classes), ``final.bias``), so
``utils/weights.py:from_jax_variables`` loads a JAX classifier's variables.
:func:`toy_pattern_batch` is the JAX package's toy point-pattern sample
(upstream ``utils/resnet.py:42-64``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm
from canonicalvoting_tpu_torch.models.resnet import BLOCKS, SparseConv
from canonicalvoting_tpu_torch.ops.sparse_conv import masked_global_pool


class Dense(nn.Module):
    """``x @ kernel + bias`` in float32 (flax ``nn.Dense``'s layout:
    ``kernel`` (in, out)); the kernel drawn LeCun-normal."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn(in_features, out_features,
                                               generator=generator)
                                   / in_features ** 0.5)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class SparseResNetClassifier(nn.Module):
    """ResNetBase-style classifier: (N0, in_channels) rows of one scene and
    its pyramid's tables (``PyramidArrays.to``) -> (num_classes,) logits."""

    def __init__(self, in_channels: int, num_classes: int, block: str = "basic",
                 layers: Sequence[int] = (2, 2, 2, 2),
                 planes: Sequence[int] = (64, 128, 256, 512),
                 init_dim: int = 64, compute_dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers, self.planes = tuple(layers), tuple(planes)
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        blk = BLOCKS[block]
        self.conv1 = SparseConv(in_channels, init_dim, 125, **kw)
        self.bn1 = MaskedBatchNorm(init_dim)
        ch = init_dim
        for i, (p, n) in enumerate(zip(planes, layers)):
            self.add_module(f"down{i + 1}", SparseConv(ch, ch, 8, **kw))
            for j in range(n):
                self.add_module(f"layer{i + 1}_{j}", blk(
                    ch if j == 0 else p * blk.expansion, p, **kw))
            ch = p * blk.expansion
        self.final = Dense(ch, num_classes, generator)

    def forward(self, feats: torch.Tensor, pyramid: Dict[str, object],
                train: bool = False, bn_momentum: float = 0.1) -> torch.Tensor:
        P, nv = pyramid, pyramid["nvalid"]
        x = torch.relu(self.bn1(self.conv1(feats, P["nbr_stem"]), nv[0],
                                train, bn_momentum))
        for i, n in enumerate(self.layers):
            x = getattr(self, f"down{i + 1}")(x, P["nbr_down"][i])
            for j in range(n):
                x = getattr(self, f"layer{i + 1}_{j}")(
                    x, P["nbr_conv"][i + 1], nv[i + 1], train, bn_momentum)
        return self.final(masked_global_pool(x, nv[4], mode="max"))


def toy_pattern_batch(rng: np.random.RandomState, n_classes: int = 3,
                      n_points: int = 120):
    """One synthetic 2.5D point pattern (a ring, a cross or a bar, by
    class): (coords (N, 4) int32 with batch index 0, feats (N, 1) float32,
    label), the JAX package's draws from ``rng`` in its order."""
    label = rng.randint(n_classes)
    t = rng.uniform(0, 2 * np.pi, n_points)
    if label == 0:  # ring
        pts = np.stack([np.cos(t), np.sin(t)], -1) * 8
    elif label == 1:  # cross
        a = rng.uniform(-8, 8, n_points)
        pts = np.stack([a, np.where(rng.rand(n_points) > 0.5, a, -a)], -1)
    else:  # bar
        pts = np.stack([rng.uniform(-8, 8, n_points),
                        rng.uniform(-1, 1, n_points)], -1)
    pts = pts + rng.randn(n_points, 2) * 0.3
    coords3 = np.concatenate([np.round(pts).astype(np.int32),
                              np.zeros((n_points, 1), np.int32)], -1)
    coords = np.concatenate([np.zeros((n_points, 1), np.int32), coords3], -1)
    _, idx = np.unique(coords, axis=0, return_index=True)  # one row a voxel
    coords = coords[np.sort(idx)]
    feats = rng.randn(len(coords), 1).astype(np.float32)
    return coords, feats, label
