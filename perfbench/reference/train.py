"""Plain joint training step: the benchmark's reference for the training
cell.

The joint loss of upstream ``train_joint.py:246-282`` (the xyz and log
scale heads of each point's ground-truth class under a masked MSE, and a
10-way cross-entropy over every point, background included) on the
reference MinkUNet in training mode (BatchNorm over the batch), its
gradients by autograd, and Adam (bias-corrected moments, eps outside the
square root), in float32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from reference import minkunet

NCLASSES = 9


def joint_loss(out: torch.Tensor, xyz_labels: torch.Tensor,
               scale_labels: torch.Tensor, class_labels: torch.Tensor,
               nclasses: int = NCLASSES) -> torch.Tensor:
    """``out`` (N, 6n + n + 1) head rows of the valid points."""
    n = out.shape[0]
    out_xyz = out[:, :3 * nclasses].reshape(n, nclasses, 3)
    out_scale = out[:, 3 * nclasses:6 * nclasses].reshape(n, nclasses, 3)
    logits = out[:, 6 * nclasses:]
    idx = class_labels.long().clamp(0, nclasses - 1)
    rows = torch.arange(n, device=out.device)
    pos = (class_labels >= 0) & (class_labels < nclasses)
    m = pos.float()[:, None]
    n_pos = torch.clamp_min(m.sum() * 3.0, 1.0)
    target = torch.log(torch.clamp_min(scale_labels, 1e-12))
    loss_scale = (((out_scale[rows, idx] - target) ** 2) * m).sum() / n_pos
    loss_xyz = (((out_xyz[rows, idx] - xyz_labels) ** 2) * m).sum() / n_pos
    ce = F.cross_entropy(logits, class_labels.long().clamp(0, nclasses))
    return loss_xyz + loss_scale + ce


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: Dict[str, Dict[str, torch.Tensor]], step: int, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update of ``params`` in place; ``step`` counts from 1."""
    for k, g in grads.items():
        st = state.setdefault(k, {"m": torch.zeros_like(g),
                                  "v": torch.zeros_like(g)})
        st["m"].mul_(b1).add_(g, alpha=1 - b1)
        st["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = st["m"] / (1 - b1 ** step)
        vhat = st["v"] / (1 - b2 ** step)
        params[k].sub_(lr * mhat / (vhat.sqrt() + eps))


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                layers: Sequence[int], lr: float, quant=None):
    """Steps of the joint model from ``params`` (float32 leaves and
    statistics, changed in place) over ``batches`` (each: ``coords`` (N, 4)
    batched voxel coordinates, ``feats``, ``xyz``, ``scale``, ``cls``).
    Returns (losses, first gradients by leaf, the first step's head rows)."""
    leaves = [k for k in params if not k.endswith((".mean", ".var"))]
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    losses, first, rows = [], None, None
    with minkunet.exact_float32():
        for i, b in enumerate(batches):
            geo = minkunet.geometry(b["coords"])
            P = {k: (v.detach().requires_grad_(True) if k in leaves else v)
                 for k, v in params.items()}
            out = minkunet.forward(P, b["feats"], geo, layers, train=True,
                                   quant=quant)
            loss = joint_loss(out, b["xyz"], b["scale"], b["cls"])
            if rows is None:
                rows = out.detach().clone()
            grads = torch.autograd.grad(loss, [P[k] for k in leaves])
            grads = dict(zip(leaves, grads))
            del out, geo, P
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            with torch.no_grad():
                adam_update(params, grads, state, i + 1, lr)
            losses.append(float(loss.detach()))
    return losses, first, rows
