"""Training losses.

The port's counterpart of ``canonicalvoting_tpu/train/losses.py``.

Joint loss (upstream train_joint.py:246-282): the xyz and scale heads of
each point's ground-truth class, a masked weighted MSE on the local
canonical coordinates (LCC) and the log scale, and a 10-way cross-entropy
(nine classes and the background).

Separate loss (upstream train_separate.py:246-286): a binary objectness
cross-entropy, a masked scale MSE, and the symmetry-aware LCC loss, the
minimum over an object's yaw hypotheses of its mean error. Hypothesis h's
label is the base LCC rotated by ``Rot_y(-angle_h)``, so the minimum is one
segment sum over (points x hypotheses) into ``max_objects + 1`` buckets (the
last one takes background and padding rows) and one ``torch.amin``, which
splits the gradient evenly among tied hypotheses as ``jnp.min`` does.

Rows at or past ``nvalid`` are padding; every loss drops them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from canonicalvoting_tpu_torch.data.geometry import (
    NCLASSES, SYM_CODES, SYMMETRY_ANGLES)

MAX_HYPOTHESES = 36


def _sym_tables():
    """(angles, valid), each (4, MAX_HYPOTHESES) float32: a symmetry code's
    yaw hypotheses, the identity first."""
    angles = np.zeros((4, MAX_HYPOTHESES), np.float32)
    valid = np.zeros((4, MAX_HYPOTHESES), np.float32)
    for name, code in SYM_CODES.items():
        a = [0.0] + list(SYMMETRY_ANGLES[name])
        angles[code, :len(a)] = a
        valid[code, :len(a)] = 1.0
    return angles, valid


_SYM_ANGLES, _SYM_VALID = _sym_tables()


def _rows_valid(n: int, nvalid, device) -> torch.Tensor:
    return torch.arange(n, device=device) < nvalid


def _scale_target(scale_labels: torch.Tensor, log_scale: bool) -> torch.Tensor:
    return torch.log(torch.clamp_min(scale_labels, 1e-12)) if log_scale \
        else scale_labels


def _mean_ce(logits: torch.Tensor, target: torch.Tensor,
             rv: torch.Tensor) -> torch.Tensor:
    """Cross-entropy averaged over the rows where ``rv`` is 1."""
    ce = -F.log_softmax(logits, -1).gather(1, target[:, None].long())[:, 0]
    return torch.sum(ce * rv) / torch.clamp_min(torch.sum(rv), 1.0)


def joint_losses(out: torch.Tensor, xyz_labels: torch.Tensor,
                 scale_labels: torch.Tensor, class_labels: torch.Tensor,
                 nvalid, xyz_weights, log_scale: bool = True,
                 xyz_factor: float = 1.0, scale_factor: float = 1.0,
                 nclasses: int = NCLASSES) -> Dict[str, torch.Tensor]:
    """The joint model's losses on padded rows.

    ``out`` (N, 6 * nclasses + nclasses + 1); labels per row, the class in
    [0, nclasses] with nclasses the background."""
    n, dev = out.shape[0], out.device
    rows_valid = _rows_valid(n, nvalid, dev)
    out_xyz = out[:, :3 * nclasses].reshape(-1, nclasses, 3)
    out_scale = out[:, 3 * nclasses:6 * nclasses].reshape(-1, nclasses, 3)
    out_class = out[:, 6 * nclasses:]

    # the heads of each row's class; background and invalid read class 0
    # (upstream train_joint.py:253-255)
    idx = torch.clamp(class_labels.long(), 0, nclasses - 1)
    rows = torch.arange(n, device=dev)
    pred_xyz, pred_scale = out_xyz[rows, idx], out_scale[rows, idx]

    mask = rows_valid & (class_labels >= 0) & (class_labels < nclasses)
    mask_f = mask.float()[:, None]
    n_pos = torch.clamp_min(torch.sum(mask_f) * 3.0, 1.0)
    w = torch.tensor(xyz_weights, dtype=torch.float32, device=dev)
    target = _scale_target(scale_labels, log_scale)
    loss_scale = torch.sum(((pred_scale - target) ** 2) * w * mask_f) / n_pos
    loss_xyz = torch.sum(((pred_xyz - xyz_labels) ** 2) * w * mask_f) / n_pos

    # CE over every valid row, background included (train_joint.py:273)
    loss_class = _mean_ce(out_class, torch.clamp(class_labels, 0, nclasses),
                          rows_valid.float())

    any_pos = torch.sum(mask_f) > 0
    zero = out.new_zeros(())
    loss_xyz = torch.where(any_pos, loss_xyz * xyz_factor, zero)
    loss_scale = torch.where(any_pos, loss_scale * scale_factor, zero)
    loss_class = torch.where(any_pos, loss_class, zero)
    return {"loss_xyz": loss_xyz, "loss_scale": loss_scale,
            "loss_class": loss_class,
            "loss": loss_xyz + loss_scale + loss_class}


def symmetry_xyz_loss(pred_xyz: torch.Tensor, base_xyz: torch.Tensor,
                      obj_id: torch.Tensor, sym_code: torch.Tensor,
                      num_objects, xyz_weights, max_objects: int,
                      nvalid) -> torch.Tensor:
    """The min-over-hypotheses LCC loss.

    ``pred_xyz``/``base_xyz`` (N, 3); ``obj_id`` (N,) (-1: background or
    padding); ``sym_code`` (max_objects,) per object; ``num_objects`` the
    true count. Per object o: the minimum over its hypotheses h of the mean
    over its points and 3 components of ``(pred - Rot_y(-a_h) base)^2 *
    w``; the loss is the mean over the objects (train_separate.py:265-278)."""
    n, dev = pred_xyz.shape[0], pred_xyz.device
    pt_valid = _rows_valid(n, nvalid, dev) & (obj_id >= 0)
    seg = torch.where(pt_valid, obj_id.long(), max_objects)  # overflow bucket

    code = torch.clamp(sym_code.long(), 0, 3)
    hvalid = torch.from_numpy(_SYM_VALID).to(dev)[code]            # (O, H)
    angles = torch.from_numpy(_SYM_ANGLES).to(dev)[code]           # (O, H)
    ang_pt = angles[torch.clamp(obj_id.long(), 0, max_objects - 1)]  # (N, H)
    w = torch.tensor(xyz_weights, dtype=torch.float32, device=dev)
    c, s = torch.cos(-ang_pt), torch.sin(-ang_pt)
    bx, by, bz = base_xyz[:, 0:1], base_xyz[:, 1:2], base_xyz[:, 2:3]
    # roty(t) = [[c, 0, -s], [0, 1, 0], [s, 0, c]] with t = -angle
    lx = c * bx - s * bz
    lz = s * bx + c * bz
    ly = by.expand_as(lx)
    px, py, pz = pred_xyz[:, 0:1], pred_xyz[:, 1:2], pred_xyz[:, 2:3]
    err = w[0] * (px - lx) ** 2 + w[1] * (py - ly) ** 2 + w[2] * (pz - lz) ** 2

    n_seg = max_objects + 1
    err_sum = err.new_zeros(n_seg, err.shape[1]).index_add(0, seg, err)
    cnt = err.new_zeros(n_seg).index_add(0, seg, pt_valid.to(err.dtype))
    err_mean = err_sum[:max_objects] / torch.clamp_min(
        cnt[:max_objects, None] * 3.0, 1.0)

    obj_valid = ((torch.arange(max_objects, device=dev) < num_objects)
                 & (cnt[:max_objects] > 0))
    big = torch.full_like(err_mean, 3e38)
    per_obj = torch.amin(torch.where(hvalid > 0, err_mean, big), dim=1)
    per_obj = torch.where(obj_valid, per_obj, per_obj.new_zeros(()))
    denom = torch.clamp_min(torch.sum(obj_valid.float()), 1.0)
    return torch.sum(per_obj) / denom


def separate_losses(out: torch.Tensor, base_xyz: torch.Tensor,
                    scale_labels: torch.Tensor, obj_labels: torch.Tensor,
                    obj_id: torch.Tensor, sym_code: torch.Tensor, num_objects,
                    nvalid, xyz_weights, max_objects: int,
                    log_scale: bool = True, xyz_factor: float = 1.0,
                    scale_factor: float = 1.0) -> Dict[str, torch.Tensor]:
    """A per-category model's losses (train_separate.py:246-286): ``out``
    (N, 8) = xyz (3) + scale (3) + binary objectness (2)."""
    n, dev = out.shape[0], out.device
    rows_valid = _rows_valid(n, nvalid, dev)
    pred_xyz, pred_scale, pred_obj = out[:, :3], out[:, 3:6], out[:, 6:8]

    loss_obj = _mean_ce(pred_obj, torch.clamp(obj_labels, 0, 1),
                        rows_valid.float())

    mask_f = (rows_valid & (obj_labels == 1)).float()[:, None]
    n_pos = torch.clamp_min(torch.sum(mask_f) * 3.0, 1.0)
    w = torch.tensor(xyz_weights, dtype=torch.float32, device=dev)
    target = _scale_target(scale_labels, log_scale)
    loss_scale = torch.sum(((pred_scale - target) ** 2) * w * mask_f) / n_pos

    loss_xyz = symmetry_xyz_loss(pred_xyz, base_xyz, obj_id, sym_code,
                                 num_objects, xyz_weights, max_objects, nvalid)
    loss_xyz = loss_xyz * xyz_factor
    loss_scale = loss_scale * scale_factor
    return {"loss_obj": loss_obj, "loss_xyz": loss_xyz,
            "loss_scale": loss_scale,
            "loss": loss_obj + loss_xyz + loss_scale}
