"""LCC-aware iterative box peeling on the device.

Counterpart of ``canonicalvoting_tpu/decode/peeling.py:peel_boxes`` (the
upstream decoder of ``eval_joint.py:204-263``). Each iteration takes the
argmax cell of the vote grid, stops when its votes fall below
``thresh_high``, zeroes an elimination neighbourhood and every cell inside
the candidate box, back-projects the scene points into the box frame and
accepts the box when enough confident points agree with their predicted
LCCs.

The JAX package runs the loop as one ``lax.while_loop``. Here the state
stays in device tensors: once an iteration sees the stop condition, ``done``
is set and every later iteration changes nothing. The host reads ``done``
once per ``SYNC_EVERY`` iterations, never once per box.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from canonicalvoting_tpu_torch.data.geometry import unit_box_corners

# iterations between host reads of the device-side `done` flag
SYNC_EVERY = 16


@dataclass(frozen=True)
class PeelConfig:
    """Decoding constants (upstream train_joint.py:16-19, eval_joint.py)."""

    res: float = 0.03
    thresh_high: float = 60.0
    thresh_low: int = 10
    valid_ratio: float = 0.2
    elimination: int = 2
    prob_thresh: float = 0.3
    err_thresh: float = 0.3
    nclasses: int = 9
    max_boxes: int = 64
    max_iters: int = 128
    # True: the eval_joint end bound (+1 included); False: eval_separate's
    elimination_inclusive: bool = True


def peel_boxes(grid_obj: torch.Tensor, points: torch.Tensor,
               xyz_pred: torch.Tensor, prob_pred: torch.Tensor,
               class_pred: Optional[torch.Tensor], corner: torch.Tensor,
               config: PeelConfig, rot_scale_fn, valid=None):
    """Peel oriented boxes off an objectness vote grid.

    ``rot_scale_fn(cand (3,) long) -> (rot_vec (2,), scale (3,))`` samples
    the rotation and scale votes at a cell (``ops.hough_voting.
    vote_stats_at_cell``). Returns a dict of fixed-size tensors: boxes
    (max_boxes, 8, 3), scores, classes, accepted, n_boxes, and the exit
    diagnostics exit_on_threshold, n_dropped and truncated (a budget, not
    the threshold, ended the loop, or accepted boxes were dropped).
    """
    cfg = config
    dev = grid_obj.device
    res = torch.tensor(cfg.res, dtype=torch.float32, device=dev)
    grid = grid_obj.clone()
    gx, gy, gz = grid.shape
    n_pts = points.shape[0]
    valid_b = (torch.ones(n_pts, dtype=torch.bool, device=dev) if valid is None
               else valid > 0)
    bbox_raw = torch.tensor(unit_box_corners(), dtype=torch.float32, device=dev)
    ix = torch.arange(gx, device=dev)[:, None, None]
    iy = torch.arange(gy, device=dev)[None, :, None]
    iz = torch.arange(gz, device=dev)[None, None, :]
    slots = torch.arange(cfg.max_boxes, device=dev)
    e = cfg.elimination
    hi = e if cfg.elimination_inclusive else e - 1

    boxes = torch.zeros(cfg.max_boxes, 8, 3, device=dev)
    scores = torch.zeros(cfg.max_boxes, device=dev)
    classes = torch.zeros(cfg.max_boxes, dtype=torch.int32, device=dev)
    accepted = torch.zeros(cfg.max_boxes, dtype=torch.bool, device=dev)
    n_boxes = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    for it in range(cfg.max_iters):
        if it % SYNC_EVERY == 0 and it > 0 and bool(done):
            break
        live = ~done
        flat_idx = torch.argmax(grid)
        cand = torch.stack([flat_idx // (gy * gz), (flat_idx // gz) % gy,
                            flat_idx % gz])
        stop = grid.reshape(-1)[flat_idx] < cfg.thresh_high
        cand_world = corner + res * cand.float()
        rot_vec, scale_full = rot_scale_fn(cand)
        rot = torch.atan2(rot_vec[1], rot_vec[0])
        c, s = torch.cos(rot), torch.sin(rot)
        safe = torch.where(scale_full.abs() < 1e-12,
                           torch.full_like(scale_full, 1e-12), scale_full)

        # grid elimination: the neighbourhood and every cell inside the box
        elim = ((ix >= cand[0] - e) & (ix <= cand[0] + hi)
                & (iy >= cand[1] - e) & (iy <= cand[1] + hi)
                & (iz >= cand[2] - e) & (iz <= cand[2] + hi))
        dx = (ix - cand[0]).float() * res
        dy = (iy - cand[1]).float() * res
        dz = (iz - cand[2]).float() * res
        inside_cells = (((dx * c + dz * s) / safe[0]).abs() < 1.0) \
            & ((dy / safe[1]).abs() < 1.0) \
            & (((-dx * s + dz * c) / safe[2]).abs() < 1.0)
        grid = torch.where((elim | inside_cells) & live & ~stop,
                           torch.zeros_like(grid), grid)

        # back-projection check
        d = points - cand_world
        w0 = (d[:, 0] * c + d[:, 2] * s) / safe[0]
        w1 = d[:, 1] / safe[1]
        w2 = (-d[:, 0] * s + d[:, 2] * c) / safe[2]
        inside_w = ((w0.abs() < 1.0) & (w1.abs() < 1.0) & (w2.abs() < 1.0)
                    & valid_b)
        n_inside = inside_w.sum()
        conf = inside_w & (prob_pred > cfg.prob_thresh)
        n_conf = conf.sum()
        conf_f = conf.float()
        err_vec = torch.linalg.norm(xyz_pred - torch.stack([w0, w1, w2], -1),
                                    dim=-1)
        err = (err_vec * prob_pred * conf_f).sum() / torch.clamp_min(n_conf, 1)
        ok = ((n_conf >= cfg.valid_ratio * n_inside)
              & (n_inside >= cfg.thresh_low) & (err <= cfg.err_thresh)
              & ~stop & live)
        if class_pred is not None:
            counts = torch.zeros(cfg.nclasses, device=dev).index_add_(
                0, class_pred.long(), conf_f)
            best_class = torch.argmax(counts).to(torch.int32)
        else:
            best_class = torch.zeros((), dtype=torch.int32, device=dev)
        probmax = torch.where(inside_w, prob_pred,
                              torch.zeros_like(prob_pred)).max()
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot_mat = torch.stack([torch.stack([c, zero, -s]),
                               torch.stack([zero, one, zero]),
                               torch.stack([s, zero, c])])
        box = (rot_mat @ torch.diag(scale_full) @ bbox_raw.T).T + cand_world

        write = ok & (n_boxes < cfg.max_boxes)
        sel = (slots == torch.clamp_max(n_boxes, cfg.max_boxes - 1)) & write
        boxes = torch.where(sel[:, None, None], box, boxes)
        scores = torch.where(sel, probmax, scores)
        classes = torch.where(sel, best_class, classes)
        accepted = accepted | sel
        n_boxes = n_boxes + write.long()
        dropped = dropped + (ok & ~write).long()
        done = done | (stop & live)

    return {
        "boxes": boxes,
        "scores": scores,
        "classes": classes,
        "accepted": accepted,
        "n_boxes": n_boxes,
        "exit_on_threshold": done,
        "n_dropped": dropped,
        "truncated": ~done | (dropped > 0),
    }
