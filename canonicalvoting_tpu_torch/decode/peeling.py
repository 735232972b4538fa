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
once per ``SYNC_EVERY`` iterations, never once per box. The loop is written
over a leading batch axis (``peel_boxes_batched``, the separate evaluator's
categories); ``peel_boxes`` is its one-grid case.
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
               config: PeelConfig, rot_scale_fn=None, valid=None,
               grid_rot: Optional[torch.Tensor] = None,
               grid_scale: Optional[torch.Tensor] = None):
    """Peel oriented boxes off an objectness vote grid.

    Rotation and scale at a peeled cell come from ``rot_scale_fn(cand (3,)
    long) -> (rot_vec (2,), scale (3,))`` (the lazy path: ``ops.
    hough_voting.vote_stats_at_cell``), or, without it, from the dense
    ``grid_rot`` (gx, gy, gz, 2) and ``grid_scale`` (gx, gy, gz, 3) grids of
    ``ops.hough_voting.hough_voting`` (the JAX package's grid branch).
    Returns a dict of fixed-size tensors: boxes (max_boxes, 8, 3), scores,
    classes, accepted, n_boxes, and the exit diagnostics exit_on_threshold,
    n_dropped and truncated (a budget, not the threshold, ended the loop, or
    accepted boxes were dropped). One category of :func:`peel_boxes_batched`.
    """
    fn = None
    if rot_scale_fn is not None:
        def fn(cand):
            rot, scale = rot_scale_fn(cand[0])
            return rot[None], scale[None]

    def batch(t):
        return None if t is None else t[None]

    out = peel_boxes_batched(
        grid_obj[None], points, xyz_pred[None], prob_pred[None],
        batch(class_pred), corner, config, fn, valid=valid,
        grid_rot=batch(grid_rot), grid_scale=batch(grid_scale))
    return {k: v[0] for k, v in out.items()}


def peel_boxes_batched(grid_obj: torch.Tensor, points: torch.Tensor,
                       xyz_pred: torch.Tensor, prob_pred: torch.Tensor,
                       class_pred: Optional[torch.Tensor],
                       corner: torch.Tensor, config: PeelConfig,
                       rot_scale_fn=None, valid=None,
                       grid_rot: Optional[torch.Tensor] = None,
                       grid_scale: Optional[torch.Tensor] = None):
    """:func:`peel_boxes` over a leading axis of C independent vote grids
    (C, gx, gy, gz) that share the scene's ``points``, ``corner`` and
    ``valid``: per-grid ``xyz_pred`` (C, N, 3), ``prob_pred`` (C, N),
    ``class_pred`` (C, N) or None, ``grid_rot``/``grid_scale`` (C, ..., 2/3)
    or ``rot_scale_fn(cand (C, 3)) -> ((C, 2), (C, 3))``. The counterpart of
    the JAX package's ``jax.vmap(peel_one)`` (``eval/separate.py:326-338``):
    every entry gives what its own ``peel_boxes`` call gives, and the loop
    runs as long as the longest entry needs, not the sum of them. Outputs
    carry the leading C axis.
    """
    if rot_scale_fn is None and (grid_rot is None or grid_scale is None):
        raise ValueError("pass rot_scale_fn, or grid_rot and grid_scale")
    cfg = config
    dev = grid_obj.device
    res = torch.tensor(cfg.res, dtype=torch.float32, device=dev)
    grid = grid_obj.clone()
    C, gx, gy, gz = grid.shape
    n_pts = points.shape[0]
    valid_b = (torch.ones(n_pts, dtype=torch.bool, device=dev) if valid is None
               else valid > 0)
    bbox_raw = torch.tensor(unit_box_corners(), dtype=torch.float32, device=dev)
    ix = torch.arange(gx, device=dev)[None, :, None, None]
    iy = torch.arange(gy, device=dev)[None, None, :, None]
    iz = torch.arange(gz, device=dev)[None, None, None, :]
    cats = torch.arange(C, device=dev)
    slots = torch.arange(cfg.max_boxes, device=dev)
    e = cfg.elimination
    hi = e if cfg.elimination_inclusive else e - 1

    boxes = torch.zeros(C, cfg.max_boxes, 8, 3, device=dev)
    scores = torch.zeros(C, cfg.max_boxes, device=dev)
    classes = torch.zeros(C, cfg.max_boxes, dtype=torch.int32, device=dev)
    accepted = torch.zeros(C, cfg.max_boxes, dtype=torch.bool, device=dev)
    n_boxes = torch.zeros(C, dtype=torch.int64, device=dev)
    dropped = torch.zeros(C, dtype=torch.int64, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)

    def cells(v):  # (C,) -> (C, 1, 1, 1)
        return v[:, None, None, None]

    for it in range(cfg.max_iters):
        if it % SYNC_EVERY == 0 and it > 0 and bool(done.all()):
            break
        live = ~done
        flat_idx = torch.argmax(grid.reshape(C, -1), dim=1)
        cand = torch.stack([flat_idx // (gy * gz), (flat_idx // gz) % gy,
                            flat_idx % gz], -1)                    # (C, 3)
        stop = grid.reshape(C, -1).gather(1, flat_idx[:, None])[:, 0] \
            < cfg.thresh_high
        cand_world = corner + res * cand.float()
        if rot_scale_fn is not None:
            rot_vec, scale_full = rot_scale_fn(cand)
        else:
            at = (cats, cand[:, 0], cand[:, 1], cand[:, 2])
            rot_vec, scale_full = grid_rot[at], grid_scale[at]
        rot = torch.atan2(rot_vec[:, 1], rot_vec[:, 0])
        c, s = torch.cos(rot), torch.sin(rot)                      # (C,)
        safe = torch.where(scale_full.abs() < 1e-12,
                           torch.full_like(scale_full, 1e-12), scale_full)

        # grid elimination: the neighbourhood and every cell inside the box
        c0, c1, c2 = (cells(cand[:, a]) for a in range(3))
        elim = ((ix >= c0 - e) & (ix <= c0 + hi)
                & (iy >= c1 - e) & (iy <= c1 + hi)
                & (iz >= c2 - e) & (iz <= c2 + hi))
        dx = (ix - c0).float() * res
        dy = (iy - c1).float() * res
        dz = (iz - c2).float() * res
        cc, ss = cells(c), cells(s)
        inside_cells = (((dx * cc + dz * ss) / cells(safe[:, 0])).abs() < 1.0) \
            & ((dy / cells(safe[:, 1])).abs() < 1.0) \
            & (((-dx * ss + dz * cc) / cells(safe[:, 2])).abs() < 1.0)
        grid = torch.where((elim | inside_cells) & cells(live & ~stop),
                           torch.zeros_like(grid), grid)

        # back-projection check
        d = points - cand_world[:, None]                           # (C, N, 3)
        cn, sn = c[:, None], s[:, None]
        w0 = (d[..., 0] * cn + d[..., 2] * sn) / safe[:, 0:1]
        w1 = d[..., 1] / safe[:, 1:2]
        w2 = (-d[..., 0] * sn + d[..., 2] * cn) / safe[:, 2:3]
        inside_w = ((w0.abs() < 1.0) & (w1.abs() < 1.0) & (w2.abs() < 1.0)
                    & valid_b)
        n_inside = inside_w.sum(-1)
        conf = inside_w & (prob_pred > cfg.prob_thresh)
        n_conf = conf.sum(-1)
        conf_f = conf.float()
        err_vec = torch.linalg.norm(xyz_pred - torch.stack([w0, w1, w2], -1),
                                    dim=-1)
        err = torch.where(conf, err_vec * prob_pred, torch.zeros_like(
            err_vec)).sum(-1) / torch.clamp_min(n_conf, 1)
        ok = ((n_conf >= cfg.valid_ratio * n_inside)
              & (n_inside >= cfg.thresh_low) & (err <= cfg.err_thresh)
              & ~stop & live)
        if class_pred is not None:
            counts = torch.zeros(C, cfg.nclasses, device=dev).scatter_add_(
                1, class_pred.long(), conf_f)
            best_class = torch.argmax(counts, dim=1).to(torch.int32)
        else:
            best_class = torch.zeros(C, dtype=torch.int32, device=dev)
        probmax = torch.where(inside_w, prob_pred,
                              torch.zeros_like(prob_pred)).max(-1).values
        # Rot_y(rot) @ diag(scale) @ unit corners, element by element:
        # rows [c, 0, -s], [0, 1, 0], [s, 0, c]
        bx, by, bz = (bbox_raw[None, :, a] for a in range(3))     # (1, 8)
        sx, sy, sz = (scale_full[:, a:a + 1] for a in range(3))   # (C, 1)
        box = torch.stack([cn * sx * bx - sn * sz * bz,
                           (sy * by).expand(C, 8),
                           sn * sx * bx + cn * sz * bz], -1) \
            + cand_world[:, None]                                  # (C, 8, 3)

        write = ok & (n_boxes < cfg.max_boxes)
        sel = (slots == torch.clamp_max(n_boxes, cfg.max_boxes - 1)[:, None]) \
            & write[:, None]                                       # (C, B)
        boxes = torch.where(sel[..., None, None], box[:, None], boxes)
        scores = torch.where(sel, probmax[:, None], scores)
        classes = torch.where(sel, best_class[:, None], classes)
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
