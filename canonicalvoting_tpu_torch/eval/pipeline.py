"""Joint detection pipeline: voxelize -> backbone -> vote -> peel -> NMS.

Counterpart of ``canonicalvoting_tpu/eval/pipeline.py:DetectionPipeline`` on
its dense, tiled, lazy rot/scale path (the upstream inference pass,
``eval_joint.py:163-303``):

  host:   sparse_quantize, dense grid geometry, tile lists
  device: DenseMinkUNet forward (tiled kernels) -> head slice -> objectness
          vote splat -> box peeling with rot/scale sampled at peeled cells
  host:   per-class NMS at IoU 0.3, class naming

The pipeline runs on the card unless ``device="cpu"`` is asked for; the
default raises where there is no GPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from canonicalvoting_tpu_torch.data.dense_prep import (
    dense_flat_ids, dense_grid_geometry, fit_plans, level_tiles,
    tile_plan_for_key)
from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME, NCLASSES
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig, peel_boxes
from canonicalvoting_tpu_torch.metrics.ap import nms as nms_host
from canonicalvoting_tpu_torch.ops.hough_voting import (
    compute_corners, grid_dims_from_corners, hough_voting_obj,
    round_grid_shape, vote_stats_at_cell)
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize


def slice_joint_heads(out: torch.Tensor, nclasses: int = NCLASSES):
    """(xyz, scale, class_pred, prob_pred) from (N, 6n + n + 1) head rows:
    per-point heads gathered by the argmax class, background -> class 0
    (upstream eval_joint.py:173-190)."""
    out_xyz = out[:, :3 * nclasses].reshape(-1, nclasses, 3)
    out_scale = out[:, 3 * nclasses:6 * nclasses].reshape(-1, nclasses, 3)
    out_class = out[:, 6 * nclasses:]
    idx = torch.argmax(out_class, dim=-1)
    idx = torch.where(idx == nclasses, torch.zeros_like(idx), idx)
    g = idx[:, None, None].expand(-1, 1, 3)
    xyz = torch.gather(out_xyz, 1, g)[:, 0]
    scale = torch.gather(out_scale, 1, g)[:, 0]
    class_pred = torch.argmax(out_class[..., :-1], dim=-1).to(torch.int32)
    prob_pred = torch.softmax(out_class, dim=-1)[..., :-1].max(-1).values
    return xyz, scale, class_pred, prob_pred


@dataclass
class SceneArgs:
    """One scene's prepared inputs, on the pipeline's device."""

    feats: torch.Tensor      # (cap, Cin) float32
    flat: torch.Tensor       # (cap,) int32 margined L0 cell ids, -1 padding
    valid: torch.Tensor      # (cap,) float32
    coords_w: torch.Tensor   # (cap, 3) float32 voxel coords * res
    grid_shape: tuple        # vote grid capacity
    dense_dims: tuple        # backbone interior dims
    tiles: Dict[int, torch.Tensor]
    tile_shapes: Dict[int, tuple]


def prepare_scene_args(coords: np.ndarray, feats_raw: np.ndarray, *,
                       res: float, cap_multiple: int, grid_multiple,
                       device) -> SceneArgs:
    """Host prep: padded rows, flat cell ids and the tile lists."""
    n = len(coords)
    dims_w = (coords.max(0) - coords.min(0)).astype(np.int32) + 1
    grid_shape = round_grid_shape(dims_w, grid_multiple)
    cap = int(np.ceil(max(n, 1) / cap_multiple) * cap_multiple)
    feats = np.zeros((cap, feats_raw.shape[1]), np.float32)
    feats[:n] = feats_raw
    feats[:, -3:] = feats[:, -3:] * 2.0 - 1.0  # upstream :167-168
    valid = np.zeros((cap,), np.float32)
    valid[:n] = 1.0
    coords_p = np.zeros((cap, 3), np.int32)
    coords_p[:n] = coords[:, -3:]
    coords_w = coords_p.astype(np.float32) * res
    base, dense_dims = dense_grid_geometry(coords)
    flat = np.full((cap,), -1, np.int32)
    flat[:n] = dense_flat_ids(coords, base, dense_dims)
    plans = fit_plans(dense_dims)
    tiles = level_tiles(coords, base, dense_dims, **plans)
    shapes = {k: tuple(tile_plan_for_key(k, **plans)[0]) for k in tiles}

    def put(a):
        return torch.from_numpy(a).to(device)

    return SceneArgs(put(feats), put(flat), put(valid), put(coords_w),
                     grid_shape, tuple(dense_dims),
                     {k: put(t) for k, t in tiles.items()}, shapes)


@dataclass
class DetectionPipeline:
    """Joint-model scene detector with the upstream constants."""

    model: torch.nn.Module  # models.dense_unet.DenseMinkUNet
    res: float = 0.03
    num_rots: int = 120
    log_scale: bool = True
    use_xyz: bool = False
    peel: Optional[PeelConfig] = None
    grid_multiple: tuple = (64, 32, 128)
    cap_multiple: int = 4096
    nms_iou: float = 0.3
    # the peel is budgeted (PeelConfig.max_iters / max_boxes) where the
    # upstream loop is not; a budget exit re-runs the tail with 4x the
    # iterations and 2x the boxes, at most max_retries times
    retry_on_truncation: bool = True
    max_retries: int = 2
    device: str = "cuda"

    def __post_init__(self):
        if self.peel is None:
            self.peel = PeelConfig(res=self.res)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionPipeline runs on the GPU and none is "
                               "available; pass device='cpu' to run on the CPU")
        self.model = self.model.to(self.device).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    def prepare_scene(self, points: np.ndarray, rgb: np.ndarray) -> SceneArgs:
        coords, idx = sparse_quantize(points, self.res)
        feats_raw = (np.concatenate([points[idx], rgb[idx]], -1)
                     if self.use_xyz else rgb[idx])
        return self.prepare_quantized(coords, feats_raw)

    def prepare_quantized(self, coords: np.ndarray,
                          feats_raw: np.ndarray) -> SceneArgs:
        return prepare_scene_args(
            coords, feats_raw, res=self.res, cap_multiple=self.cap_multiple,
            grid_multiple=self.grid_multiple, device=self.device)

    def backbone(self, args: SceneArgs) -> torch.Tensor:
        """(cap, Cout) float32 head rows."""
        return self.model(args.feats, args.flat, args.valid, args.dense_dims,
                          args.tiles, args.tile_shapes)

    @torch.no_grad()
    def tail(self, out: torch.Tensor, coords_w: torch.Tensor,
             valid: torch.Tensor, grid_shape: tuple,
             peel: Optional[PeelConfig] = None) -> Dict[str, torch.Tensor]:
        """Head slice -> objectness splat -> peel (rot/scale sampled lazily
        at the peeled cells)."""
        xyz, scale, class_pred, prob = slice_joint_heads(out)
        if self.log_scale:
            scale = torch.exp(scale)
        corners = compute_corners(coords_w, valid)
        corner = corners[0]
        go = hough_voting_obj(coords_w, xyz, scale, prob, res=self.res,
                              num_rots=self.num_rots, grid_shape=grid_shape,
                              corners=corners, valid=valid)
        dims = torch.minimum(
            grid_dims_from_corners(corners, self.res),
            torch.tensor(grid_shape, dtype=torch.int32, device=go.device))

        def rot_scale_fn(cand):
            return vote_stats_at_cell(coords_w, xyz, scale, prob, corner, dims,
                                      self.res, self.num_rots, cand,
                                      valid=valid)

        return peel_boxes(go, coords_w, xyz, prob, class_pred, corner,
                          peel or self.peel, rot_scale_fn, valid=valid)

    def run_scene(self, args: SceneArgs, peel: Optional[PeelConfig] = None):
        out = self.backbone(args)
        return self.tail(out, args.coords_w, args.valid, args.grid_shape, peel)

    def run_scene_with_retry(self, args: SceneArgs):
        """run_scene, re-running the tail with a larger budget while the peel
        reports a budget (not threshold) exit."""
        out = self.backbone(args)
        res = self.tail(out, args.coords_w, args.valid, args.grid_shape)
        if not self.retry_on_truncation:
            return res
        peel = self.peel
        for _ in range(self.max_retries):
            if not bool(res["truncated"]):
                return res
            peel = dataclasses.replace(peel, max_iters=peel.max_iters * 4,
                                       max_boxes=peel.max_boxes * 2)
            res = self.tail(out, args.coords_w, args.valid, args.grid_shape,
                            peel)
        return res

    def postprocess(self, out) -> list:
        """Host NMS + class naming: [(classname, corners (8, 3), score)]."""
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if bool(out["truncated"]):
            warnings.warn(
                "peel_boxes stopped on an iteration/box budget, not the vote "
                "threshold: detections may be incomplete", RuntimeWarning,
                stacklevel=2)
        n = int(out["n_boxes"])
        boxes, scores, classes = (out["boxes"][:n], out["scores"][:n],
                                  out["classes"][:n])
        dets = []
        for i in range(NCLASSES):
            sel = classes == i
            if not sel.any():
                continue
            for j in nms_host(boxes[sel], scores[sel], self.nms_iou):
                dets.append((NAME2CATNAME[IDX2NAME[i]], boxes[sel][j],
                             float(scores[sel][j])))
        return dets

    def detect(self, points: np.ndarray, rgb: np.ndarray) -> list:
        return self.postprocess(
            self.run_scene_with_retry(self.prepare_scene(points, rgb)))
