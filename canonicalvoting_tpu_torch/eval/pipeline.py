"""Joint detection pipeline: voxelize -> backbone -> vote -> peel -> NMS.

Counterpart of ``canonicalvoting_tpu/eval/pipeline.py:DetectionPipeline``
(the upstream inference pass, ``eval_joint.py:163-303``):

  host:   sparse_quantize, then for ``backbone="dense"`` (the default) the
          dense grid geometry and tile lists, or for ``backbone="sparse"``
          the coordinate pyramid and its neighbor tables (``ops/coords.py``,
          uploaded once per scene from one pinned buffer)
  device: the backbone (``DenseMinkUNet`` on the tiled kernels, or the
          gather-form ``MinkUNetBase``) -> head slice -> objectness vote
          splat -> box peeling with rot/scale sampled at peeled cells
          (``lazy_rot_scale=True``), or the 6-channel splat -> box peeling
          on the dense rot/scale grids (``lazy_rot_scale=False``)
  host:   per-class NMS at IoU 0.3, class naming

Both backbones take one state dict. The sparse args pad their rows at
far-away coordinates and the sparse backbone leaves junk in the padding
rows; every tail stage drops the rows whose ``valid`` is 0.

The pipeline runs on the card unless ``device="cpu"`` is asked for; the
default raises where there is no GPU.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from canonicalvoting_tpu_torch.data.dense_prep import (
    dense_flat_ids, dense_grid_geometry, fit_plans, level_tiles,
    tile_plan_for_key)
from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME, NCLASSES
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig, peel_boxes
from canonicalvoting_tpu_torch.metrics.ap import nms as nms_host
from canonicalvoting_tpu_torch.models.dense_unet import STEM_IMPLS, DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import sparse_twin
from canonicalvoting_tpu_torch.ops.coords import (
    PyramidArrays, PyramidSpec, build_pyramid)
from canonicalvoting_tpu_torch.ops.hough_voting import (
    check_hv_method, clipped_grid_dims, compute_corners, hough_voting,
    hough_voting_obj, round_grid_shape, vote_stats_at_cell)
from canonicalvoting_tpu_torch.ops.voxelize import (
    batched_coordinates, sparse_quantize)

BACKBONES = ("dense", "sparse")


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


def slice_separate_heads(out: torch.Tensor):
    """(xyz, scale, prob) of per-category head rows (..., 8): xyz 3 + scale
    3 + binary objectness logits 2 (upstream train_separate.py:247-249)."""
    return out[..., :3], out[..., 3:6], torch.softmax(out[..., 6:8], -1)[..., 1]


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


def _padded_rows(coords: np.ndarray, feats_raw: np.ndarray, cap: int):
    """(feats, valid) padded to ``cap`` rows, the colour columns mapped to
    [-1, 1] (upstream :167-168)."""
    n = len(coords)
    feats = np.zeros((cap, feats_raw.shape[1]), np.float32)
    feats[:n] = feats_raw
    feats[:, -3:] = feats[:, -3:] * 2.0 - 1.0
    valid = np.zeros((cap,), np.float32)
    valid[:n] = 1.0
    return feats, valid


def prepare_scene_args(coords: np.ndarray, feats_raw: np.ndarray, *,
                       res: float, device, cap_multiple: int = 4096,
                       grid_multiple=(64, 32, 128), backbone: str = "dense",
                       cap: Optional[int] = None,
                       grid_shape: Optional[tuple] = None,
                       dense_dims: Optional[tuple] = None):
    """Host prep of one scene for ``backbone`` "dense" (:class:`SceneArgs`:
    padded rows, flat cell ids, tile lists) or "sparse"
    (:class:`SparseSceneArgs`: the pyramid, uploaded once). The row
    capacity, vote grid shape and (dense) interior dims are the scene's
    own, or ``cap`` (every pyramid level's, on the sparse backbone),
    ``grid_shape`` and ``dense_dims`` where a run shares them over its
    scenes (``parallel/scene_parallel.py``)."""
    if backbone == "sparse":
        return sparse_scene_host(coords, feats_raw, res=res,
                                 cap_multiple=cap_multiple,
                                 grid_multiple=grid_multiple, cap=cap,
                                 grid_shape=grid_shape).upload(device)
    if backbone != "dense":
        raise ValueError(f"backbone must be one of {BACKBONES}, got {backbone!r}")
    n = len(coords)
    if grid_shape is None:
        grid_shape = round_grid_shape(scene_extent(coords), grid_multiple)
    if cap is None:
        cap = int(np.ceil(max(n, 1) / cap_multiple) * cap_multiple)
    if n > cap:
        raise ValueError(f"{n} voxels exceed the capacity {cap}")
    feats, valid = _padded_rows(coords, feats_raw, cap)
    coords_p = np.zeros((cap, 3), np.int32)
    coords_p[:n] = coords[:, -3:]
    coords_w = coords_p.astype(np.float32) * res
    base, own_dims = dense_grid_geometry(coords)
    dense_dims = own_dims if dense_dims is None else tuple(dense_dims)
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
class SparseSceneArgs:
    """One scene's prepared inputs for the sparse backbone, on the device.
    ``coords_w`` keeps the pyramid's far-away padding coordinates (the JAX
    package's ``coords_w_s``)."""

    feats: torch.Tensor      # (cap, Cin) float32
    pyramid: Dict            # PyramidArrays.to: int32 tables, host nvalid
    valid: torch.Tensor      # (cap,) float32
    coords_w: torch.Tensor   # (cap, 3) float32 voxel coords * res
    grid_shape: tuple        # vote grid capacity
    table_bytes: int         # the neighbor tables' bytes uploaded


@dataclass
class SparseSceneHost:
    """The host half of the sparse prep: the pyramid and padded rows."""

    pyr: PyramidArrays
    feats: np.ndarray
    coords_w: np.ndarray
    grid_shape: tuple
    pyramid_ms: float        # host time of build_pyramid

    def upload(self, device) -> SparseSceneArgs:
        """Every table and row array in one copy from pinned memory,
        non-blocking on the card."""
        tabs, (feats, coords_w) = self.pyr.to(device, [self.feats, self.coords_w])
        cap = len(self.feats)
        valid = (torch.arange(cap, device=feats.device)
                 < self.pyr.nvalid[0]).float()
        return SparseSceneArgs(feats, tabs, valid, coords_w, self.grid_shape,
                               self.pyr.table_bytes())


def scene_extent(coords: np.ndarray) -> np.ndarray:
    """int32 (3,) voxel extent of a scene, the vote grid's dims before
    rounding."""
    return (coords.max(0) - coords.min(0)).astype(np.int32) + 1


def sparse_scene_host(coords: np.ndarray, feats_raw: np.ndarray, *, res: float,
                      cap_multiple: int, grid_multiple,
                      cap: Optional[int] = None,
                      grid_shape: Optional[tuple] = None) -> SparseSceneHost:
    """The sparse branch of the JAX package's ``prepare_scene_args``
    (``eval/pipeline.py:149-161``) on the host: the pyramid of the scene's
    voxels (native coordinate manager), the padded rows, and the rows'
    world coordinates with the pyramid's far-away padding. ``cap`` fixes
    every level's capacity (the JAX package's scene-parallel collate),
    ``grid_shape`` the vote grid's."""
    if grid_shape is None:
        grid_shape = round_grid_shape(scene_extent(coords), grid_multiple)
    spec = (PyramidSpec(capacities=None, cap_multiple=cap_multiple)
            if cap is None else PyramidSpec(capacities=(cap,) * 5))
    t0 = time.perf_counter()
    pyr = build_pyramid(batched_coordinates([coords]), spec)
    pyramid_ms = (time.perf_counter() - t0) * 1e3
    feats, _ = _padded_rows(coords, feats_raw, pyr.coords[0].shape[0])
    coords_w = pyr.coords[0][:, 1:].astype(np.float32) * res
    return SparseSceneHost(pyr, feats, coords_w, grid_shape, pyramid_ms)


@torch.no_grad()
def vote_and_peel(coords_w: torch.Tensor, xyz: torch.Tensor,
                  scale: torch.Tensor, prob: torch.Tensor,
                  class_pred: torch.Tensor, valid: torch.Tensor, *,
                  res: float, num_rots: int, grid_shape: tuple,
                  peel: PeelConfig, lazy_rot_scale: bool = True,
                  hv_method: str = "auto") -> Dict[str, torch.Tensor]:
    """Vote splat -> peel of one scene's sliced heads (``scale`` in
    metres): the objectness splat with rot/scale sampled at the peeled
    cells (``lazy_rot_scale``), or the 6-channel splat and the dense
    rot/scale grids."""
    corners = compute_corners(coords_w, valid)
    corner = corners[0]
    kw = dict(res=res, num_rots=num_rots, grid_shape=grid_shape,
              corners=corners, valid=valid)
    if not lazy_rot_scale:
        go, gr, gs = hough_voting(coords_w, xyz, scale, prob, **kw)
        return peel_boxes(go, coords_w, xyz, prob, class_pred, corner, peel,
                          valid=valid, grid_rot=gr, grid_scale=gs)
    go = hough_voting_obj(coords_w, xyz, scale, prob, method=hv_method, **kw)
    dims = clipped_grid_dims(corners, res, grid_shape)

    def rot_scale_fn(cand):
        return vote_stats_at_cell(coords_w, xyz, scale, prob, corner, dims,
                                  res, num_rots, cand, valid=valid)

    return peel_boxes(go, coords_w, xyz, prob, class_pred, corner, peel,
                      rot_scale_fn, valid=valid)


@dataclass
class DetectionPipeline:
    """Joint-model scene detector with the upstream constants.

    ``model`` is a ``DenseMinkUNet``, or for ``backbone="sparse"`` a
    ``MinkUNetBase``; a ``DenseMinkUNet`` given to the sparse backbone runs
    its weights on its gather-form twin (``models.sparse_twin``)."""

    model: torch.nn.Module
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
    # True: the objectness splat, with rot/scale sampled at the peeled cells;
    # False: the 6-channel splat and the dense rot/scale grids
    lazy_rot_scale: bool = True
    # the objectness splat's route (ops.hough_voting.HV_METHODS): "auto" and
    # "pallas" the plane splat, "pallas_windowed" the windowed splat; the
    # non-lazy tail's 6-channel splat has one route
    hv_method: str = "auto"
    # the model owns its stem ("tiled" or "prefold"); a value here replaces
    # the model's, None keeps it
    stem_impl: Optional[str] = None
    # "dense": DenseMinkUNet on the tiled kernels; "sparse": the gather-form
    # MinkUNetBase over the scene's coordinate pyramid
    backbone: str = "dense"
    device: str = "cuda"

    def __post_init__(self):
        check_hv_method(self.hv_method)
        if self.backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got "
                             f"{self.backbone!r}")
        if self.peel is None:
            self.peel = PeelConfig(res=self.res)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionPipeline runs on the GPU and none is "
                               "available; pass device='cpu' to run on the CPU")
        if self.backbone == "sparse" and isinstance(self.model, DenseMinkUNet):
            self.model = sparse_twin(self.model)
        if self.stem_impl is not None and self.backbone == "dense":
            if self.stem_impl not in STEM_IMPLS:
                raise ValueError(f"stem_impl must be one of {STEM_IMPLS}, "
                                 f"got {self.stem_impl!r}")
            self.model.stem_impl = self.stem_impl
        self.model = self.model.to(self.device).eval().requires_grad_(False)

    # ------------------------------------------------------------------
    def prepare_scene(self, points: np.ndarray, rgb: np.ndarray) -> SceneArgs:
        coords, idx = sparse_quantize(points, self.res)
        feats_raw = (np.concatenate([points[idx], rgb[idx]], -1)
                     if self.use_xyz else rgb[idx])
        return self.prepare_quantized(coords, feats_raw)

    def prepare_quantized(self, coords: np.ndarray, feats_raw: np.ndarray
                          ) -> Union[SceneArgs, SparseSceneArgs]:
        return prepare_scene_args(
            coords, feats_raw, res=self.res, cap_multiple=self.cap_multiple,
            grid_multiple=self.grid_multiple, device=self.device,
            backbone=self.backbone)

    @torch.no_grad()
    def run_backbone(self, args: Union[SceneArgs, SparseSceneArgs]) -> torch.Tensor:
        """(cap, Cout) float32 head rows: zero at the dense args' padding
        rows, junk at the sparse args' (the tail drops both)."""
        if isinstance(args, SparseSceneArgs):
            return self.model(args.feats, args.pyramid)
        return self.model(args.feats, args.flat, args.valid, args.dense_dims,
                          args.tiles, args.tile_shapes)

    @torch.no_grad()
    def tail(self, out: torch.Tensor, coords_w: torch.Tensor,
             valid: torch.Tensor, grid_shape: tuple,
             peel: Optional[PeelConfig] = None) -> Dict[str, torch.Tensor]:
        """Head slice -> :func:`vote_and_peel` with the pipeline's tail."""
        xyz, scale, class_pred, prob = slice_joint_heads(out)
        if self.log_scale:
            scale = torch.exp(scale)
        return vote_and_peel(coords_w, xyz, scale, prob, class_pred, valid,
                             res=self.res, num_rots=self.num_rots,
                             grid_shape=grid_shape, peel=peel or self.peel,
                             lazy_rot_scale=self.lazy_rot_scale,
                             hv_method=self.hv_method)

    def run_scene(self, args: SceneArgs, peel: Optional[PeelConfig] = None):
        out = self.run_backbone(args)
        return self.tail(out, args.coords_w, args.valid, args.grid_shape, peel)

    def run_scene_with_retry(self, args: SceneArgs):
        """run_scene, re-running the tail with a larger budget while the peel
        reports a budget (not threshold) exit."""
        out = self.run_backbone(args)
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
