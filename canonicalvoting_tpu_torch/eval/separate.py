"""Per-category (separate) evaluation: nine MinkUNet34C(3, 8) models over
one scene.

Counterpart of ``canonicalvoting_tpu/eval/separate.py:SeparateDetectionPipeline``
(the upstream ``eval_separate.py:165-186``), on its dense path
(``backbone="dense"``, tiled kernels, ``stem_impl="prefold"``):

  host:   sparse_quantize, dense grid geometry, tile lists (once per scene)
  device: the scene's shared grids, once: scatter grid, occupancy pyramid
          and the stem's (dy, dz) fold; then, per category (the JAX
          package's ``lax.scan`` over stacked weights), the backbone on those
          grids -> head slice; then one objectness splat for all categories
          (a category axis on the kernel's grid) and one batched peel over
          the categories' vote grids
  host:   per-category NMS

or on its gather-form path (``backbone="sparse"``): one coordinate pyramid a
scene (uploaded once), nine sparse ``MinkUNetBase`` passes over it, then the
same batched tail. The JAX package vmaps backbone, vote and peel over the
categories there (``separate.py:205-225``); the batched tail computes the
same function.

The categories' weights are stacked on a leading axis (``stack_state_dicts``)
and each category's pass is ``torch.func.functional_call`` of one module
with its slice; the prefolded stem's folded weights and the four down
convs' K-major weights are built once per category (or group) when the
weights are installed. With ``group_size`` N >
1 the categories are packed N at a time into block-diagonal grouped nets
(``eval/grouped.py``); the sparse path takes one category a pass, as the
JAX package's does.

The pipeline runs on the card unless ``device="cpu"`` is asked for; the
default raises where there is no GPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from canonicalvoting_tpu_torch.decode.peeling import PeelConfig, peel_boxes_batched
from canonicalvoting_tpu_torch.eval.grouped import (
    build_grouped_state, grouped_model_config)
from canonicalvoting_tpu_torch.eval.pipeline import (
    BACKBONES, SceneArgs, SparseSceneArgs, prepare_scene_args,
    slice_separate_heads)
from canonicalvoting_tpu_torch.metrics.ap import nms as nms_host
from canonicalvoting_tpu_torch.models.dense_unet import (
    DOWN_KERNELS, DenseMinkUNet, shared_scene_grids)
from canonicalvoting_tpu_torch.models.minkunet import sparse_plan
from canonicalvoting_tpu_torch.ops.hough_voting import (
    check_hv_method, clipped_grid_dims, compute_corners, hough_voting,
    hough_voting_obj, vote_stats_at_cell)

#: category order of the separate evaluator (upstream eval_separate.py:92)
ALL_CATEGORIES = [
    "others", "display", "table", "bathtub", "trashbin", "sofa", "chair",
    "cabinet", "bookshelf",
]


def stack_state_dicts(state_dicts: List[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """Per-model state dicts stacked on a new leading axis (the JAX
    package's ``stack_variables``), in float32."""
    return {k: torch.stack([sd[k].float() for sd in state_dicts])
            for k in state_dicts[0]}


@dataclass
class SeparateDetectionPipeline:
    """Nine per-category detectors over one scene.

    ``model`` gives the per-category plan (out_channels 8); its own weights
    are not used. The weights are ``state_dicts``, one per category, or
    :meth:`set_state_dicts`.
    """

    model: DenseMinkUNet
    state_dicts: Optional[List[Dict[str, torch.Tensor]]] = None
    categories: Optional[List[str]] = None
    # pack this many categories into one block-diagonal grouped net
    group_size: int = 1
    res: float = 0.03
    num_rots: int = 120
    log_scale: bool = True
    peel: Optional[PeelConfig] = None
    nms_iou: float = 0.3
    grid_multiple: tuple = (64, 32, 128)
    cap_multiple: int = 4096
    backbone: str = "dense"
    # "prefold": the stem's (dy, dz) fold is built once per scene and every
    # category's k=5 stem runs over it; "tiled": each runs the 3-channel grid
    stem_impl: str = "prefold"
    # True: objectness splats and rot/scale sampled at the peeled cells;
    # False: one 6-channel splat of the categories and the dense rot/scale
    # grids
    lazy_rot_scale: bool = True
    # the objectness splats' route, as DetectionPipeline.hv_method
    hv_method: str = "auto"
    # the peel's budget exit re-runs the tail (not the backbones) with 4x the
    # iterations and 2x the boxes, at most max_retries times
    retry_on_truncation: bool = True
    max_retries: int = 2
    device: str = "cuda"

    def __post_init__(self):
        if self.backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got "
                             f"{self.backbone!r}")
        if self.backbone == "sparse" and self.group_size != 1:
            raise ValueError("the sparse backbone runs one category a pass "
                             "(group_size=1), as the JAX package's does")
        check_hv_method(self.hv_method)
        if self.categories is None:
            self.categories = list(ALL_CATEGORIES)
        if self.peel is None:
            # upstream eval_separate.py:209 uses the exclusive elimination
            self.peel = PeelConfig(res=self.res, elimination_inclusive=False)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SeparateDetectionPipeline runs on the GPU and "
                               "none is available; pass device='cpu' to run "
                               "on the CPU")
        cfg = self.model.config()
        cfg["stem_impl"] = self.stem_impl
        self.plan = DenseMinkUNet(**cfg)
        if self.backbone == "sparse":
            net = sparse_plan(self.plan)
        elif self.group_size == 1:
            net = self.plan
        else:
            net = DenseMinkUNet(**grouped_model_config(self.plan,
                                                       self.group_size))
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.stacked = None
        self.stem_wt = None  # per group: the prefolded stem's folded weights
        self.down_wt = None  # per group: the four downs' K-major weights
        if self.state_dicts is not None:
            self.set_state_dicts(self.state_dicts)
            self.state_dicts = None

    def set_state_dicts(self, state_dicts: List[Dict[str, torch.Tensor]]):
        """Install one state dict per category. With ``group_size`` N > 1
        the categories pack into ceil(C / N) grouped nets, the last group
        padded by repeating the last category (its rows are dropped)."""
        n, C = self.group_size, len(self.categories)
        if len(state_dicts) != C:
            raise ValueError(f"{len(state_dicts)} state dicts for {C} categories")
        groups = list(state_dicts)
        if n > 1:
            groups += [groups[-1]] * ((-C) % n)
            groups = [build_grouped_state(groups[i:i + n], self.plan)
                      for i in range(0, len(groups), n)]
        self.stacked = {k: v.to(self.device)
                        for k, v in stack_state_dicts(groups).items()}
        if self.backbone == "sparse":
            return
        self.stem_wt = None if self.stem_impl != "prefold" else [
            self.net.fold_stem(w) for w in self.stacked["conv0p1s1.kernel"]]
        self.down_wt = [self.net.fold_downs(ws) for ws in
                        zip(*(self.stacked[k] for k in DOWN_KERNELS))]

    # ------------------------------------------------------------------
    def prepare_quantized(self, coords: np.ndarray, feats_raw: np.ndarray):
        """Host prep of one scene, shared by every category: a
        ``SceneArgs`` (dense) or ``SparseSceneArgs`` (sparse)."""
        return prepare_scene_args(
            coords, feats_raw, res=self.res, cap_multiple=self.cap_multiple,
            grid_multiple=self.grid_multiple, device=self.device,
            backbone=self.backbone)

    @torch.no_grad()
    def shared_grids(self, args: SceneArgs) -> Dict[str, object]:
        """The scene's weight-independent grids, built once for all
        categories."""
        m = self.plan
        return shared_scene_grids(
            args.feats, args.flat, args.valid, args.dense_dims,
            in_channels=m.in_channels, stem_kernel=m.stem_kernel,
            compute_dtype=m.compute_dtype, stem_impl=self.stem_impl)

    @torch.no_grad()
    def backbones(self, args: SceneArgs,
                  shared: Optional[Dict[str, object]] = None) -> torch.Tensor:
        """(C, cap, 8) head rows, one backbone pass per category (or group)
        over the shared grids, or one sparse pass per category over the
        scene's pyramid."""
        if self.stacked is None:
            raise RuntimeError("no weights: pass state_dicts or call "
                               "set_state_dicts")
        if isinstance(args, SparseSceneArgs):
            return torch.stack([functional_call(
                self.net, {k: v[c] for k, v in self.stacked.items()},
                (args.feats, args.pyramid)) for c in range(len(self.categories))])
        if shared is None:
            shared = self.shared_grids(args)
        n, out_ch = self.group_size, self.plan.out_channels
        n_groups = next(iter(self.stacked.values())).shape[0]
        heads = []
        for g in range(n_groups):
            kw = {"shared": shared, "down_wt": self.down_wt[g]}
            if self.stem_wt is not None:
                kw["stem_wt"] = self.stem_wt[g]
            rows = functional_call(
                self.net, {k: v[g] for k, v in self.stacked.items()},
                (args.feats, args.flat, args.valid, args.dense_dims,
                 args.tiles, args.tile_shapes), kw)
            heads.extend(rows[:, c * out_ch:(c + 1) * out_ch] for c in range(n))
        return torch.stack(heads[:len(self.categories)])

    @torch.no_grad()
    def vote(self, heads: torch.Tensor, args: SceneArgs) -> Dict[str, object]:
        """Head slice -> the categories' vote grids, stacked: the objectness
        grids of one splat over every category (lazy), or the objectness,
        rotation and scale grids of one 6-channel splat over every
        category."""
        xyz, scale, prob = slice_separate_heads(heads)
        if self.log_scale:
            scale = torch.exp(scale)
        corners = compute_corners(args.coords_w, args.valid)
        kw = dict(res=self.res, num_rots=self.num_rots,
                  grid_shape=args.grid_shape, corners=corners, valid=args.valid)
        if self.lazy_rot_scale:
            grids = (hough_voting_obj(args.coords_w, xyz, scale, prob,
                                      method=self.hv_method, **kw), None, None)
        else:
            grids = hough_voting(args.coords_w, xyz, scale, prob, **kw)
        return {"grids": grids, "xyz": xyz, "scale": scale, "prob": prob,
                "corners": corners}

    @torch.no_grad()
    def peel_votes(self, votes: Dict[str, object], args: SceneArgs,
                   peel: Optional[PeelConfig] = None) -> Dict[str, torch.Tensor]:
        """One batched peel over the categories' vote grids."""
        go, gr, gs = votes["grids"]
        xyz, scale, prob = votes["xyz"], votes["scale"], votes["prob"]
        corners = votes["corners"]
        corner = corners[0]
        rot_scale_fn = None
        if gr is None:
            dims = clipped_grid_dims(corners, self.res, args.grid_shape)

            def rot_scale_fn(cells):
                return vote_stats_at_cell(args.coords_w, xyz, scale, prob,
                                          corner, dims, self.res,
                                          self.num_rots, cells,
                                          valid=args.valid)

        return peel_boxes_batched(go, args.coords_w, xyz, prob, None, corner,
                                  peel or self.peel, rot_scale_fn,
                                  valid=args.valid, grid_rot=gr, grid_scale=gs)

    def tail(self, heads: torch.Tensor, args: SceneArgs,
             peel: Optional[PeelConfig] = None) -> Dict[str, torch.Tensor]:
        return self.peel_votes(self.vote(heads, args), args, peel)

    def _heads(self, args: SceneArgs, planted) -> torch.Tensor:
        heads = self.backbones(args)
        if planted is None:
            return heads
        # the backbones still run; the tail decodes the planted rows
        planted = torch.as_tensor(planted, dtype=torch.float32,
                                  device=self.device)
        if planted.shape != heads.shape:
            raise ValueError(f"planted rows {tuple(planted.shape)} do not "
                             f"match the heads {tuple(heads.shape)}")
        return planted

    def run_scene(self, args: SceneArgs, peel: Optional[PeelConfig] = None,
                  planted=None) -> Dict[str, torch.Tensor]:
        """Every category over one scene: outputs with a leading category
        axis. ``planted`` (C, cap, 8) head rows replace the backbones'
        output in the tail (the detection-bearing hook of the tests and of
        ``chip_smoke.py``; the backbones still run)."""
        return self.tail(self._heads(args, planted), args, peel)

    def run_scene_with_retry(self, args: SceneArgs, planted=None):
        """run_scene, re-running the tail with a larger budget while any
        category's peel reports a budget (not threshold) exit."""
        heads = self._heads(args, planted)
        out = self.tail(heads, args)
        if not self.retry_on_truncation:
            return out
        peel = self.peel
        for _ in range(self.max_retries):
            if not bool(out["truncated"].any()):
                return out
            peel = dataclasses.replace(peel, max_iters=peel.max_iters * 4,
                                       max_boxes=peel.max_boxes * 2)
            out = self.tail(heads, args, peel)
        return out

    def postprocess(self, out) -> list:
        """Host NMS per category: [(category, corners (8, 3), score)]."""
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if bool(out["truncated"].any()):
            warnings.warn(
                "peel_boxes stopped on an iteration/box budget, not the vote "
                "threshold: detections may be incomplete", RuntimeWarning,
                stacklevel=2)
        dets = []
        for ci, category in enumerate(self.categories):
            n = int(out["n_boxes"][ci])
            boxes, scores = out["boxes"][ci, :n], out["scores"][ci, :n]
            for j in nms_host(boxes, scores, self.nms_iou):
                dets.append((category, boxes[j], float(scores[j])))
        return dets

    def detect(self, coords: np.ndarray, feats_raw: np.ndarray) -> list:
        """A quantized scene -> detections across all categories."""
        return self.postprocess(self.run_scene_with_retry(
            self.prepare_quantized(coords, feats_raw)))
