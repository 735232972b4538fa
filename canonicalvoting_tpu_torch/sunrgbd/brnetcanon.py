"""BRNetCanon's proposal injection: canonical-voting proposals for BRNet.

The port's counterpart of ``canonicalvoting_tpu/sunrgbd/brnetcanon.py``.
Upstream registers ``BRNetCanon(TwoStage3DDetector)`` in mmdetection3d and,
with ``sample_mod == 'custom'``, replaces BRNet's FPS proposal sampling by
Canonical-Voting proposals (upstream ``sunrgbd/brnetcanon.py:170-352``); the
mmdet3d detector itself is external upstream too. :class:`BRNetCanonSampler`
is the block that ``forward_train`` (:210-249) and ``simple_test``
(:299-338) share:

  * a FROZEN MinkUNet34C(3, 8) voting backbone (the gather-form
    ``MinkUNetBase``), loaded once from a checkpoint nested under
    ``model_state_dict`` (:165-167, :func:`load_reference_checkpoint`);
  * per sample: the axis permutation ``[0, 2, 1]`` between mmdet3d's z-up
    and ScanNet's y-up axes (:217, :243-245), ``sparse_quantize`` at
    0.03 m with the permuted points as features (:218-225), the backbone
    under no-grad (:213, :226), the heads xyz / exp(scale) / softmax prob
    (:233-234), explicit min/max corners with border 0 (:236-240);
  * Hough voting at res 0.05, 60 rotations and 512 proposals with the
    vote-seed rejection at 0.3 m (:165, :242 -> :114-162);
  * the ``feats_dict`` keys the BRNet rpn head reads: ``proposals`` (B, P,
    3), ``probs`` (B, P), ``scales`` (B, P, 3), in mmdet3d axes
    (:247-249), as tensors on the sampler's device.

The sampler runs on the card unless ``device="cpu"`` is asked for; the
default raises where there is no GPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from canonicalvoting_tpu_torch.models.minkunet import MinkUNet34C, MinkUNetBase
from canonicalvoting_tpu_torch.ops.coords import PyramidSpec, build_pyramid
from canonicalvoting_tpu_torch.ops.hough_voting import (
    compute_corners, round_grid_shape)
from canonicalvoting_tpu_torch.ops.voxelize import (
    batched_coordinates, sparse_quantize)
from canonicalvoting_tpu_torch.sunrgbd.proposal import HoughVotingProposal
from canonicalvoting_tpu_torch.utils.weights import load_pth

#: mmdet3d (x, y, z) <-> ScanNet (x, z, y), its own inverse
#: (upstream brnetcanon.py:217, :243-245)
AXIS_PERMUTE = (0, 2, 1)


@dataclass
class BRNetCanonSampler:
    """The upstream ``sample_mod == 'custom'`` proposal block
    (brnetcanon.py:210-249 / :299-338). ``model`` is the frozen voting
    backbone, a ``MinkUNetBase`` with 8 head channels (MinkUNet34C(3, 8)
    upstream); load the reference checkpoint with
    :func:`load_reference_checkpoint`."""

    model: MinkUNetBase
    quant_res: float = 0.03      # sparse_quantize size (brnetcanon.py:221)
    hv_res: float = 0.05         # voting grid res (:165)
    num_rots: int = 60           # (:165)
    num_proposal: int = 512      # (:165)
    reject_radius: float = 0.3   # (:145-152)
    pow: float = 0.5             # top-down map exponent (:242)
    border: float = 0.0          # corner padding (:211)
    cap_multiple: int = 4096
    grid_multiple: tuple = (16, 16, 16)
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BRNetCanonSampler runs on the GPU and none is "
                               "available; pass device='cpu' to run on the CPU")
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self.sampler = HoughVotingProposal(
            res=self.hv_res, num_rots=self.num_rots,
            num_proposal=self.num_proposal, reject_radius=self.reject_radius,
            pow=self.pow)

    def prepare(self, points: np.ndarray):
        """Host prep of one sample (mmdet3d axes in): the pyramid of its
        0.03 m voxels, the padded feature rows (the permuted points), the
        rows' world coordinates (zero at padding) and the vote grid's
        capacity."""
        pc = np.asarray(points, np.float32)[:, AXIS_PERMUTE]  # (:217)
        coords, idx = sparse_quantize(pc, self.quant_res)      # (:218-225)
        pyr = build_pyramid(batched_coordinates([coords]),
                            PyramidSpec(cap_multiple=self.cap_multiple))
        cap, n = pyr.coords[0].shape[0], len(coords)
        feats = np.zeros((cap, 3), np.float32)
        feats[:n] = pc[idx]
        pc_w = np.zeros((cap, 3), np.float32)
        pc_w[:n] = pyr.coords[0][:n, 1:].astype(np.float32) * self.quant_res
        dims = (coords.max(0) - coords.min(0)) * (self.quant_res / self.hv_res) + 1
        grid_shape = round_grid_shape(dims.astype(np.int32) + 1,
                                      self.grid_multiple)
        return pyr, feats, pc_w, grid_shape

    @torch.no_grad()
    def propose_one(self, points: np.ndarray, vote_points: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
        """(candidates, probs, scales) of one sample, in ScanNet axes;
        ``vote_points`` (V, 3) in ScanNet axes on the device."""
        pyr, feats, pc_w, grid_shape = self.prepare(points)
        tabs, (feats, pc_w) = pyr.to(self.device, [feats, pc_w])
        out = self.model(feats, tabs)
        xyz = out[:, :3]
        scale = torch.exp(out[:, 3:6])                            # (:234)
        prob = torch.softmax(out[:, 6:8], -1)[:, 1]
        valid = (torch.arange(len(feats), device=self.device)
                 < pyr.nvalid[0]).float()
        corners = compute_corners(pc_w, valid)
        # the border widens x and z only (:237-240); 0 upstream
        pad = torch.tensor([self.border, 0.0, self.border], device=self.device)
        corners = torch.stack([corners[0] - pad, corners[1] + pad])
        return self.sampler(pc_w, xyz, scale, prob, corners, vote_points,
                            grid_shape, generator, valid)

    def propose(self, points: List[np.ndarray], vote_points,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The custom-sampling block over a batch: ``points`` a list of B
        (N_i, 3) clouds in mmdet3d axes, ``vote_points`` (B, V, 3) BRNet
        vote seeds in the same axes; the draws come from ``generator`` (on
        the sampler's device), one sample after another."""
        perm = list(AXIS_PERMUTE)
        seeds = torch.as_tensor(np.asarray(vote_points, np.float32),
                                device=self.device)[..., perm]    # (:242)
        proposals, probs, scales = [], [], []
        for i, pts in enumerate(points):
            cand, prob, scl = self.propose_one(pts, seeds[i], generator)
            proposals.append(cand[:, perm])                       # (:243)
            probs.append(prob)
            scales.append(scl[:, perm])                           # (:245)
        return {"proposals": torch.stack(proposals),              # (:247)
                "probs": torch.stack(probs),                      # (:248)
                "scales": torch.stack(scales)}                    # (:249)

    # both upstream entry points run the same block (brnetcanon.py:191/:288)
    def forward_train_proposals(self, points, vote_points, generator=None):
        return self.propose(points, vote_points, generator)

    def simple_test_proposals(self, points, vote_points, generator=None):
        return self.propose(points, vote_points, generator)


def load_reference_checkpoint(path: str,
                              model: Optional[MinkUNetBase] = None
                              ) -> MinkUNetBase:
    """The upstream SUN RGB-D backbone checkpoint (``sunrgbd/checkpoint.pth``,
    its state dict nested under ``model_state_dict``, brnetcanon.py:167)
    loaded into ``model`` (default: a MinkUNet34C(3, 8))."""
    return load_pth(MinkUNet34C(3, 8) if model is None else model, path)
