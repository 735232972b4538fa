"""SUN RGB-D canonical-voting proposal sampler (BRNetCanon integration).

The port's counterpart of ``canonicalvoting_tpu/sunrgbd/proposal.py`` (the
upstream ``HoughVotingModule`` and point utilities,
``sunrgbd/brnetcanon.py:16-162``):

  * :class:`HoughVotingProposal`: Hough voting with explicit corners (the
    6-channel splat, ``ops/hough_voting.py:hough_voting``), a top-down map
    (max over y, ``pow`` 0.5), then multinomial proposal draws that KEEP
    the candidates within ``reject_radius`` of a vote seed (all draws when
    none qualifies). Upstream's rejection loop is a fixed oversample and a
    stable selection, as in the JAX package: draws are made with
    replacement from the same distribution, so the proposal law is the
    same. The draw (:meth:`HoughVotingProposal.draw`, from an explicit
    ``torch.Generator``) is apart from the selection
    (:meth:`HoughVotingProposal.select`), which is deterministic.
  * :func:`farthest_point_sample`, :func:`square_distance`,
    :func:`query_ball_point`: the PointNet++ utilities (``:16-82``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from canonicalvoting_tpu_torch.ops.hough_voting import hough_voting


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (B, N, M) (upstream brnetcanon.py:40-59)."""
    d = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    d = d + (src ** 2).sum(-1)[:, :, None]
    return d + (dst ** 2).sum(-1)[:, None, :]


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """FPS indices (B, npoint) from the start indices ``start`` (B,), drawn
    uniformly from ``generator`` when not given (upstream :16-37)."""
    B, N, _ = xyz.shape
    if start is None:
        start = torch.randint(0, N, (B,), generator=generator,
                              device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    farthest = start.long()
    out = []
    for _ in range(npoint):
        out.append(farthest)
        centroid = xyz.gather(1, farthest[:, None, None].expand(B, 1, 3))
        distance = torch.minimum(distance, ((xyz - centroid) ** 2).sum(-1))
        farthest = torch.argmax(distance, -1)
    return torch.stack(out, 1)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Ball-query group indices (B, S, nsample) (upstream :62-82): the first
    ``nsample`` points within ``radius`` in index order, backfilled with the
    first of them."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    sqr = square_distance(new_xyz, xyz)
    idx = torch.arange(N, dtype=torch.int32, device=xyz.device).expand(B, S, N)
    idx = torch.where(sqr > radius ** 2, torch.full_like(idx, N), idx)
    idx = torch.sort(idx, -1).values[:, :, :nsample]
    first = idx[:, :, :1].expand_as(idx)
    return torch.where(idx == N, first, idx)


@dataclass
class HoughVotingProposal:
    """Proposal sampler (upstream brnetcanon.py:104-162). BRNetCanon's
    values: res 0.05, 60 rotations, 512 proposals (:165)."""

    res: float = 0.03
    num_rots: int = 36
    num_proposal: int = 256
    reject_radius: float = 0.3
    oversample: int = 4
    pow: float = 0.5

    def maps(self, pc, xyz, scale, prob, corners, grid_shape, valid=None):
        """(dist (gx * gz,), y index (gx, gz), scale grid (gx, gy, gz, 3)):
        the top-down map the draws follow, flat; the y of each column's
        maximum; the normalized scale votes."""
        hv_map, _, hv_scale = hough_voting(
            pc, xyz, scale, prob, res=self.res, num_rots=self.num_rots,
            grid_shape=tuple(grid_shape), corners=corners, valid=valid)
        hv_y = torch.pow(hv_map.max(1).values + 1e-7, self.pow)
        yidx = hv_map.argmax(1)
        dist = hv_y.reshape(-1)
        bad = ~torch.isfinite(dist).all() | (dist.sum() < 1e-7)
        dist = torch.where(bad, torch.ones_like(dist), dist)  # (:128-129)
        return dist, yidx, hv_scale

    def draw(self, dist: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """num_proposal * oversample flat cells drawn with replacement,
        each with probability proportional to ``dist``."""
        return torch.multinomial(dist, self.num_proposal * self.oversample,
                                 replacement=True, generator=generator)

    def select(self, draws, yidx, hv_scale, corners, vote_points):
        """(candidates (P, 3), probs (P,), scales (P, 3)) of the drawn cells:
        the first ``num_proposal`` draws within ``reject_radius`` of a vote
        seed, backfilled in draw order with the others (upstream :135-161;
        all draws when none is near a seed)."""
        gz = yidx.shape[1]
        ix, iz = draws // gz, draws % gz
        iy = yidx[ix, iz]
        world = torch.stack([ix, iy, iz], -1).float() * self.res + corners[0]
        d2seed = torch.linalg.norm(world[:, None, :] - vote_points[None],
                                   dim=-1).min(-1).values
        near = d2seed < self.reject_radius
        keep = torch.where(near.any(), near, torch.ones_like(near))
        order = torch.argsort((~keep).to(torch.int32), stable=True)
        sel = order[:self.num_proposal]
        candidates = world[sel]
        return (candidates, torch.zeros_like(candidates[:, 0]),
                hv_scale[ix, iy, iz][sel])

    def __call__(self, pc, xyz, scale, prob, corners, vote_points,
                 grid_shape: Tuple[int, int, int],
                 generator: Optional[torch.Generator] = None, valid=None):
        dist, yidx, hv_scale = self.maps(pc, xyz, scale, prob, corners,
                                         grid_shape, valid)
        return self.select(self.draw(dist, generator), yidx, hv_scale,
                           corners, vote_points)
