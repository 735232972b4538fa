"""SUN RGB-D: the canonical-voting proposal sampler for BRNet."""

from canonicalvoting_tpu_torch.sunrgbd.proposal import (  # noqa: F401
    HoughVotingProposal,
    farthest_point_sample,
    query_ball_point,
    square_distance,
)
