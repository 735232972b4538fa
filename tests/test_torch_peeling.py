"""The port's peel_boxes against the JAX package's on the same vote grid,
with rot/scale sampled lazily at the peeled cells in both."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canonicalvoting_tpu.ops.hough_voting  # noqa: F401  (module, not the function)
from canonicalvoting_tpu.decode.peeling import PeelConfig as JaxPeelConfig
from canonicalvoting_tpu.decode.peeling import peel_boxes as jax_peel_boxes

from canonicalvoting_tpu_torch.decode.peeling import PeelConfig, peel_boxes
from canonicalvoting_tpu_torch.ops.hough_voting import vote_stats_at_cell

from tests.test_peeling import _scene_with_boxes
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)

jhv = sys.modules["canonicalvoting_tpu.ops.hough_voting"]

RES, ROTS = 0.06, 24


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    specs = [
        (np.array([1.0, 0.6, 1.0], np.float32),
         np.array([0.45, 0.5, 0.35], np.float32), 0.4),
        (np.array([3.0, 0.5, 2.8], np.float32),
         np.array([0.5, 0.4, 0.5], np.float32), -0.9),
    ]
    points, xyz, scl, prob, cls = _scene_with_boxes(rng, specs)
    valid = np.ones(len(points), np.float32)
    valid[::50] = 0.0
    corners = np.asarray(jhv.compute_corners(jnp.asarray(points),
                                             jnp.asarray(valid)))
    gshape = tuple(int(d) for d in ((corners[1] - corners[0]) / RES)
                   .astype(np.int32) + 1)
    go = np.asarray(jhv.hough_voting_obj(
        *[jnp.asarray(a) for a in (points, xyz, scl, prob)], res=RES,
        num_rots=ROTS, grid_shape=gshape, corners=jnp.asarray(corners),
        valid=jnp.asarray(valid), method="xla"))
    return points, xyz, scl, prob, cls, valid, corners, gshape, go


def _run_jax(scene, **cfg_kw):
    points, xyz, scl, prob, cls, valid, corners, gshape, go = scene
    cfg = JaxPeelConfig(res=RES, **cfg_kw)
    dims = jnp.asarray(gshape, jnp.int32)
    corner = jnp.asarray(corners[0])

    def rs(cand):
        return jhv.vote_stats_at_cell(
            *[jnp.asarray(a) for a in (points, xyz, scl, prob)], corner, dims,
            RES, ROTS, cand, valid=jnp.asarray(valid))

    out = jax.jit(lambda g: jax_peel_boxes(
        g, None, None, points, xyz, prob, cls, corner, cfg,
        valid=jnp.asarray(valid), rot_scale_fn=rs))(jnp.asarray(go))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(scene, **cfg_kw):
    points, xyz, scl, prob, cls, valid, corners, gshape, go = scene
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        points=points, xyz=xyz, scl=scl, prob=prob, cls=cls, valid=valid,
        corner=corners[0], go=go).items()}
    dims = torch.tensor(gshape, dtype=torch.int32)

    def rs(cand):
        return vote_stats_at_cell(t["points"], t["xyz"], t["scl"], t["prob"],
                                  t["corner"], dims, RES, ROTS, cand,
                                  valid=t["valid"])

    out = peel_boxes(t["go"], t["points"], t["xyz"], t["prob"], t["cls"],
                     t["corner"], PeelConfig(res=RES, **cfg_kw), rs,
                     valid=t["valid"])
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("cfg", [
    dict(max_boxes=16, max_iters=64),   # threshold exit, both boxes
    dict(max_boxes=16, max_iters=3),    # iteration budget exit
    dict(max_boxes=1, max_iters=64),    # box budget: drops, truncated
    dict(max_boxes=16, max_iters=64, elimination_inclusive=False),
], ids=["threshold", "iter_budget", "box_budget", "exclusive"])
def test_peel_matches_jax(scene, cfg):
    want = _run_jax(scene, **cfg)
    got = _run_port(scene, **cfg)
    n = int(want["n_boxes"])
    assert int(got["n_boxes"]) == n
    for k in ("exit_on_threshold", "n_dropped", "truncated"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["classes"][:n], want["classes"][:n])
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    np.testing.assert_allclose(got["boxes"][:n], want["boxes"][:n], atol=2e-4)
    np.testing.assert_allclose(got["scores"][:n], want["scores"][:n], atol=1e-6)
    if cfg["max_iters"] == 64 and cfg["max_boxes"] == 16:
        assert n == 2
