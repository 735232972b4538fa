"""The port's SUN RGB-D proposal sampler (sunrgbd/) against the JAX
package's on the CPU: the point utilities, the proposal maps (within 1e-5
of their peak), the selection bit for bit given JAX's draws, and the
BRNetCanonSampler contract (tests/test_sunrgbd.py:87)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops.hough_voting import hough_voting as jax_hough_voting
from canonicalvoting_tpu.sunrgbd import proposal as J
from canonicalvoting_tpu.train.checkpoint import export_torch_style

from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.sunrgbd import (
    HoughVotingProposal, farthest_point_sample, query_ball_point,
    square_distance)
from canonicalvoting_tpu_torch.sunrgbd.brnetcanon import (
    AXIS_PERMUTE, BRNetCanonSampler, load_reference_checkpoint)

from tests.test_sunrgbd import _two_blob_scene
from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

TINY = dict(layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8), init_dim=8,
            compute_dtype="float32")


def test_point_utilities_match_jax():
    rng = np.random.RandomState(0)
    src = rng.randn(2, 40, 3).astype(np.float32)
    dst = rng.randn(2, 30, 3).astype(np.float32)
    np.testing.assert_allclose(
        square_distance(torch.from_numpy(src), torch.from_numpy(dst)).numpy(),
        J.square_distance(src, dst), rtol=1e-6, atol=1e-5)
    xyz = rng.uniform(0, 1, (2, 200, 3)).astype(np.float32)
    got = query_ball_point(0.2, 8, torch.from_numpy(xyz),
                           torch.from_numpy(xyz[:, :17]))
    np.testing.assert_array_equal(got.numpy(),
                                  J.query_ball_point(0.2, 8, xyz, xyz[:, :17]))
    # FPS from the start indices JAX draws from the same key
    key = jax.random.PRNGKey(3)
    start = np.asarray(jax.random.randint(key, (2,), 0, 200))
    got = farthest_point_sample(torch.from_numpy(xyz), 24,
                                start=torch.from_numpy(np.array(start)))
    np.testing.assert_array_equal(got.numpy(),
                                  J.farthest_point_sample(xyz, 24, key))
    drawn = farthest_point_sample(torch.from_numpy(xyz), 4,
                                  generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 4)


def _jax_maps(sampler, pc, xyz, scl, prob, corners, grid_shape):
    """The maps JAX's HoughVotingProposal.__call__ forms, outside it."""
    hv_map, _, hv_scale = jax_hough_voting(
        pc, xyz, scl, prob, res=sampler.res, num_rots=sampler.num_rots,
        grid_shape=grid_shape, corners=corners)
    hv_y = jnp.power(jnp.max(hv_map, axis=1) + 1e-7, sampler.pow)
    return (np.array(hv_y).reshape(-1), np.array(jnp.argmax(hv_map, axis=1)),
            np.array(hv_scale))


@pytest.mark.parametrize("seeds", ["none_near", "at_object_a"])
def test_proposal_maps_and_selection_match_jax(seeds):
    """Maps within 1e-5 of their peak; given JAX's draws and maps, the
    selected candidates and scales equal JAX's bit for bit."""
    pc, xyz, scl, prob, corners, centers = _two_blob_scene(
        np.random.RandomState(0))
    vote_points = (np.full((8, 3), 50.0, np.float32) if seeds == "none_near"
                   else np.broadcast_to(centers[0], (8, 3)).astype(np.float32))
    kw = dict(res=0.05, num_rots=36, num_proposal=64, oversample=4)
    grid_shape = (64, 32, 64)
    theirs, ours = J.HoughVotingProposal(**kw), HoughVotingProposal(**kw)
    key = jax.random.PRNGKey(0)
    want = theirs(pc, xyz, scl, prob, corners, vote_points, key=key,
                  grid_shape=grid_shape)
    dist_j, yidx_j, scale_j = _jax_maps(theirs, pc, xyz, scl, prob, corners,
                                        grid_shape)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pc, xyz, scl, prob, corners)]
    dist, yidx, hv_scale = ours.maps(*t, grid_shape)
    for g, w in ((dist, dist_j), (hv_scale, scale_j)):
        assert float((g - torch.from_numpy(w)).abs().max()) <= 1e-5 * float(
            np.abs(w).max())
    draws = jax.random.categorical(
        key, jnp.log(jnp.maximum(dist_j, 1e-30)),
        shape=(kw["num_proposal"] * kw["oversample"],))
    got = ours.select(torch.from_numpy(np.array(draws)).long(),
                      torch.from_numpy(yidx_j).long(), torch.from_numpy(scale_j),
                      t[4], torch.from_numpy(vote_points))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the port's own draw follows its map: every drawn cell has weight
    cells = ours.draw(dist, torch.Generator().manual_seed(1))
    assert bool((dist[cells] > 0).all())


def _sampler(model, **kw):
    return BRNetCanonSampler(model=model, num_rots=12, num_proposal=32,
                             cap_multiple=1024, device="cpu", **kw)


def _clouds(rng):
    # anisotropic extents, so a missed y <-> z permutation moves proposals
    # outside the cloud's box
    return [rng.uniform([0, 0, 0], [2.0, 1.6, 0.4], (900, 3)).astype(np.float32),
            rng.uniform([0, 0, 0], [1.8, 1.4, 0.3], (700, 3)).astype(np.float32)]


def test_brnetcanon_sampler_contract():
    rng = np.random.RandomState(0)
    model = MinkUNetBase(3, 8, generator=torch.Generator().manual_seed(0), **TINY)
    sampler = _sampler(model)
    pts = _clouds(rng)
    seeds = rng.uniform(0, 1.2, (2, 16, 3)).astype(np.float32)
    before = {k: v.clone() for k, v in sampler.model.state_dict().items()}
    out = sampler.propose(pts, seeds, torch.Generator().manual_seed(1))
    assert set(out) == {"proposals", "probs", "scales"}
    assert out["proposals"].shape == (2, 32, 3)
    assert out["probs"].shape == (2, 32)
    assert out["scales"].shape == (2, 32, 3)
    assert bool((out["probs"] == 0).all())
    for k, v in sampler.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for b in range(2):
        lo, hi = pts[b].min(0) - 0.1, pts[b].max(0) + 0.1
        p = out["proposals"][b].numpy()
        assert np.all(p >= lo - 1e-5) and np.all(p <= hi + 1e-5)
    again = sampler.propose(pts, seeds, torch.Generator().manual_seed(1))
    for k in out:
        assert torch.equal(out[k], again[k]), k
    assert AXIS_PERMUTE == (0, 2, 1)
    for name in ("forward_train_proposals", "simple_test_proposals"):
        got = getattr(sampler, name)(pts, seeds, torch.Generator().manual_seed(1))
        assert torch.equal(got["proposals"], out["proposals"])


def test_reference_checkpoint_nested_pth(tmp_path):
    """The SUN RGB-D layout (the state dict under ``model_state_dict``,
    written by the JAX package's exporter) loads every weight."""
    model = MinkUNetBase(3, 8, **TINY)
    variables = randomize(variables_of(model), np.random.RandomState(2))
    path = str(tmp_path / "checkpoint.pth")
    export_torch_style(path, variables)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    torch.save({"model_state_dict": sd, "epoch": 160}, path)
    loaded = load_reference_checkpoint(path, MinkUNetBase(3, 8, **TINY))
    for name, t in loaded.state_dict().items():
        *node, leaf = name.split(".")
        tree = variables["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in node:
            tree = tree[p]
        np.testing.assert_array_equal(t.numpy(), tree[leaf])


def test_default_device_is_the_gpu():
    model = MinkUNetBase(3, 8, **TINY)
    if torch.cuda.is_available():
        assert BRNetCanonSampler(model=model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            BRNetCanonSampler(model=model)
