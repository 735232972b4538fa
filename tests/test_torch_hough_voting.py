"""The port's objectness vote grid and lazy rot/scale sampling against the
JAX package (XLA path and the interpret-mode Pallas splat) and the float64
oracle of the upstream CUDA kernel."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canonicalvoting_tpu.ops.hough_voting  # noqa: F401  (module, not the function)

from canonicalvoting_tpu_torch.ops import hough_voting as thv
from canonicalvoting_tpu_torch.ops.hv_splat import hv_splat

from tests.reference_impls import hv_forward_numpy_vec

jhv = sys.modules["canonicalvoting_tpu.ops.hough_voting"]


def _scene(rng, n=80, cap=96):
    points = np.zeros((cap, 3), np.float32)
    points[:n] = rng.uniform(0, 1.2, (n, 3))
    valid = np.zeros((cap,), np.float32)
    valid[:n] = (rng.rand(n) > 0.15)
    xyz = rng.uniform(-0.8, 0.8, (cap, 3)).astype(np.float32)
    scale = rng.uniform(0.1, 0.4, (cap, 3)).astype(np.float32)
    obj = rng.rand(cap).astype(np.float32)
    return points, xyz, scale, obj, valid


def _port(points, xyz, scale, obj, valid, **kw):
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, valid)]
    return thv.hough_voting_obj(*t[:4], valid=t[4], **kw).numpy()


def _jax(points, xyz, scale, obj, valid, **kw):
    return np.asarray(jhv.hough_voting_obj(
        *[jnp.asarray(a) for a in (points, xyz, scale, obj)],
        valid=jnp.asarray(valid), **kw))


def test_obj_grid_matches_jax_xla(rng):
    """f32 against f32: the same per-vote math, other summation order."""
    args = _scene(rng)
    kw = dict(res=0.05, num_rots=24, grid_shape=(32, 32, 32))
    got = _port(*args, **kw)
    want = _jax(*args, method="xla", **kw)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert hv_splat.launches == 0
    assert want.max() > 1.0


def test_obj_grid_matches_jax_pallas_interpret(rng):
    """The TPU kernel rounds its tent products to bf16: the tolerance of
    tests/test_hough_voting.py:181-182."""
    args = _scene(rng)
    kw = dict(res=0.05, num_rots=12, grid_shape=(32, 16, 128))
    got = _port(*args, **kw)
    want = _jax(*args, method="pallas_interpret", **kw)
    np.testing.assert_allclose(got, want, atol=2e-2 + 5e-3 * want.max())


def test_obj_grid_matches_f64_oracle(rng):
    """Against the float64 transliteration of the upstream kernel, on the
    valid points with their exact bounding box."""
    points, xyz, scale, obj, valid = _scene(rng, n=80, cap=80)
    valid[:] = 1.0
    corners = np.stack([points.min(0), points.max(0)])
    dims = tuple(int(d) for d in ((corners[1] - corners[0]) / 0.05)
                 .astype(np.int32) + 1)
    got = _port(points, xyz, scale, obj, valid, res=0.05, num_rots=24,
                grid_shape=dims)
    want, _, _ = hv_forward_numpy_vec(points, xyz, scale, obj, 0.05, 24,
                                      corners=corners)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_vote_stats_at_cell_matches_jax(rng):
    points, xyz, scale, obj, valid = _scene(rng)
    res, rots, gs = 0.05, 24, (48, 48, 48)
    want_grid = _jax(points, xyz, scale, obj, valid, res=res, num_rots=rots,
                     grid_shape=gs, method="xla")
    jcorners = jhv.compute_corners(jnp.asarray(points), jnp.asarray(valid))
    jdims = jnp.minimum(jhv.grid_dims_from_corners(jcorners, res),
                        jnp.asarray(gs, np.int32))
    tp = [torch.from_numpy(a) for a in (points, xyz, scale, obj, valid)]
    corners = thv.compute_corners(tp[0], tp[4])
    np.testing.assert_array_equal(corners.numpy(), np.asarray(jcorners))
    dims = torch.minimum(thv.grid_dims_from_corners(corners, res),
                         torch.tensor(gs, dtype=torch.int32))
    np.testing.assert_array_equal(dims.numpy(), np.asarray(jdims))
    for f in np.argsort(want_grid.ravel())[::-1][:5]:
        cell = np.asarray(np.unravel_index(f, gs), np.int32)
        jr, js = jhv.vote_stats_at_cell(
            *[jnp.asarray(a) for a in (points, xyz, scale, obj)], jcorners[0],
            jdims, res, rots, jnp.asarray(cell), valid=jnp.asarray(valid))
        tr, ts = thv.vote_stats_at_cell(*tp[:4], corners[0], dims, res, rots,
                                        torch.from_numpy(cell).long(),
                                        valid=tp[4])
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-4)


def test_splat_refuses_foreign_devices():
    z = torch.zeros(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        hv_splat(z, z, z, torch.zeros(4, device="meta"),
                 torch.zeros(3, device="meta"),
                 torch.zeros(3, dtype=torch.int32, device="meta"), 0.1,
                 num_rots=4, grid_shape=(4, 4, 4))
