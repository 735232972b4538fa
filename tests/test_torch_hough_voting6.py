"""The port's 6-channel hough_voting (objectness, rotation and scale grids)
against the JAX package's hough_voting, on its XLA path and with the
interpret-mode Pallas splat."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canonicalvoting_tpu.ops.hough_voting  # noqa: F401  (module, not the function)

from canonicalvoting_tpu_torch.ops import hough_voting as thv
from canonicalvoting_tpu_torch.ops.hv_splat import hv_splat6

from tests.test_torch_hough_voting import _scene
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)

jhv = sys.modules["canonicalvoting_tpu.ops.hough_voting"]


def _port(points, xyz, scale, obj, valid, **kw):
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, valid)]
    return [g.numpy() for g in thv.hough_voting(*t[:4], valid=t[4], **kw)]


def _jax(points, xyz, scale, obj, valid, **kw):
    return [np.asarray(g) for g in jhv.hough_voting(
        *[jnp.asarray(a) for a in (points, xyz, scale, obj)],
        valid=jnp.asarray(valid), **kw)]


def test_grids_match_jax_xla(rng):
    """f32 against f32, the obj grid's tolerance of
    tests/test_torch_hough_voting.py on all three grids: the same per-vote
    products, another summation order, the same + 1e-7 normalization."""
    args = _scene(rng)
    kw = dict(res=0.05, num_rots=24, grid_shape=(32, 32, 32))
    got = _port(*args, **kw)
    want = _jax(*args, method="xla", **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=1e-5)
    assert hv_splat6.launches == 0
    assert want[0].max() > 1.0 and np.abs(want[1]).max() > 0.5


def test_grids_match_jax_pallas_interpret(rng):
    """The TPU kernel rounds every channel's tent products to bf16: the obj
    grid's tolerance of tests/test_torch_hough_voting.py, on the raw sums
    (|cos|, |sin| <= 1 and the scales < 1 keep every channel's rounding
    below the obj channel's)."""
    args = _scene(rng)
    kw = dict(res=0.05, num_rots=8, grid_shape=(32, 16, 128))
    got = _port(*args, **kw)
    want = _jax(*args, method="pallas_interpret", **kw)
    tol = 2e-2 + 5e-3 * want[0].max()
    for grids in (got, want):  # normalized -> raw sums
        denom = grids[0][..., None] + 1e-7
        grids[1:] = [grids[1] * denom, grids[2] * denom]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol)


def test_categories_in_one_call_match_single_calls_and_jax_xla(rng):
    """hough_voting over C = 3 categories in one call (xyz, scale and obj
    with a leading category axis: one 6-channel splat) equals the three
    single calls, atol 1e-6 (the plain version sums each category alone,
    in float64), and each category the JAX hough_voting on its XLA path at
    test_grids_match_jax_xla's tolerance."""
    points, xyz, scale, obj, valid = _scene(rng)
    C = 3
    xyz_c = np.stack([xyz * (1.0 + 0.2 * c) for c in range(C)])
    scale_c = np.stack([scale * (1.0 - 0.2 * c) for c in range(C)])
    obj_c = np.stack([obj * (rng.rand(len(obj)) < 0.7) for _ in range(C)])
    kw = dict(res=0.05, num_rots=24, grid_shape=(32, 32, 32))
    t = [torch.from_numpy(a.astype(np.float32))
         for a in (points, xyz_c, scale_c, obj_c, valid)]
    batched = [g.numpy() for g in thv.hough_voting(*t[:4], valid=t[4], **kw)]
    assert hv_splat6.launches == 0
    for c in range(C):
        one = (points, xyz_c[c], scale_c[c], obj_c[c], valid)
        single = _port(*[a.astype(np.float32) for a in one], **kw)
        want = _jax(*one, method="xla", **kw)
        for b, g, w in zip(batched, single, want):
            assert b.shape == (C,) + g.shape
            np.testing.assert_allclose(b[c], g, atol=1e-6, rtol=0)
            np.testing.assert_allclose(b[c], w, atol=2e-5, rtol=1e-5)
    assert batched[0].max() > 1.0 and np.abs(batched[1]).max() > 0.5


def test_six_channel_splat_refuses_foreign_devices():
    z = torch.zeros(4, 3, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        hv_splat6(z, z, z, torch.zeros(4, device="meta"),
                  torch.zeros(3, device="meta"),
                  torch.zeros(3, dtype=torch.int32, device="meta"), 0.1,
                  num_rots=4, grid_shape=(4, 4, 4))
