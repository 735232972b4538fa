"""The backward of the port's hough_voting (ops/hough_voting.py:
_HoughVoting, hough_backward_obj) on the CPU, as tests/test_hough_voting.py
holds the JAX package's custom VJP: against the upstream CUDA backward's
math (tests/reference_impls.py:hv_backward_numpy: gradient from grid_obj
only, no 1/res factor), against jax.grad of the JAX hough_voting
(method="xla") with and without a valid mask and explicit corners, a
finite-difference check of d/d obj (the splat is linear in obj), the rot
and scale cotangents discarded, and zero gradients for the points and
corners."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops.hough_voting import hough_voting as jax_hough_voting

from canonicalvoting_tpu_torch.ops.hough_voting import hough_voting

from tests.reference_impls import hv_backward_numpy, hv_forward_numpy
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401


def _random_scene(rng, n=40):
    points = rng.uniform(0, 1.0, (n, 3)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scale = rng.uniform(0.1, 0.4, (n, 3)).astype(np.float32)
    obj = rng.uniform(0, 1, (n,)).astype(np.float32)
    return points, xyz, scale, obj


def _port_grads(points, xyz, scale, obj, g, *, res, num_rots, grid_shape,
                corners=None, valid=None, rot_scale_weight=0.0):
    """The port's gradients of sum(grid_obj * g) (plus, weighted, the sums
    of grid_rot and grid_scale) for points, xyz, scale, obj."""
    ts = [torch.tensor(a, requires_grad=True) for a in (points, xyz, scale, obj)]
    go, gr, gs = hough_voting(
        *ts, res=res, num_rots=num_rots, grid_shape=grid_shape,
        corners=None if corners is None else torch.tensor(corners),
        valid=None if valid is None else torch.tensor(valid))
    loss = (go * torch.tensor(g)).sum() + rot_scale_weight * (gr.sum() + gs.sum())
    loss.backward()
    return [t.grad.numpy() for t in ts]


def test_backward_matches_reference_kernel():
    """The upstream CUDA backward's math, incl. its quirks (gradient from
    grid_obj only, no 1/res factor); the JAX package's test at its
    tolerance."""
    rng = np.random.RandomState(0)
    points, xyz, scale, obj = _random_scene(rng, n=12)
    res, num_rots = 0.08, 6
    ref_obj, _, _ = hv_forward_numpy(points, xyz, scale, obj, res, num_rots)
    g = rng.uniform(-1, 1, ref_obj.shape).astype(np.float32)
    d_xyz_ref, d_scale_ref, d_obj_ref = hv_backward_numpy(
        g, points, xyz, scale, obj, res, num_rots)
    _, d_xyz, d_scale, d_obj = _port_grads(
        points, xyz, scale, obj, g, res=res, num_rots=num_rots,
        grid_shape=ref_obj.shape)
    np.testing.assert_allclose(d_xyz, d_xyz_ref, atol=3e-4)
    np.testing.assert_allclose(d_scale, d_scale_ref, atol=3e-4)
    np.testing.assert_allclose(d_obj, d_obj_ref, atol=3e-4)


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("with_corners", [False, True], ids=["auto", "corners"])
def test_backward_matches_jax_grad(with_valid, with_corners):
    """d_xyz, d_scale and d_obj against jax.grad of the JAX package's XLA
    path on the same inputs: float32 sums in another order, within 1e-5
    of each gradient's peak; points get zeros in both."""
    rng = np.random.RandomState(1)
    points, xyz, scale, obj = _random_scene(rng)
    res, num_rots, grid_shape = 0.08, 12, (24, 24, 24)
    valid = ((rng.uniform(size=len(obj)) > 0.3).astype(np.float32)
             if with_valid else None)
    corners = (np.stack([points.min(0) - 0.1, points.max(0) + 0.1])
               .astype(np.float32) if with_corners else None)
    g = rng.uniform(-1, 1, grid_shape).astype(np.float32)

    def f(p, x, s, o):
        go, _, _ = jax_hough_voting(
            p, x, s, o, res=res, num_rots=num_rots, grid_shape=grid_shape,
            corners=None if corners is None else jnp.asarray(corners),
            valid=None if valid is None else jnp.asarray(valid), method="xla")
        return jnp.sum(go * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (points, xyz, scale, obj)))
    got = _port_grads(points, xyz, scale, obj, g, res=res, num_rots=num_rots,
                      grid_shape=grid_shape, corners=corners, valid=valid)
    assert not np.asarray(want[0]).any() and not got[0].any()
    for name, a, b in zip(("xyz", "scale", "obj"), got[1:], want[1:]):
        b = np.asarray(b)
        assert np.abs(b).max() > 0.1, name
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)
    if valid is not None:  # invalid rows get no gradient
        assert not np.any(got[3][valid == 0]) and not np.any(got[1][valid == 0])


def test_obj_grad_finite_difference():
    """d grid_obj / d obj is exact (the splat is linear in obj)."""
    rng = np.random.RandomState(2)
    points, xyz, scale, obj = _random_scene(rng, n=8)
    res = 0.1
    ref_obj, _, _ = hv_forward_numpy(points, xyz, scale, obj, res, 4)
    g = rng.uniform(-1, 1, ref_obj.shape).astype(np.float32)
    kw = dict(res=res, num_rots=4, grid_shape=ref_obj.shape)
    d_obj = _port_grads(points, xyz, scale, obj, g, **kw)[3]

    def f(o):
        with torch.no_grad():
            go, _, _ = hough_voting(*(torch.tensor(a) for a in
                                      (points, xyz, scale, o)), **kw)
            return float((go * torch.tensor(g)).sum())

    eps = 1e-3
    for i in range(4):
        e = np.zeros_like(obj)
        e[i] = eps
        fd = (f(obj + e) - f(obj - e)) / (2 * eps)
        np.testing.assert_allclose(d_obj[i], fd, rtol=1e-2, atol=1e-3)


def test_rot_scale_grads_are_discarded():
    """Cotangents on grid_rot and grid_scale contribute nothing (upstream
    train_joint.py:31-37 discards them): the gradients with them are the
    gradients without them, and with grid_obj's cotangent zero they are
    zero; points and corners get zeros."""
    rng = np.random.RandomState(3)
    points, xyz, scale, obj = _random_scene(rng, n=8)
    kw = dict(res=0.1, num_rots=4, grid_shape=(16, 16, 16))
    g = rng.uniform(-1, 1, kw["grid_shape"]).astype(np.float32)
    with_rs = _port_grads(points, xyz, scale, obj, g, rot_scale_weight=1.0, **kw)
    without = _port_grads(points, xyz, scale, obj, g, **kw)
    for a, b in zip(with_rs, without):
        np.testing.assert_array_equal(a, b)
    zero = _port_grads(points, xyz, scale, obj, np.zeros_like(g),
                       rot_scale_weight=1.0, **kw)
    assert all(not a.any() for a in zero)
    corners = torch.tensor(np.stack([points.min(0), points.max(0)]),
                           requires_grad=True)
    go, _, _ = hough_voting(torch.tensor(points), torch.tensor(xyz),
                            torch.tensor(scale), torch.tensor(obj),
                            corners=corners, **kw)
    go.sum().backward()
    assert corners.grad is not None and not corners.grad.any()


def test_categories_form_has_no_backward():
    """The JAX VJP is single-category; the port refuses a backward of the
    (C, N) form rather than give one of its own."""
    rng = np.random.RandomState(4)
    points, xyz, scale, obj = _random_scene(rng, n=8)
    x = torch.tensor(np.stack([xyz, xyz]), requires_grad=True)
    with pytest.raises(ValueError, match="one category"):
        hough_voting(torch.tensor(points), x, torch.tensor(np.stack([scale] * 2)),
                     torch.tensor(np.stack([obj] * 2)), res=0.1, num_rots=4,
                     grid_shape=(16, 16, 16))
