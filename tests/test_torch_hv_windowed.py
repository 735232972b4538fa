"""The port's windowed objectness splat (its plain version on the CPU)
against the JAX package's hv_splat_windowed in interpret mode and the plane
splat's plain version, its segment keys against the JAX recipe, and the
method routing of hough_voting_obj."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops.hough_voting import (
    compute_corners as jax_corners, grid_dims_from_corners as jax_dims)
from canonicalvoting_tpu.ops.pallas.hv_splat import hv_splat_windowed as jax_windowed

from canonicalvoting_tpu_torch.ops import hough_voting as thv
from canonicalvoting_tpu_torch.ops.hv_splat import (
    hv_splat_plain, hv_splat_windowed, window_keys)
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)

RES, ROTS, GS = 0.05, 24, (32, 16, 128)
# narrow buckets, so a 32-cell grid holds four of them and the tail takes
# every radius above 4 cells
WIN = dict(x_bucket=8, x_pad=6)


def _scene(rng):
    """tests/test_hough_voting.py:269-279: big boxes for the tail."""
    n, cap = 300, 512
    points = np.zeros((cap, 3), np.float32)
    points[:n] = rng.rand(n, 3).astype(np.float32) * np.array(
        [1.5, 0.7, 1.5], np.float32)
    valid = np.zeros((cap,), np.float32)
    valid[:n] = 1.0
    xyz = rng.randn(cap, 3).astype(np.float32) * 0.15
    scale = np.abs(rng.randn(cap, 3)).astype(np.float32) * 0.3 + 0.05
    scale[: n // 8] *= 8.0
    obj = rng.rand(cap).astype(np.float32)
    return points, xyz, scale, obj, valid


def _corner_dims(points, valid):
    corners = jax_corners(jnp.asarray(points), jnp.asarray(valid))
    dims = jnp.minimum(jax_dims(corners, RES), jnp.asarray(GS, np.int32))
    return np.array(corners[0]), np.array(dims)


def _jax_keys(points, xyz, scale, corner, dims, valid, x_bucket, x_pad):
    """The JAX kernel's keys (ops/pallas/hv_splat.py:440-456) in numpy."""
    gx, gy, _ = GS
    nb = gx // x_bucket
    res = np.float32(RES)
    corr = xyz * scale
    center_y = (points[:, 1] - corr[:, 1] - corner[1]) / res
    jy = np.floor(center_y).astype(np.int32)
    y_ok = (center_y >= 0) & (center_y < np.float32(dims[1]) - 1) & (valid > 0)
    px = (points[:, 0] - corner[0]) / res
    r = np.sqrt(corr[:, 0] ** 2 + corr[:, 2] ** 2) / res
    bx = np.clip(np.floor(px / x_bucket).astype(np.int32), 0, nb - 1)
    key = np.where(r <= np.float32(x_pad - 2), jy * nb + bx, gy * nb + jy)
    return np.where(y_ok, key, gy * nb + gy)


def test_windowed_matches_jax_and_plane_splat(rng):
    points, xyz, scale, obj, valid = _scene(rng)
    corner, dims = _corner_dims(points, valid)
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, corner, dims,
                                       valid)]
    kw = dict(num_rots=ROTS, grid_shape=GS, valid=t[6])
    got = hv_splat_windowed(*t[:6], RES, **kw, **WIN).numpy()
    assert hv_splat_windowed.launches == 0  # CPU tensors take the plain path
    key = window_keys(t[0], t[1], t[2], t[4], t[5], RES, grid_shape=GS,
                      valid=t[6], **WIN).numpy()
    np.testing.assert_array_equal(
        key, _jax_keys(points, xyz, scale, corner, dims, valid, **WIN))
    nb, gy = GS[0] // WIN["x_bucket"], GS[1]
    assert len(np.unique(key[key < gy * nb] % nb)) == nb  # every bucket used
    assert ((key >= gy * nb) & (key < gy * nb + gy)).sum() >= 10  # the tail
    # the plane splat's plain version: the same votes, summed in float64
    plane = hv_splat_plain(*t[:6], RES, **kw).numpy()
    np.testing.assert_allclose(got, plane, atol=1e-6, rtol=1e-6)
    want = np.asarray(jax_windowed(
        *[jnp.asarray(a) for a in (points, xyz, scale, obj, corner, dims)],
        RES, num_rots=ROTS, grid_shape=GS, valid=jnp.asarray(valid),
        interpret=True, **WIN))
    # the JAX kernel rounds its tents to bf16: tests/test_hough_voting.py:296
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert want.max() > 1.0


def test_windowed_one_crowded_segment_with_zero_offsets():
    """Most points in one (y plane, x bucket) segment, every offset 0: all
    of a point's votes land in one cell, the case that serialized one
    block a segment in the first design and that the whole-warp path of
    the vote kernel serves. Against the plane splat's plain version and
    the JAX kernel in interpret mode."""
    rng = np.random.RandomState(3)
    n, cap = 400, 512
    points = np.zeros((cap, 3), np.float32)
    # 360 points in 1.5 x 0.04 x 1.5 cells near one corner: x bucket 0,
    # one y plane; the rest spread over the grid
    points[:360] = (rng.rand(360, 3) * np.array([0.3, 0.002, 1.5])
                    + np.array([0.06, 0.3, 0.5])).astype(np.float32)
    points[360:n] = rng.rand(n - 360, 3).astype(np.float32) * np.array(
        [1.5, 0.7, 1.5], np.float32)
    valid = np.zeros((cap,), np.float32)
    valid[:n] = 1.0
    xyz = np.zeros((cap, 3), np.float32)
    scale = np.ones((cap, 3), np.float32)
    obj = rng.rand(cap).astype(np.float32)
    corner, dims = _corner_dims(points, valid)
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, corner, dims,
                                       valid)]
    kw = dict(num_rots=ROTS, grid_shape=GS, valid=t[6])
    key = window_keys(t[0], t[1], t[2], t[4], t[5], RES, grid_shape=GS,
                      valid=t[6], **WIN)
    assert int((key == torch.mode(key).values).sum()) >= 300
    got = hv_splat_windowed(*t[:6], RES, **kw, **WIN).numpy()
    plane = hv_splat_plain(*t[:6], RES, **kw).numpy()
    np.testing.assert_allclose(got, plane, atol=1e-5, rtol=1e-6)
    want = np.asarray(jax_windowed(
        *[jnp.asarray(a) for a in (points, xyz, scale, obj, corner, dims)],
        RES, num_rots=ROTS, grid_shape=GS, valid=jnp.asarray(valid),
        interpret=True, **WIN))
    # the JAX kernel rounds its tents to bf16: tests/test_hough_voting.py:296
    np.testing.assert_allclose(got, want, atol=2e-2 * want.max(), rtol=2e-2)
    assert want.max() > ROTS  # many points' 24 votes in one cell


def test_windowed_categories_in_one_call(rng):
    """xyz, scale and obj with a leading category axis: one call gives each
    category's single-call grid, as hv_splat does; hough_voting_obj's
    windowed route passes the categories in one call."""
    points, xyz, scale, obj, valid = _scene(rng)
    corner, dims = _corner_dims(points, valid)
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, corner, dims,
                                       valid)]
    C = 3
    xyz_c = torch.stack([t[1] * (1.0 + 0.3 * c) for c in range(C)])
    scale_c, obj_c = t[2].expand(C, -1, -1), torch.stack([t[3], t[3] ** 2,
                                                          1.0 - t[3]])
    kw = dict(num_rots=ROTS, grid_shape=GS, valid=t[6], **WIN)
    got = hv_splat_windowed(t[0], xyz_c, scale_c, obj_c, *t[4:6], RES, **kw)
    assert got.shape == (C,) + GS
    for c in range(C):
        torch.testing.assert_close(got[c], hv_splat_windowed(
            t[0], xyz_c[c], scale_c[c], obj_c[c], *t[4:6], RES, **kw),
            rtol=0, atol=0)
    grids = thv.hough_voting_obj(t[0], xyz_c, scale_c, obj_c, res=RES,
                                 num_rots=ROTS, grid_shape=GS, valid=t[6],
                                 method="pallas_windowed")
    torch.testing.assert_close(grids, torch.stack([hv_splat_plain(
        t[0], xyz_c[c], scale_c[c], obj_c[c], *t[4:6], RES, num_rots=ROTS,
        grid_shape=GS, valid=t[6]) for c in range(C)]), atol=1e-6, rtol=1e-6)


def test_windowed_plain_drops_votes_outside_the_window(monkeypatch, rng):
    """Points keyed one bucket over lose the votes that leave their window,
    as the JAX kernel's canvas drops them: the check that catches a wrong
    bucket."""
    import canonicalvoting_tpu_torch.ops.hv_splat as hs

    points, xyz, scale, obj, valid = _scene(rng)
    corner, dims = _corner_dims(points, valid)
    t = [torch.from_numpy(a) for a in (points, xyz, scale, obj, corner, dims,
                                       valid)]
    kw = dict(num_rots=ROTS, grid_shape=GS, valid=t[6], **WIN)
    whole = float(hv_splat_windowed(*t[:6], RES, **kw).sum())
    key = window_keys(t[0], t[1], t[2], t[4], t[5], RES, grid_shape=GS,
                      valid=t[6], **WIN)
    nb = GS[0] // WIN["x_bucket"]
    wrong = torch.where(key < GS[1] * nb, key - key % nb + (key % nb + 1) % nb,
                        key)
    monkeypatch.setattr(hs, "window_keys", lambda *a, **k: wrong)
    assert float(hv_splat_windowed(*t[:6], RES, **kw).sum()) < 0.9 * whole


def test_windowed_refuses_bad_shapes_and_devices():
    z = torch.zeros(4, 3)
    args = (z, z, z, torch.zeros(4), torch.zeros(3),
            torch.zeros(3, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="multiple"):
        hv_splat_windowed(*args, num_rots=4, grid_shape=(20, 4, 4))
    m = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(RuntimeError, match="no kernel"):
        hv_splat_windowed(*m, num_rots=4, grid_shape=(32, 4, 4))


@pytest.mark.parametrize("method,gx,route", [
    ("auto", 32, "plane"), ("pallas", 32, "plane"),
    ("pallas_windowed", 32, "windowed"), ("pallas_windowed", 48, "plane")])
def test_hough_voting_obj_routes(monkeypatch, rng, method, gx, route):
    """The JAX package's rule (ops/hough_voting.py:514-516): the windowed
    splat where gx % 32 == 0, the plane splat otherwise."""
    points, xyz, scale, obj, valid = (torch.from_numpy(a) for a in _scene(rng))
    calls = []
    monkeypatch.setattr(thv, "hv_splat", lambda *a, **k: calls.append("plane"))
    monkeypatch.setattr(thv, "hv_splat_windowed",
                        lambda *a, **k: calls.append(("windowed", k["x_bucket"])))
    thv.hough_voting_obj(points, xyz, scale, obj, res=RES, num_rots=ROTS,
                         grid_shape=(gx, 16, 128), valid=valid, method=method)
    assert calls == ([("windowed", 32)] if route == "windowed" else ["plane"])


@pytest.mark.parametrize("method", ["xla", "pallas_interpret", "windowed"])
def test_hough_voting_obj_refuses_other_methods(method):
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="pallas_windowed"):
        thv.hough_voting_obj(z, z, z, torch.zeros(4), res=0.1, num_rots=4,
                             grid_shape=(32, 4, 4), method=method)
