"""Host prep of the PyTorch port gives the JAX package's integers exactly."""

import numpy as np
import pytest

from canonicalvoting_tpu.data import dense_prep as jprep
from canonicalvoting_tpu.data.synthetic import make_scene as jax_make_scene
from canonicalvoting_tpu.ops.voxelize import sparse_quantize as jax_quantize

from canonicalvoting_tpu_torch.data import dense_prep as tprep
from canonicalvoting_tpu_torch.data.synthetic import make_scene
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)


def _tiny_points(rng, n_pts, extent):
    # the tiny scenes of tests/test_dense_unet.py, negative coords included
    pts = rng.uniform(0, extent, (n_pts, 3)).astype(np.float32)
    pts[: n_pts // 4] -= extent / 2
    return pts


def _points(name):
    rng = np.random.RandomState(0)
    if name == "tiny250":
        return _tiny_points(rng, 250, 0.8)
    if name == "tiny400":
        return _tiny_points(rng, 400, 1.2)
    return make_scene(rng, n_background=20000, n_boxes=3,
                      pts_per_box=1500).points


@pytest.mark.parametrize("name", ["tiny250", "tiny400", "make_scene"])
def test_host_prep_identical(name):
    points, res = _points(name), 0.03
    coords, idx = sparse_quantize(points, res)
    jc, ji = jax_quantize(points, res)
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(idx, ji)

    base, dims = tprep.dense_grid_geometry(coords)
    jbase, jdims = jprep.dense_grid_geometry(coords)
    np.testing.assert_array_equal(base, jbase)
    assert dims == jdims
    np.testing.assert_array_equal(tprep.dense_flat_ids(coords, base, dims),
                                  jprep.dense_flat_ids(coords, base, dims))

    tiles = tprep.level_tiles(coords, base, dims)
    jtiles = jprep.level_tiles(coords, base, dims)
    assert tiles.keys() == jtiles.keys()
    for k in tiles:
        np.testing.assert_array_equal(tiles[k], jtiles[k])
        assert tprep.tile_plan_for_key(k) == jprep.tile_plan_for_key(k)

    for a, b in zip(tprep.host_occ_levels(coords, base, dims),
                    jprep.host_occ_levels(coords, base, dims)):
        np.testing.assert_array_equal(a, b)

    # fitted plans keep every list the JAX package builds and add the ones
    # it leaves to its dense XLA conv
    fitted = tprep.level_tiles(coords, base, dims, **tprep.fit_plans(dims))
    for k in jtiles:
        np.testing.assert_array_equal(fitted[k], jtiles[k])
    assert set(fitted) == {-3, -2, -1, 0, 1, 2, 3, 4, 10, 11}


def test_synthetic_scene_identical():
    a = make_scene(np.random.RandomState(3), n_background=2000, n_boxes=2,
                   pts_per_box=300)
    b = jax_make_scene(np.random.RandomState(3), n_background=2000, n_boxes=2,
                       pts_per_box=300)
    for f in ("points", "rgb", "xyz_labels", "scale_labels", "class_labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
