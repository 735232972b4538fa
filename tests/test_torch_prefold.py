"""The prefolded stem: the port's fold_dydz and plain prefolded conv against
the JAX package's fold_dydz and tiled_conv3d(prefolded=True) in interpret
mode, and the port's DenseMinkUNet(stem_impl="prefold") against its
"tiled" stem, as tests/test_separate_eval.py holds the JAX model."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from canonicalvoting_tpu.ops.pallas import tiled_conv as jtc

from canonicalvoting_tpu_torch.data.dense_prep import (
    MX, MY, MZ, dense_flat_ids, dense_grid_geometry, fit_plans, level_tiles,
    tile_plan_for_key)
from canonicalvoting_tpu_torch.models.dense_unet import (
    DenseMinkUNet, shared_scene_grids)
from canonicalvoting_tpu_torch.ops import tiled_conv as ttc
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    TINY_PLANES, _scene, one_torch_thread, randomize, variables_of)


def _margin(a):
    return np.pad(a, [(MX, MX), (MY, MY), (MZ, MZ)] + [(0, 0)] * (a.ndim - 3))


def _sparse_grid(rng, dims, c, n):
    cells = rng.randint(0, dims, (n, 3))
    x = np.zeros(tuple(dims) + (c,), np.float32)
    x[cells[:, 0], cells[:, 1], cells[:, 2]] = rng.randn(n, c)
    occ = np.zeros(tuple(dims), np.float32)
    occ[cells[:, 0], cells[:, 1], cells[:, 2]] = 1.0
    return x, occ, cells


def test_fold_dydz_matches_jax(rng):
    """The first 75 channels equal the JAX fold exactly; the port pads to 80
    (a multiple of 8), the JAX package to 128 lanes."""
    x = _margin(rng.randn(8, 6, 16, 3).astype(np.float32))
    got = ttc.fold_dydz(torch.from_numpy(x), 5).numpy()
    want = np.asarray(jtc.fold_dydz(jnp.asarray(x), 5))
    assert got.shape == x.shape[:3] + (80,)
    np.testing.assert_array_equal(got[..., :75], want[..., :75])
    assert np.all(got[..., 75:] == 0) and np.all(want[..., 75:] == 0)


@functools.lru_cache(maxsize=None)
def _stem_case():
    """The tests/test_tiled_conv.py:40 case (k=5, cin=3, tiles 4x4x8, group
    4) with the stem's epilogue, and the JAX kernel's output in interpret
    mode (computed once for the tests below), from the ``rng`` fixture's
    seed."""
    rng = np.random.RandomState(0)
    dims, cin, cout, k, ts, group = (16, 16, 32), 3, 16, 5, (4, 4, 8), 4
    x, occ, cells = _sparse_grid(rng, dims, cin, 200)
    w = (rng.randn(k ** 3, cin, cout) * 0.2).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    tiles = jtc.occupied_tiles(cells, dims, ts, pad_multiple=group)
    occ_m = _margin(occ)
    xm = _margin(x)
    want = jtc.tiled_conv3d(
        jtc.fold_dydz(jnp.asarray(xm), k), jnp.asarray(w), jnp.asarray(tiles),
        scale=jnp.asarray(scale), bias=jnp.asarray(bias),
        occ=jtc.pack_occ(jnp.asarray(occ_m), jnp.asarray(tiles), ts),
        relu_out=True, tile_shape=ts, kernel_size=k, group=group,
        prefolded=True, interpret=True)
    args = [torch.from_numpy(a) for a in (xm, w, tiles, scale, bias, occ_m)]
    return args, dict(tile_shape=ts, kernel_size=k), np.asarray(want)[..., :cout]


def test_prefolded_conv_matches_jax_interpret():
    """f32 on both sides, 5 x 75 products summed in another order (atol
    1e-5)."""
    (xm, w, tiles, scale, bias, occ_m), kw, want = _stem_case()
    got = ttc.tiled_conv3d_prefolded(
        ttc.fold_dydz(xm, kw["kernel_size"]), w, tiles, scale=scale, bias=bias,
        occ=occ_m, relu_out=True, **kw)
    assert ttc.tiled_conv3d_prefolded.launches == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(got.numpy()).max() > 0.1


def test_k_major_stem_weights_row_gemm_matches_jax_interpret():
    """The kernel's operand layout: prefold_stem_weights' (Cout, k, Cpad)
    rows against each live row's k x taps of the fold, padded to Cpad and
    concatenated (one row GEMM, as the occupied-row kernel walks its K
    steps), then the epilogue; equal to tiled_conv3d_prefolded_plain (which
    folds the kernel itself) and to the JAX kernel, atol 1e-5 in float32."""
    (xm, w, tiles, scale, bias, occ_m), kw, want = _stem_case()
    k, ts = kw["kernel_size"], kw["tile_shape"]
    xf = ttc.fold_dydz(xm, k)
    cf = xf.shape[3]
    wt = ttc.prefold_stem_weights(w, k, dtype=torch.float32, device="cpu")
    cpad = wt.shape[2]
    assert wt.shape == (w.shape[2], k, 96) and cpad % ttc.K_CHUNK == 0
    assert torch.all(wt[..., cf:] == 0)
    cells = ttc._row_cells(tiles, ts)
    flat = ttc._flat(cells, xf.shape)
    live = flat[occ_m.reshape(-1)[flat] > 0]
    rows = F.pad(xf.reshape(-1, cf), (0, cpad - cf))
    step = xf.shape[1] * xf.shape[2]  # one x offset in cells
    a = torch.cat([rows[live + (dx - k // 2) * step] for dx in range(k)], 1)
    acc = a @ wt.reshape(wt.shape[0], -1).T
    out = torch.zeros(xf.shape[:3] + (w.shape[2],))
    out.view(-1, w.shape[2])[live] = torch.clamp_min(acc * scale + bias, 0.0)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    plain = dict(scale=scale, bias=bias, occ=occ_m, relu_out=True, **kw)
    np.testing.assert_allclose(
        out.numpy(), ttc.tiled_conv3d_prefolded_plain(xf, w, tiles, **plain),
        atol=1e-5)
    assert np.abs(out.numpy()).max() > 0.1


def test_prefolded_wrapper_refuses_a_foreign_fold():
    """A ``wt`` that is not the (Cout, k, Cpad) fold of the stem kernel is
    refused before any route runs."""
    w = torch.zeros(125, 3, 8)
    wt = ttc.prefold_stem_weights(w, 5, dtype=torch.float32, device="cpu")
    xf = torch.zeros(6, 6, 36, 80)
    tiles = torch.zeros(1, 3, dtype=torch.int32)
    for bad in (wt[:, :, :80], wt[:4], wt.to("meta")):
        with pytest.raises(ValueError, match="wt"):
            ttc.tiled_conv3d_prefolded(xf, w, tiles, tile_shape=(2, 2, 4),
                                       kernel_size=5, wt=bad)


def test_prefold_stem_model_matches_tiled_stem():
    """stem_impl="prefold" against "tiled" on the same weights (another
    summation order over the 125 stem taps: atol 2e-4, as
    tests/test_separate_eval.py:196), and the scene's shared grids passed in
    give exactly what the model builds itself."""
    rng = np.random.RandomState(0)
    coords, feats = _scene(rng, extent=0.45)
    base, dims = dense_grid_geometry(coords)
    plans = fit_plans(dims)
    tiles = level_tiles(coords, base, dims, **plans)
    args = (torch.from_numpy(feats),
            torch.from_numpy(dense_flat_ids(coords, base, dims)),
            torch.ones(len(coords)), dims,
            {k: torch.from_numpy(t) for k, t in tiles.items()},
            {k: tile_plan_for_key(k, **plans)[0] for k in tiles})
    model = DenseMinkUNet(3, 8, layers=(1,) * 8, planes=TINY_PLANES,
                          init_dim=8, compute_dtype="float32")
    variables = randomize(variables_of(model), rng)
    from_jax_variables(model, variables["params"], variables["batch_stats"])
    model.stem_impl = "tiled"
    tiled = model(*args).numpy()
    model.stem_impl = "prefold"
    prefold = model(*args).numpy()
    np.testing.assert_allclose(prefold, tiled, atol=2e-4, rtol=1e-4)
    feats, flat, valid, dims = args[:4]
    shared = shared_scene_grids(feats, flat, valid, dims, in_channels=3,
                                compute_dtype="float32", stem_impl="prefold")
    np.testing.assert_array_equal(model(*args, shared=shared).numpy(), prefold)
    assert np.abs(prefold).max() > 0.1


def test_prefolded_wrapper_refuses_foreign_devices():
    xf = torch.zeros(6, 6, 36, 80, device="meta")
    tiles = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ttc.tiled_conv3d_prefolded(xf, torch.zeros(125, 3, 4, device="meta"),
                                   tiles, tile_shape=(2, 2, 4), kernel_size=5)


def test_pipeline_stem_impl_defers_to_the_model():
    """The model owns its stem: DetectionPipeline(stem_impl=None) keeps it,
    a valid value replaces it, and an unknown one raises."""
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline

    def model(**kw):
        return DenseMinkUNet(3, 8, layers=(1,) * 8, planes=TINY_PLANES,
                             init_dim=8, **kw)

    m = DetectionPipeline(model=model(stem_impl="prefold"), device="cpu").model
    assert m.stem_impl == "prefold"
    m = DetectionPipeline(model=model(), stem_impl="prefold", device="cpu").model
    assert m.stem_impl == "prefold"
    with pytest.raises(ValueError, match="stem_impl"):
        DetectionPipeline(model=model(), stem_impl="prefolded", device="cpu")
