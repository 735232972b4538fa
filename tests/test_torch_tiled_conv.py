"""The port's plain tiled_conv3d / tiled_down2 / tiled_up2 against the JAX
Pallas kernels run in interpret mode, on the same float32 inputs.

Tolerance atol = rtol = 1e-4: both sides compute in float32 from the same
inputs and differ only in summation order over at most 125 taps x 8
channels of O(1) values (a few ulp of the O(10) outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops.pallas import tiled_conv as jtc

from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ
from canonicalvoting_tpu_torch.ops import tiled_conv as ttc
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)


def _margin(a):
    pad = [(MX, MX), (MY, MY), (MZ, MZ)] + [(0, 0)] * (a.ndim - 3)
    return np.pad(a, pad)


def _lanes(a):
    """The JAX kernels' layout: 128-multiple channel lanes."""
    cp = int(np.ceil(a.shape[-1] / 128) * 128)
    return jnp.asarray(np.pad(a, [(0, 0)] * 3 + [(0, cp - a.shape[-1])]))


def _sparse_grid(rng, dims, c, n):
    cells = rng.randint(0, dims, (n, 3))
    x = np.zeros(tuple(dims) + (c,), np.float32)
    x[cells[:, 0], cells[:, 1], cells[:, 2]] = rng.randn(n, c)
    occ = np.zeros(tuple(dims), np.float32)
    occ[cells[:, 0], cells[:, 1], cells[:, 2]] = 1.0
    return x, occ, cells


def _tiles(cells, dims, ts, group):
    return jtc.occupied_tiles(cells, dims, ts, pad_multiple=group)


def _affine(rng, c):
    return ((rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", ["k3_residual", "k3_fused_1x1", "k5_stem",
                                  "k3_plain"])
def test_tiled_conv3d_matches_jax(rng, case):
    dims, cin, cout = (16, 8, 32), 8, 16
    k, ts, group = 3, (4, 4, 8), 4
    if case == "k5_stem":
        cin, k, ts, group = 3, 5, (4, 2, 8), 2
    x, occ, cells = _sparse_grid(rng, dims, cin, 120)
    w = (rng.randn(k ** 3, cin, cout) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    tiles = _tiles(cells, dims, ts, group)
    occ_m = _margin(occ)
    res = res_w = rs = rb = None
    if case == "k3_residual":
        res = _margin(rng.randn(*dims, cout).astype(np.float32)
                      * occ[..., None])
    elif case == "k3_fused_1x1":
        res = _margin(x)
        res_w = (rng.randn(cin, cout) * 0.3).astype(np.float32)
        rs, rb = _affine(rng, cout)
    if case == "k3_plain":
        scale = bias = occ_pack = None
        occ_t = None
    else:
        occ_t = _t(occ_m)
        occ_pack = (jtc.pack_occ_group(jnp.asarray(occ_m), jnp.asarray(tiles),
                                       ts, group=group)
                    if case == "k5_stem"
                    else jtc.pack_occ(jnp.asarray(occ_m), jnp.asarray(tiles), ts))
    want = jtc.tiled_conv3d(
        _lanes(_margin(x)), jnp.asarray(w), jnp.asarray(tiles),
        scale=None if scale is None else jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias), occ=occ_pack,
        residual=None if res is None else _lanes(res),
        res_w=None if res_w is None else jnp.asarray(res_w),
        res_scale=None if rs is None else jnp.asarray(rs),
        res_bias=None if rb is None else jnp.asarray(rb),
        relu_out=case != "k3_plain", tile_shape=ts, kernel_size=k,
        group=group, interpret=True)
    got = ttc.tiled_conv3d(
        _t(_margin(x)), _t(w), _t(tiles), tile_shape=ts, kernel_size=k,
        scale=_t(scale), bias=_t(bias), occ=occ_t, residual=_t(res),
        res_w=_t(res_w), res_scale=_t(rs), res_bias=_t(rb),
        relu_out=case != "k3_plain")
    assert ttc.tiled_conv3d.launches == 0  # CPU tensors take the plain path
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :cout], **TOL)
    assert np.abs(got.numpy()).max() > 0.1


def test_tiled_down2_matches_jax(rng):
    fdims, cin, cout = (16, 16, 32), 8, 8
    cdims = tuple(d // 2 for d in fdims)
    x, _, cells = _sparse_grid(rng, fdims, cin, 200)
    coarse = np.unique(cells // 2, axis=0)
    occ = np.zeros(cdims, np.float32)
    occ[coarse[:, 0], coarse[:, 1], coarse[:, 2]] = 1.0
    w = (rng.randn(8, cin, cout) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    ts, group = (4, 4, 8), 2
    tiles = _tiles(coarse, cdims, ts, group)
    occ_m = _margin(occ)
    want = jtc.tiled_down2(
        _lanes(_margin(x)), jnp.asarray(w), jnp.asarray(tiles),
        scale=jnp.asarray(scale), bias=jnp.asarray(bias),
        occ=jtc.pack_occ(jnp.asarray(occ_m), jnp.asarray(tiles), ts),
        relu_out=True, tile_shape=ts, group=group, interpret=True)
    got = ttc.tiled_down2(_t(_margin(x)), _t(w), _t(tiles), tile_shape=ts,
                          scale=_t(scale), bias=_t(bias), occ=_t(occ_m),
                          relu_out=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :cout], **TOL)
    assert np.abs(got.numpy()).max() > 0.1


def test_tiled_up2_matches_jax(rng):
    fdims, cin, cout, skip_c = (16, 16, 32), 8, 6, 4
    cdims = tuple(d // 2 for d in fdims)
    xc, _, _ = _sparse_grid(rng, cdims, cin, 80)
    _, occ, fine = _sparse_grid(rng, fdims, 1, 300)
    skip = rng.randn(*fdims, skip_c + 2).astype(np.float32) * occ[..., None]
    w = (rng.randn(8, cin, cout) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    ts, group = (4, 4, 16), 2
    tiles = _tiles(fine, fdims, ts, group)
    occ_m = _margin(occ)
    want = jtc.tiled_up2(
        _lanes(_margin(xc)), jnp.asarray(w), jnp.asarray(tiles),
        scale=jnp.asarray(scale), bias=jnp.asarray(bias),
        occ=jtc.pack_occ_parity(jnp.asarray(occ_m), jnp.asarray(tiles), ts),
        skip=_lanes(_margin(skip)), skip_c=skip_c, relu_out=True,
        tile_shape=ts, group=group, interpret=True)
    got = ttc.tiled_up2(_t(_margin(xc)), _t(w), _t(tiles), tile_shape=ts,
                        scale=_t(scale), bias=_t(bias), occ=_t(occ_m),
                        skip=_t(_margin(skip)), skip_c=skip_c, relu_out=True)
    assert got.shape[-1] == cout + skip_c
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[..., :cout + skip_c], **TOL)
    assert np.abs(got.numpy()[..., :cout]).max() > 0.1


def test_wrappers_refuse_foreign_devices():
    x = torch.zeros(6, 6, 36, 4, device="meta")
    tiles = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ttc.tiled_conv3d(x, torch.zeros(27, 4, 4, device="meta"), tiles,
                         tile_shape=(2, 2, 4), kernel_size=3)
