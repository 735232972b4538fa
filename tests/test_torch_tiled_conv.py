"""The port's plain tiled_conv3d / tiled_down2 / tiled_up2 against the JAX
Pallas kernels run in interpret mode, on the same float32 inputs.

Tolerance atol = rtol = 1e-4: both sides compute in float32 from the same
inputs and differ only in summation order over at most 125 taps x 8
channels of O(1) values (a few ulp of the O(10) outputs).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
                                  "k3_plain", "k3_unmasked_residual"])
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
    elif case == "k3_unmasked_residual":
        # non-zero at unoccupied cells too: there the output is relu(res)
        res = _margin(rng.randn(*dims, cout).astype(np.float32))
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


@functools.lru_cache(maxsize=None)
def _down_case(masked=True):
    """The down case of test_tiled_down2_matches_jax (from the ``rng``
    fixture's seed), and the JAX kernel's output in interpret mode with the
    coarse occupancy mask, or with none (computed once for the tests
    below)."""
    rng = np.random.RandomState(0)
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
    xm = _margin(x)
    want = jtc.tiled_down2(
        _lanes(xm), jnp.asarray(w), jnp.asarray(tiles),
        scale=jnp.asarray(scale), bias=jnp.asarray(bias),
        occ=(jtc.pack_occ(jnp.asarray(occ_m), jnp.asarray(tiles), ts)
             if masked else None),
        relu_out=True, tile_shape=ts, group=group, interpret=True)
    args = [_t(a) for a in (xm, w, tiles, scale, bias)]
    return args, _t(occ_m) if masked else None, ts, np.asarray(want)[..., :cout]


def test_tiled_down2_matches_jax():
    (x, w, tiles, scale, bias), occ, ts, want = _down_case()
    got = ttc.tiled_down2(x, w, tiles, tile_shape=ts, scale=scale, bias=bias,
                          occ=occ, relu_out=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(got.numpy()).max() > 0.1


@pytest.mark.parametrize("masked", [True, False], ids=["occ", "no_occ"])
def test_k_major_down_weights_row_gemm_matches_jax_interpret(masked):
    """The down kernel's operand layout: down2_weights' (Cout, 8, Cpad) rows
    against each live coarse row's 8 stride-2 taps of the fine grid (x
    fastest from the fine cell 2o), each zero-padded to Cpad and
    concatenated (one row GEMM, as the occupied-row kernel walks its K
    steps), then the epilogue (affine, mask, ReLU) at the live rows: the
    occupied listed cells, or every listed cell without occ. Equal to the
    JAX kernel in interpret mode and to tiled_down2_plain, atol 1e-5 in
    float32."""
    (x, w, tiles, scale, bias), occ, ts, want = _down_case(masked)
    cin, cout = w.shape[1], w.shape[2]
    wt = ttc.down2_weights(w, dtype=torch.float32, device="cpu")
    cpad = wt.shape[2]
    assert wt.shape == (cout, 8, cpad) and cpad % ttc.K_CHUNK == 0
    assert torch.all(wt[..., cin:] == 0)
    cshape = tuple((n - 2 * m) // 2 + 2 * m for n, m in zip(x.shape, (MX, MY, MZ)))
    cells = ttc._row_cells(tiles, ts)
    if occ is not None:
        cells = cells[occ.reshape(-1)[ttc._flat(cells, cshape)] > 0]
    rows = F.pad(x.reshape(-1, cin), (0, cpad - cin))
    taps = [torch.tensor([d & 1, (d >> 1) & 1, d >> 2]) for d in range(8)]
    a = torch.cat([rows[ttc._flat(2 * cells + t, x.shape)] for t in taps], 1)
    acc = a @ wt.reshape(cout, -1).T
    out = torch.zeros(cshape + (cout,))
    out.view(-1, cout)[ttc._flat(cells, cshape)] = torch.clamp_min(
        acc * scale + bias, 0.0)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    plain = ttc.tiled_down2_plain(x, w, tiles, tile_shape=ts, scale=scale,
                                  bias=bias, occ=occ, relu_out=True)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5)
    assert np.abs(out.numpy()).max() > 0.1


def test_down_wrapper_refuses_a_foreign_layout():
    """A ``wt`` that is not down2_weights' (Cout, 8, Cpad) layout of the
    kernel in x's dtype on x's device is refused before any route runs; the
    right one gives the plain version's output (the CPU route ignores it)."""
    (x, w, tiles, scale, bias), occ, ts, want = _down_case()
    wt = ttc.down2_weights(w, dtype=x.dtype, device=x.device)
    kw = dict(tile_shape=ts, scale=scale, bias=bias, occ=occ, relu_out=True)
    for bad in (wt[:, :, :8], wt[:4], wt.to(torch.bfloat16), wt.to("meta"),
                wt.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError, match="wt"):
            ttc.tiled_down2(x, w, tiles, wt=bad, **kw)
    got = ttc.tiled_down2(x, w, tiles, wt=wt, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _check_up2(rng, masked_skip):
    fdims, cin, cout, skip_c = (16, 16, 32), 8, 6, 4
    cdims = tuple(d // 2 for d in fdims)
    xc, _, _ = _sparse_grid(rng, cdims, cin, 80)
    _, occ, fine = _sparse_grid(rng, fdims, 1, 300)
    skip = rng.randn(*fdims, skip_c + 2).astype(np.float32)
    if masked_skip:
        skip = skip * occ[..., None]
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


def test_tiled_up2_matches_jax(rng):
    _check_up2(rng, masked_skip=True)


def test_tiled_up2_unmasked_skip_matches_jax(rng):
    """The skip is copied into every listed fine cell, occupied or not."""
    _check_up2(rng, masked_skip=False)


def test_wrappers_refuse_foreign_devices():
    x = torch.zeros(6, 6, 36, 4, device="meta")
    tiles = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ttc.tiled_conv3d(x, torch.zeros(27, 4, 4, device="meta"), tiles,
                         tile_shape=(2, 2, 4), kernel_size=3)
