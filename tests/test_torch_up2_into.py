"""The port's tiled_up2_into (its plain version on the CPU) against the JAX
Pallas kernel run in interpret mode, its in-place contract, and the
128-channel limit it keeps from the JAX kernel.

Tolerance atol = rtol = 1e-4, as tests/test_torch_tiled_conv.py: float32 on
both sides from the same inputs, other summation order over 16 channels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops.pallas import tiled_conv as jtc

from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ
from canonicalvoting_tpu_torch.eval.grouped import grouped_model_config
from canonicalvoting_tpu_torch.models import DenseMinkUNet34C
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.ops import tiled_conv as ttc
from tests.test_torch_dense_unet import TINY_PLANES, one_torch_thread  # noqa: F401
from tests.test_torch_tiled_conv import (
    TOL, _affine, _lanes, _margin, _sparse_grid, _t, _tiles)


def _case(rng, fdims, cin, cout, skip_c, n_coarse, n_fine):
    cdims = tuple(d // 2 for d in fdims)
    xc, _, _ = _sparse_grid(rng, cdims, cin, n_coarse)
    _, occ, fine = _sparse_grid(rng, fdims, 1, n_fine)
    skip = rng.randn(*fdims, skip_c).astype(np.float32) * occ[..., None]
    w = (rng.randn(8, cin, cout) * 0.2).astype(np.float32)
    scale, bias = _affine(rng, cout)
    return xc, occ, fine, skip, w, scale, bias


def test_tiled_up2_into_matches_jax(rng):
    """The JAX kernel's own sizes: an 8 x 8 x 32 fine interior, one (8, 8,
    32) tile, cin 16, cout 24, skip_c 8."""
    fdims, cin, cout, skip_c = (8, 8, 32), 16, 24, 8
    xc, occ, fine, skip, w, scale, bias = _case(rng, fdims, cin, cout, skip_c,
                                                40, 150)
    ts, group = (8, 8, 32), 1
    tiles = _tiles(fine, fdims, ts, group)
    occ_m = _margin(occ)
    want = jtc.tiled_up2_into(
        _lanes(_margin(xc)), jnp.asarray(w), jnp.asarray(tiles),
        dest=_lanes(_margin(skip)), skip_c=skip_c, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias),
        occ=jtc.pack_occ_updma(jnp.asarray(occ_m), jnp.asarray(tiles), ts,
                               group),
        relu_out=True, tile_shape=ts, group=group, interpret=True)
    dest = torch.zeros(occ_m.shape + (skip_c + cout,))
    dest[..., :skip_c] = _t(_margin(skip))
    got = ttc.tiled_up2_into(_t(_margin(xc)), _t(w), _t(tiles), dest=dest,
                             skip_c=skip_c, tile_shape=ts, scale=_t(scale),
                             bias=_t(bias), occ=_t(occ_m), relu_out=True)
    assert got is dest  # written in place
    assert ttc.tiled_up2_into.launches == 0  # CPU tensors take the plain path
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[..., :skip_c + cout], **TOL)
    assert np.abs(got.numpy()[..., skip_c:]).max() > 0.1


def test_tiled_up2_into_is_tiled_up2_permuted(rng):
    """Over many small tiles: the conv channels are tiled_up2's, the skip
    channels and every cell outside the listed tiles keep dest's values."""
    fdims, cin, cout, skip_c = (16, 16, 32), 8, 6, 4
    xc, occ, fine, skip, w, scale, bias = _case(rng, fdims, cin, cout, skip_c,
                                                80, 300)
    ts = (4, 4, 16)
    tiles = _tiles(fine[: len(fine) // 2], fdims, ts, 2)  # some tiles unlisted
    kw = dict(tile_shape=ts, scale=_t(scale), bias=_t(bias),
              occ=_t(_margin(occ)), relu_out=True)
    ref = ttc.tiled_up2(_t(_margin(xc)), _t(w), _t(tiles), skip=_t(_margin(skip)),
                        skip_c=skip_c, **kw)
    listed = torch.zeros(ref.shape[:3], dtype=torch.bool)
    listed.view(-1)[ttc._flat(ttc._row_cells(_t(tiles), ts), listed.shape)] = True
    dest = torch.full(ref.shape[:3] + (skip_c + cout,), 7.0)
    dest[..., :skip_c] = _t(_margin(skip))
    before = dest.clone()
    got = ttc.tiled_up2_into(_t(_margin(xc)), _t(w), _t(tiles), dest=dest,
                             skip_c=skip_c, **kw)
    torch.testing.assert_close(got[..., :skip_c], before[..., :skip_c],
                               rtol=0, atol=0)
    torch.testing.assert_close(got[listed][:, skip_c:], ref[listed][:, :cout],
                               rtol=0, atol=0)
    torch.testing.assert_close(got[~listed], before[~listed], rtol=0, atol=0)
    assert bool(listed.any()) and bool((~listed).any())


@pytest.mark.parametrize("cin", [128, 96], ids=["L1", "L0"])
def test_into_at_model_widths_zeroes_junk_dest(cin):
    """The model's into levels (cin 128 at L1, 96 at L0 -> cout 96 beside a
    32-channel skip: 128 channels) on a dest whose conv channels hold junk
    (7.0) everywhere, with one listed (8, 8, 32) tile of two: against the
    JAX kernel in interpret mode, exact zeros at every listed cell whose
    occupancy is 0 (children of live parents and of dead ones, whose 8
    children are all unoccupied), the skip channels and the unlisted tile
    unchanged."""
    rng = np.random.RandomState(7)
    fdims, cout, skip_c, ts, group = (8, 8, 64), 96, 32, (8, 8, 32), 1
    xc, occ, fine, skip, w, scale, bias = _case(rng, fdims, cin, cout, skip_c,
                                                40, 150)
    tiles = _tiles(fine[fine[:, 2] < 32], fdims, ts, group)  # z < 32 listed
    assert tiles.shape[0] == 1
    occ_m = _margin(occ)
    junk = np.full(occ_m.shape + (skip_c + cout,), 7.0, np.float32)
    junk[..., :skip_c] = _margin(skip)
    want = np.asarray(jtc.tiled_up2_into(
        _lanes(_margin(xc)), jnp.asarray(w), jnp.asarray(tiles),
        dest=jnp.asarray(junk), skip_c=skip_c, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias),
        occ=jtc.pack_occ_updma(jnp.asarray(occ_m), jnp.asarray(tiles), ts,
                               group),
        relu_out=True, tile_shape=ts, group=group, interpret=True))
    got = ttc.tiled_up2_into(_t(_margin(xc)), _t(w), _t(tiles),
                             dest=_t(junk.copy()), skip_c=skip_c,
                             tile_shape=ts, scale=_t(scale), bias=_t(bias),
                             occ=_t(occ_m), relu_out=True).numpy()
    np.testing.assert_allclose(got, want[..., :skip_c + cout], **TOL)
    cells = ttc._row_cells(_t(tiles), ts)
    flat = ttc._flat(cells, occ_m.shape).numpy()
    rows, occ_rows = got.reshape(-1, skip_c + cout), occ_m.reshape(-1)
    unocc = flat[occ_rows[flat] == 0]
    assert (rows[unocc, skip_c:] == 0).all()
    parents = np.unique(cells.numpy() // 2, axis=0)
    children = [2 * parents + np.array([d & 1, (d >> 1) & 1, d >> 2])
                for d in range(8)]
    live = np.zeros(len(parents), bool)
    for ch in children:
        live |= occ_m[tuple((ch + np.array([MX, MY, MZ])).T)] > 0
    assert live.any() and (~live).any()  # live and dead parents listed
    np.testing.assert_array_equal(rows[:, :skip_c],
                                  junk.reshape(rows.shape)[:, :skip_c])
    listed = np.zeros(rows.shape[0], bool)
    listed[flat] = True
    np.testing.assert_array_equal(rows[~listed],
                                  junk.reshape(rows.shape)[~listed])
    assert np.abs(rows[flat[occ_rows[flat] > 0], skip_c:]).max() > 0.1


@pytest.mark.parametrize("kernel", ["tiled_up2", "tiled_up2_into"])
@pytest.mark.parametrize("cin,cout,skip_c", [(13, 24, 8), (16, 40, 24)],
                         ids=["cin13", "cout40"])
def test_plain_ups_at_ragged_widths_match_jax(kernel, cin, cout, skip_c):
    """The widths where the card's float32 up leaves its fast path (cin 13:
    element copies, no float4 loads; cout 40: column blocks across
    parities), at which chip_smoke's f32 phase holds it to these plain
    versions: tiled_up2_plain and tiled_up2_into_plain at float32 against
    the JAX kernels in interpret mode, on two (8, 8, 32) fine tiles, the
    into-conv over a dest holding junk (7.0) in its conv channels."""
    rng = np.random.RandomState(11)
    fdims, ts, group = (16, 8, 32), (8, 8, 32), 1
    xc, occ, fine, skip, w, scale, bias = _case(rng, fdims, cin, cout, skip_c,
                                                60, 250)
    tiles = _tiles(fine, fdims, ts, group)
    occ_m = _margin(occ)
    x = _t(_margin(xc))
    assert x.dtype == torch.float32 and tiles.shape[0] == 2
    kw = dict(tile_shape=ts, scale=_t(scale), bias=_t(bias), occ=_t(occ_m),
              relu_out=True)
    jkw = dict(scale=jnp.asarray(scale), bias=jnp.asarray(bias),
               relu_out=True, tile_shape=ts, group=group, interpret=True)
    args = (_lanes(_margin(xc)), jnp.asarray(w), jnp.asarray(tiles))
    if kernel == "tiled_up2":
        want = jtc.tiled_up2(
            *args, skip=_lanes(_margin(skip)), skip_c=skip_c,
            occ=jtc.pack_occ_parity(jnp.asarray(occ_m), jnp.asarray(tiles),
                                    ts), **jkw)
        got = ttc.tiled_up2_plain(x, _t(w), _t(tiles), skip=_t(_margin(skip)),
                                  skip_c=skip_c, **kw).numpy()
        conv = got[..., :cout]
    else:
        junk = np.full(occ_m.shape + (skip_c + cout,), 7.0, np.float32)
        junk[..., :skip_c] = _margin(skip)
        want = jtc.tiled_up2_into(
            *args, dest=_lanes(junk), skip_c=skip_c,
            occ=jtc.pack_occ_updma(jnp.asarray(occ_m), jnp.asarray(tiles), ts,
                                   group), **jkw)
        got = ttc.tiled_up2_into_plain(x, _t(w), _t(tiles), dest=_t(junk.copy()),
                                       skip_c=skip_c, **kw).numpy()
        conv = got[..., skip_c:]
    np.testing.assert_allclose(got, np.asarray(want)[..., :skip_c + cout], **TOL)
    assert np.abs(conv[conv != 7.0]).max() > 0.1


def test_into_width_limit():
    """The JAX kernel asserts skip_c + cout <= 128 (tiled_conv.py:2013): the
    wrapper raises past it, and so does a model whose L0 or L1 concat would
    pass it, as a grouped MinkUNet34C (group_size 2) does."""
    x = torch.zeros(6, 6, 36, 4)
    with pytest.raises(ValueError, match="128"):
        ttc.tiled_up2_into(x, torch.zeros(8, 4, 100),
                           torch.zeros(1, 3, dtype=torch.int32),
                           dest=torch.zeros(8, 8, 40, 140), skip_c=40,
                           tile_shape=(2, 2, 8))
    net = DenseMinkUNet34C(3, 8, up_impl="into")  # 96 + 32 = 128 fits
    with pytest.raises(ValueError, match="128"):
        DenseMinkUNet(**grouped_model_config(net, 2))
    with pytest.raises(ValueError, match="up_impl"):
        DenseMinkUNet34C(3, 8, up_impl="inplace")


def test_up_impl_default_follows_cv_up2v2(monkeypatch):
    kw = dict(layers=(1,) * 8, planes=TINY_PLANES, init_dim=8)
    monkeypatch.setenv("CV_UP2V2", "1")
    m = DenseMinkUNet(3, 8, **kw)
    assert m.up_impl == "into" and m.config()["up_impl"] == "into"
    monkeypatch.delenv("CV_UP2V2")
    assert DenseMinkUNet(3, 8, **kw).up_impl == "concat"
    assert DenseMinkUNet(**m.config()).up_impl == "into"  # twins carry it
