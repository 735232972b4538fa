"""The port's fused BasicBlock (tiled_block3d, its plain version on the CPU)
against the JAX package's tiled_block3d in interpret mode at the three cases
of tests/test_tiled_block.py:45-49, and against the model's two-conv
BasicBlock; the card's data flow (one compaction, a compact mid, a row map)
modelled step by step in plain torch against both.

Tolerance atol 2e-4, as tests/test_tiled_block.py holds the JAX kernel to
its two-conv reference: float32 on both sides, other summation orders over
27 taps x at most 24 channels, twice. The float32 block (the port's plain
route, which the card's float32 kernel is held to) is also held to the JAX
kernel within 1e-5 of the output's peak, the card's float32 tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from canonicalvoting_tpu.ops.pallas import tiled_conv as jtc

from canonicalvoting_tpu_torch.models.dense_unet import BasicBlock
from canonicalvoting_tpu_torch.ops import tiled_conv as ttc
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_tiled_conv import _lanes, _margin, _t

DIMS = (16, 16, 32)


def _inputs(rng, cin, mid, with_rw):
    """tests/test_tiled_block.py:52-72."""
    x = np.zeros(DIMS + (cin,), np.float32)
    cells = np.unique(rng.randint(0, DIMS, (250, 3)), axis=0)
    x[cells[:, 0], cells[:, 1], cells[:, 2]] = rng.randn(
        len(cells), cin).astype(np.float32)
    occ = np.zeros(DIMS, np.float32)
    occ[cells[:, 0], cells[:, 1], cells[:, 2]] = 1.0
    p = dict(w1=rng.randn(27, cin, mid).astype(np.float32) * 0.2,
             w2=rng.randn(27, mid, mid).astype(np.float32) * 0.2,
             scale1=rng.uniform(0.5, 1.5, (mid,)).astype(np.float32),
             bias1=rng.randn(mid).astype(np.float32) * 0.1,
             scale2=rng.uniform(0.5, 1.5, (mid,)).astype(np.float32),
             bias2=rng.randn(mid).astype(np.float32) * 0.1)
    if with_rw:
        p.update(res_w=rng.randn(cin, mid).astype(np.float32) * 0.3,
                 res_scale=rng.uniform(0.5, 1.5, (mid,)).astype(np.float32),
                 res_bias=rng.randn(mid).astype(np.float32) * 0.1)
    return x, occ, cells, p


CASES = [
    ((4, 4, 8), 4, 16, 16, False),
    ((4, 4, 8), 2, 24, 16, True),
    ((8, 8, 16), 1, 8, 8, False),
]


def _jax_block(x, occ_m, tiles, p, tile_shape, group):
    return jtc.tiled_block3d(
        _lanes(_margin(x)), jnp.asarray(p["w1"]), jnp.asarray(p["w2"]),
        jnp.asarray(tiles), **{k: jnp.asarray(v) for k, v in p.items()
                               if k not in ("w1", "w2")},
        occ_e=jtc.pack_occ_expanded(jnp.asarray(occ_m), jnp.asarray(tiles),
                                    tile_shape),
        tile_shape=tile_shape, group=group, interpret=True)


@functools.lru_cache(maxsize=None)
def _jax_case(case, unmasked=False):
    """The JAX kernel's output in interpret mode on CASES[case]'s inputs from
    the ``rng`` fixture's seed (with ``unmasked``, x non-zero at every
    interior cell), computed once for the tests below."""
    tile_shape, group, cin, mid, with_rw = CASES[case]
    rng = np.random.RandomState(0)
    x, occ, cells, p = _inputs(rng, cin, mid, with_rw)
    if unmasked:
        x = rng.randn(*x.shape).astype(np.float32)
    tiles = jtc.occupied_tiles(cells, DIMS, tile_shape, pad_multiple=group)
    return np.asarray(_jax_block(x, _margin(occ), tiles, p, tile_shape,
                                 group))[..., :mid]


@pytest.mark.parametrize("tile_shape,group,cin,mid,with_rw", CASES)
def test_block_matches_jax(rng, tile_shape, group, cin, mid, with_rw):
    case = CASES.index((tile_shape, group, cin, mid, with_rw))
    x, occ, cells, p = _inputs(rng, cin, mid, with_rw)
    tiles = jtc.occupied_tiles(cells, DIMS, tile_shape, pad_multiple=group)
    occ_m = _margin(occ)
    want = _jax_case(case)
    got = ttc.tiled_block3d(
        _t(_margin(x)), _t(p["w1"]), _t(p["w2"]), _t(tiles),
        tile_shape=tile_shape, occ=_t(occ_m),
        **{k: _t(v) for k, v in p.items() if k not in ("w1", "w2")})
    assert ttc.tiled_block3d.launches == 0  # CPU tensors take the plain path
    # the whole margined grid: zeros outside the listed tiles on both sides
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    assert np.abs(got.numpy()).max() > 0.1


@pytest.mark.parametrize("case", [0, 1], ids=["identity", "fused_1x1"])
def test_float32_block_matches_jax_at_the_f32_tolerance(rng, case):
    """The block on float32 grids (the plain route, which the card's float32
    kernel is held to within 1e-5 of each output's peak) against the JAX
    kernel at float32 in interpret mode: within 1e-5 of the output's peak,
    with the identity residual and with the fused 1x1."""
    tile_shape, group, cin, mid, with_rw = CASES[case]
    x, occ, cells, p = _inputs(rng, cin, mid, with_rw)
    tiles = _t(jtc.occupied_tiles(cells, DIMS, tile_shape, pad_multiple=group))
    xm = _t(_margin(x))
    assert xm.dtype == torch.float32
    got = ttc.tiled_block3d(
        xm, _t(p["w1"]), _t(p["w2"]), tiles, tile_shape=tile_shape,
        occ=_t(_margin(occ)),
        **{k: _t(v) for k, v in p.items() if k not in ("w1", "w2")})
    assert got.dtype == torch.float32
    want = _jax_case(case)
    peak = np.abs(want).max()
    assert peak > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("cin", [8, 12])
def test_block_equals_basic_block(rng, cin):
    """The model's BasicBlock (two tiled_conv3d calls) and the fused block
    on the same weights: the identity residual (cin == planes) and the
    fused 1x1 downsample."""
    x, occ, cells, _ = _inputs(rng, cin, 8, False)
    torch.manual_seed(0)
    blk = BasicBlock(cin, 8)
    for bn in [blk.norm1, blk.norm2] + ([blk.downsample_norm] if cin != 8 else []):
        bn.mean.uniform_(-0.1, 0.1)
        bn.var.uniform_(0.5, 1.5)
    ts = (4, 4, 8)
    tiles = _t(jtc.occupied_tiles(cells, DIMS, ts, pad_multiple=2))
    xm, occ_m = _t(_margin(x)), _t(_margin(occ))
    a1, b1 = blk.norm1.affine()
    a2, b2 = blk.norm2.affine()
    res = {}
    if cin != 8:
        rs, rb = blk.downsample_norm.affine()
        res = dict(res_w=blk.downsample_conv.kernel[0], res_scale=rs,
                   res_bias=rb)
    with torch.no_grad():
        want = blk(xm, occ_m, tiles, ts)
        got = ttc.tiled_block3d(xm, blk.conv1.kernel, blk.conv2.kernel, tiles,
                                tile_shape=ts, scale1=a1, bias1=b1, scale2=a2,
                                bias2=b2, occ=occ_m, **res)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_block_refuses_what_it_does_not_take():
    x = torch.zeros(8, 8, 40, 8)
    t = torch.zeros(1, 3, dtype=torch.int32)
    kw = dict(tile_shape=(4, 4, 8), scale1=torch.ones(4), bias1=torch.zeros(4),
              scale2=torch.ones(4), bias2=torch.zeros(4),
              occ=torch.zeros(8, 8, 40))
    with pytest.raises(ValueError, match="identity residual"):
        ttc.tiled_block3d(x, torch.zeros(27, 8, 4), torch.zeros(27, 4, 4), t, **kw)
    with pytest.raises(ValueError, match="together"):
        ttc.tiled_block3d(x, torch.zeros(27, 8, 4), torch.zeros(27, 4, 4), t,
                          res_w=torch.zeros(8, 4), **kw)
    meta = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in kw.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        ttc.tiled_block3d(x.to("meta"), torch.zeros(27, 8, 8, device="meta"),
                          torch.zeros(27, 8, 8, device="meta"), t.to("meta"),
                          **{**meta, "scale1": torch.ones(8, device="meta")})


TAPS = torch.tensor([[t % 3 - 1, t // 3 % 3 - 1, t // 9 - 1] for t in range(27)])


def _data_flow(x, occ, tiles, ts, p, order):
    """The card's fused block, step by step, in float32: the live rows (in
    the compaction's ``order``, which varies from run to run), the row map
    over the margined grid (-1 elsewhere), conv1 by the K-major w1 into
    compact rows, each row's 27 neighbour positions, conv2 gathered from the
    compact rows (zero at -1), the residual or the fused 1x1, and the dead
    rows (the identity residual's unoccupied listed cells)."""
    shape, cin = x.shape[:3], x.shape[3]
    cells = ttc._row_cells(tiles, ts)
    flat = ttc._flat(cells, shape)
    occ_f = occ.reshape(-1)
    live_sel = occ_f[flat] > 0
    live = cells[live_sel][order]
    lflat = ttc._flat(live, shape)
    o = occ_f[lflat][:, None]
    row_map = torch.full((occ_f.numel(),), -1, dtype=torch.long)
    row_map[lflat] = torch.arange(live.shape[0])
    assert int((row_map >= 0).sum()) == live.shape[0]

    w1t, cpad1 = ttc._k_major(_t(p["w1"]), torch.float32, "cpu")
    mid = w1t.shape[0]
    xr = F.pad(x.reshape(-1, cin), (0, cpad1 - cin))
    a1 = torch.cat([xr[ttc._flat(live + d, shape)] for d in TAPS], 1)
    mid_rows = torch.clamp_min(
        (a1 @ w1t.reshape(mid, -1).T * _t(p["scale1"]) + _t(p["bias1"])) * o, 0.0)

    nbr = torch.stack([row_map[ttc._flat(live + d, shape)] for d in TAPS], 1)
    w2t, cpad2 = ttc._k_major(_t(p["w2"]), torch.float32, "cpu")
    cout = w2t.shape[0]
    # position -1 reads the zero row appended after the live rows
    mr = torch.cat([F.pad(mid_rows, (0, cpad2 - mid)), torch.zeros(1, cpad2)])
    a2 = mr[nbr].reshape(live.shape[0], -1)
    v = (a2 @ w2t.reshape(cout, -1).T * _t(p["scale2"]) + _t(p["bias2"])) * o
    x_live = x.reshape(-1, cin)[lflat]
    if "res_w" in p:
        rwt, crpad = ttc._k_major(_t(p["res_w"])[None], torch.float32, "cpu")
        r = (F.pad(x_live, (0, crpad - cin)) @ rwt.reshape(cout, -1).T
             * _t(p["res_scale"]) + _t(p["res_bias"])) * o
    else:
        r = x_live
    out = torch.zeros(shape + (cout,))
    rows = out.view(-1, cout)
    rows[lflat] = torch.clamp_min(v + r, 0.0)
    if "res_w" not in p:
        dead = flat[~live_sel]
        rows[dead] = torch.clamp_min(x.reshape(-1, cin)[dead], 0.0)
    return out


@pytest.mark.parametrize("tile_shape,group,cin,mid,with_rw,unmasked",
                         [c + (False,) for c in CASES]
                         + [((4, 4, 8), 4, 16, 16, False, True)])
def test_block_data_flow_matches_jax_interpret(rng, tile_shape, group, cin,
                                               mid, with_rw, unmasked):
    """The card's data flow (_data_flow, the live rows in a shuffled order)
    against the JAX kernel in interpret mode and against
    tiled_block3d_plain, atol 2e-4; with ``unmasked`` x is non-zero at
    every interior cell, so the dead rows carry relu(x)."""
    case = CASES.index((tile_shape, group, cin, mid, with_rw))
    x, occ, cells, p = _inputs(rng, cin, mid, with_rw)
    if unmasked:
        x = rng.randn(*x.shape).astype(np.float32)
    tiles = jtc.occupied_tiles(cells, DIMS, tile_shape, pad_multiple=group)
    occ_m = _margin(occ)
    xm, tm, om = _t(_margin(x)), _t(tiles), _t(occ_m)
    n_live = int((om.reshape(-1)[ttc._flat(ttc._row_cells(tm, tile_shape),
                                            om.shape)] > 0).sum())
    order = torch.from_numpy(rng.permutation(n_live))
    got = _data_flow(xm, om, tm, tile_shape, p, order)
    want = _jax_case(case, unmasked)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    plain = ttc.tiled_block3d_plain(
        xm, _t(p["w1"]), _t(p["w2"]), tm, tile_shape=tile_shape, occ=om,
        **{k: _t(v) for k, v in p.items() if k not in ("w1", "w2")})
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-4, rtol=0)
    assert np.abs(got.numpy()).max() > 0.1
    if unmasked:  # the identity residual's unoccupied listed cells
        cells_l = ttc._row_cells(tm, tile_shape)
        dead = cells_l[om.reshape(-1)[ttc._flat(cells_l, om.shape)] == 0]
        rows = got.view(-1, mid)[ttc._flat(dead, om.shape)]
        assert dead.shape[0] > 0 and bool((rows > 0).any())


SPLIT_CASES = [(32, 32, 32, False, 339072), (96, 64, 64, True, 102400),
               (256, 256, 256, False, 1792), (384, 256, 256, True, 14336),
               (8, 8, 8, False, 64)]


@pytest.mark.parametrize("cin,mid,cout,fused,n_rows", SPLIT_CASES)
def test_block_splits_are_the_two_convs(cin, mid, cout, fused, n_rows):
    """The fused block's K splits are the ones the model's two tiled_conv3d
    calls take (so the card sums in their order), and its one scratch holds
    the larger of their two."""
    s1, s2, part = ttc._block_splits(cin, mid, cout, fused, n_rows, "cpu")
    c1, p1 = ttc._split_scratch(27 * ttc._cpad(cin) // ttc.K_CHUNK, n_rows,
                                mid, 0, "cpu")
    c2, p2 = ttc._split_scratch(27 * ttc._cpad(mid) // ttc.K_CHUNK, n_rows,
                                cout, int(fused), "cpu")
    assert (s1, s2) == (c1, c2)
    sizes = [0 if q is None else q.numel() for q in (p1, p2)]
    assert (0 if part is None else part.numel()) == max(sizes)


@pytest.mark.parametrize("cin,mid,cout,fused,n_rows", SPLIT_CASES)
def test_float32_block_splits_are_the_two_convs(cin, mid, cout, fused, n_rows):
    """The float32 block (``park``: its kernel parks the fused 1x1's result
    in the scratch, with one split too) takes the two float32 convs' K
    splits, and its one scratch holds the larger of theirs: with one split
    and the fused 1x1, the (n_rows, cout) slice it parks in."""
    s1, s2, part = ttc._block_splits(cin, mid, cout, fused, n_rows, "cpu",
                                     park=True)
    c1, p1 = ttc._split_scratch(27 * ttc._cpad(cin) // ttc.K_CHUNK, n_rows,
                                mid, 0, "cpu", park=True)
    c2, p2 = ttc._split_scratch(27 * ttc._cpad(mid) // ttc.K_CHUNK, n_rows,
                                cout, int(fused), "cpu", park=True)
    assert (s1, s2) == (c1, c2)
    sizes = [0 if q is None else q.numel() for q in (p1, p2)]
    assert (0 if part is None else part.numel()) == max(sizes)
    if fused:
        assert part is not None and part.numel() >= n_rows * cout
