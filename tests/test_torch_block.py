"""The port's fused BasicBlock (tiled_block3d, its plain version on the CPU)
against the JAX package's tiled_block3d in interpret mode at the three cases
of tests/test_tiled_block.py:45-49, and against the model's two-conv
BasicBlock.

Tolerance atol 2e-4, as tests/test_tiled_block.py holds the JAX kernel to
its two-conv reference: float32 on both sides, other summation orders over
27 taps x at most 24 channels, twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("tile_shape,group,cin,mid,with_rw", [
    ((4, 4, 8), 4, 16, 16, False),
    ((4, 4, 8), 2, 24, 16, True),
    ((8, 8, 16), 1, 8, 8, False),
])
def test_block_matches_jax(rng, tile_shape, group, cin, mid, with_rw):
    x, occ, cells, p = _inputs(rng, cin, mid, with_rw)
    tiles = jtc.occupied_tiles(cells, DIMS, tile_shape, pad_multiple=group)
    occ_m = _margin(occ)
    want = jtc.tiled_block3d(
        _lanes(_margin(x)), jnp.asarray(p["w1"]), jnp.asarray(p["w2"]),
        jnp.asarray(tiles), **{k: jnp.asarray(v) for k, v in p.items()
                               if k not in ("w1", "w2")},
        occ_e=jtc.pack_occ_expanded(jnp.asarray(occ_m), jnp.asarray(tiles),
                                    tile_shape),
        tile_shape=tile_shape, group=group, interpret=True)
    got = ttc.tiled_block3d(
        _t(_margin(x)), _t(p["w1"]), _t(p["w2"]), _t(tiles),
        tile_shape=tile_shape, occ=_t(occ_m),
        **{k: _t(v) for k, v in p.items() if k not in ("w1", "w2")})
    assert ttc.tiled_block3d.launches == 0  # CPU tensors take the plain path
    # the whole margined grid: zeros outside the listed tiles on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :mid],
                               atol=2e-4, rtol=0)
    assert np.abs(got.numpy()).max() > 0.1


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
