"""The port's coordinate manager (ops/coords.py, csrc/coords_native.c)
against the JAX package's ops/coords.py: every array bitwise equal, on the
port's native and NumPy paths, padding and capacities included."""

import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops import coords as J
from canonicalvoting_tpu.ops.voxelize import batched_coordinates, sparse_quantize

import canonicalvoting_tpu_torch.ops.cuda_build as cb
from canonicalvoting_tpu_torch.ops import coords as T

PATHS = [pytest.param(True, id="native"), pytest.param(False, id="numpy")]


def _coords(seed, n_pts=1500, extent=1.2, res=0.05, batches=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        pts = rng.uniform(0, extent, (n_pts, 3)).astype(np.float32)
        pts[: n_pts // 4] -= extent / 2  # negative coordinates too
        out.append(sparse_quantize(pts, res)[0])
    return batched_coordinates(out)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 1), (2, 1), (3, 4), (2, 8)])
def test_kernel_offsets_and_pack(k, s):
    _equal(T.kernel_offsets(k, s), J.kernel_offsets(k, s))
    c = _coords(0, batches=2)
    _equal(T.pack_coords(c), J.pack_coords(c))
    with pytest.raises(ValueError, match="18-bit"):
        T.pack_coords(np.array([[0, 1 << 17, 0, 0]]))


@pytest.mark.parametrize("native", PATHS)
def test_nbr_table_and_downsample(native):
    c = _coords(1, batches=2)
    padded = J._pad_coords(c, len(c) + 37)
    _equal(T._pad_coords(c, len(c) + 37), padded)
    for k, s in ((3, 1), (5, 1), (2, 1)):
        offs = J.kernel_offsets(k, s)
        _equal(T.build_nbr_table(padded, padded, offs, in_valid=len(c),
                                 out_valid=len(c), native=native),
               J.build_nbr_table(padded, padded, offs, in_valid=len(c),
                                 out_valid=len(c)))
    for stride in (2, 4):
        _equal(T.downsample_coords(c, stride, native=native),
               J.downsample_coords(c, stride))


@pytest.mark.parametrize("native", PATHS)
@pytest.mark.parametrize("spec", [dict(cap_multiple=256),
                                  dict(capacities=(1536, 1280, 512, 128, 32))],
                         ids=["cap_multiple", "capacities"])
def test_build_pyramid_matches_jax(native, spec):
    c = _coords(2)
    pj = J.build_pyramid(c, J.PyramidSpec(**spec))
    pt = T.build_pyramid(c, T.PyramidSpec(**spec), native=native)
    assert pt.nvalid == pj.nvalid
    for a, b in zip(pt.coords, pj.coords):
        _equal(a, b)
    for a, b in zip(pt.tables(), [pj.nbr_stem, *pj.nbr_conv, *pj.nbr_down,
                                  *pj.nbr_up]):
        _equal(a, b)


def test_upload_is_one_buffer_of_the_tables():
    pyr = T.build_pyramid(_coords(3), T.PyramidSpec(cap_multiple=128))
    extra = np.arange(12, dtype=np.float32).reshape(4, 3) - 5.5
    tabs, (got,) = pyr.to("cpu", [extra])
    np.testing.assert_array_equal(got.numpy(), extra)
    assert got.dtype == torch.float32
    for t, a in zip([tabs["nbr_stem"], *tabs["nbr_conv"], *tabs["nbr_down"],
                     *tabs["nbr_up"]], pyr.tables()):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)
    assert tabs["nvalid"] == tuple(pyr.nvalid)
    assert pyr.table_bytes() == sum(a.nbytes for a in pyr.tables())


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails makes the native path raise."""
    monkeypatch.setattr(cb, "BUILD", tmp_path)
    monkeypatch.setattr(cb, "_libs", {})
    monkeypatch.setattr(cb, "_cc", lambda: "false")
    c = _coords(4)
    with pytest.raises(RuntimeError, match="coords_native"):
        T.build_pyramid(c)
    T.build_pyramid(c, native=False)  # the explicit NumPy path still runs
