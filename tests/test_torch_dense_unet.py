"""The port's DenseMinkUNet (tiled kernels, plain versions on the CPU)
against the JAX package's DenseMinkUNet(conv_impl="xla") with identical
weights, and the upstream .pth round trip into the port."""

import numpy as np
import pytest
import torch

from canonicalvoting_tpu.data.dense_prep import dense_flat_ids, dense_grid_geometry
from canonicalvoting_tpu.models.dense_unet import DenseMinkUNet as JaxDenseMinkUNet
from canonicalvoting_tpu.ops.voxelize import sparse_quantize

from canonicalvoting_tpu_torch.data.dense_prep import (
    fit_plans, level_tiles, tile_plan_for_key)
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables, load_pth

TINY_PLANES = (8, 16, 32, 32, 32, 32, 16, 16)


def _scene(rng, n_pts=250, extent=0.8):
    # the tiny scenes of tests/test_dense_unet.py
    pts = rng.uniform(0, extent, (n_pts, 3)).astype(np.float32)
    pts[: n_pts // 4] -= extent / 2
    coords, _ = sparse_quantize(pts, 0.03)
    return coords, rng.rand(len(coords), 3).astype(np.float32)


def randomize(variables, rng):
    """Seeded random weights: He-scaled kernels, and BN affines and running
    statistics away from the identity so the folded epilogues are
    exercised."""
    def walk(tree, stats):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, stats)
            elif k == "kernel":
                fan_in = v.shape[0] * v.shape[1]
                tree[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)
                           ).astype(np.float32)
            elif k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean",) or (k == "bias" and not stats):
                tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    walk(variables["params"], False)
    walk(variables["batch_stats"], True)
    return variables


def variables_of(model):
    """The port model's random weights as a JAX variables tree (numpy):
    cheaper on the CPU than a JAX init, and the same tree."""
    tree = {"params": {}, "batch_stats": {}}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        node = tree["batch_stats" if name.rsplit(".", 1)[-1] in ("mean", "var")
                    else "params"]
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().numpy().copy()
    return tree


def _setup(rng, layers, out_ch=10):
    coords, feats = _scene(rng)
    n = len(coords)
    base, dims = dense_grid_geometry(coords)
    flat = dense_flat_ids(coords, base, dims)
    valid = np.ones((n,), np.float32)
    valid[-3:] = 0.0  # invalid rows neither contribute nor receive
    kw = dict(in_channels=3, out_channels=out_ch, block="basic", layers=layers,
              planes=TINY_PLANES, init_dim=8, compute_dtype="float32")
    jmodel = JaxDenseMinkUNet(conv_impl="xla", **kw)
    model = DenseMinkUNet(3, out_ch, layers=layers, planes=TINY_PLANES,
                          init_dim=8, compute_dtype="float32")
    variables = randomize(variables_of(model), rng)
    # op by op: the second layer plan reuses the compiled ops of the first
    want = np.asarray(jmodel.apply(variables, feats, flat, valid, dims, False))

    plans = fit_plans(dims)
    tiles = level_tiles(coords, base, dims, **plans)
    args = (torch.from_numpy(feats), torch.from_numpy(flat),
            torch.from_numpy(valid), dims,
            {k: torch.from_numpy(t) for k, t in tiles.items()},
            {k: tile_plan_for_key(k, **plans)[0] for k in tiles})
    return model, variables, args, want


_SETUPS = {}


def _cached_setup(layers):
    """One JAX init + apply per layer plan for the whole module."""
    if layers not in _SETUPS:
        _SETUPS[layers] = _setup(np.random.RandomState(0), layers)
    return _SETUPS[layers]


@pytest.mark.parametrize("layers", [(1,) * 8, (1, 2, 1, 1, 2, 1, 1, 2)])
def test_dense_unet_matches_jax_xla(layers):
    model, variables, args, want = _cached_setup(layers)
    from_jax_variables(model, variables["params"], variables["batch_stats"])
    got = model(*args).numpy()
    assert got.shape == want.shape
    # as tests/test_dense_unet.py:169 holds the tiled path to the XLA one
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    assert np.all(got[-3:] == 0)
    assert np.abs(got).max() > 0.1


def test_pth_round_trip(tmp_path):
    """JAX variables -> upstream .pth (torch.save) -> the port's loader
    gives the same rows as the direct copy."""
    from canonicalvoting_tpu.train.checkpoint import export_torch_style

    model, variables, args, _ = _cached_setup((1,) * 8)
    from_jax_variables(model, variables["params"], variables["batch_stats"])
    direct = model(*args).numpy()
    path = str(tmp_path / "joint.pth")
    export_torch_style(path, variables)
    model2 = DenseMinkUNet(3, 10, layers=(1,) * 8, planes=TINY_PLANES,
                           init_dim=8, compute_dtype="float32")
    load_pth(model2, path)
    np.testing.assert_array_equal(model2(*args).numpy(), direct)
