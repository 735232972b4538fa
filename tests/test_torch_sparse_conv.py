"""The port's gather-form sparse conv (ops/sparse_conv.py), masked BatchNorm
(models/norm.py), sparse blocks (models/resnet.py) and MinkUNet family
(models/minkunet.py) against the JAX package on the CPU, with the JAX
variables carried over by utils/weights.py.

Tolerances: a single conv in float32 within 1e-5 of the output's peak, in
bfloat16 within 1e-3 of it (both sides multiply bf16 operands exactly and
sum in float32, in other orders). Whole nets and blocks in float32 within
1e-5 of the peak; in bfloat16 within 1e-2 of the peak: each conv rounds its
input to bfloat16, and a float32 sum taken in another order flips that
rounding by one bfloat16 step (2^-8) now and then, which the next convs
carry on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu import models as jmodels
from canonicalvoting_tpu.models.norm import MaskedBatchNorm as JaxBN
from canonicalvoting_tpu.models.resnet import BasicBlock as JaxBasic
from canonicalvoting_tpu.models.resnet import Bottleneck as JaxBottleneck
from canonicalvoting_tpu.ops import sparse_conv as jsc
from canonicalvoting_tpu.ops.coords import PyramidSpec, build_pyramid
from canonicalvoting_tpu.ops.voxelize import batched_coordinates, sparse_quantize

from canonicalvoting_tpu_torch import models as tmodels
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm
from canonicalvoting_tpu_torch.models.resnet import BasicBlock, Bottleneck
from canonicalvoting_tpu_torch.ops import coords as tcoords
from canonicalvoting_tpu_torch.ops import sparse_conv as tsc
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

TINY = dict(layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8), init_dim=8)
F32_TOL, BF16_TOL, NET_BF16_TOL = 1e-5, 1e-3, 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture(scope="module")
def scene():
    """Two batches of ~1,500 voxels at 3 cm, a 256-row padded pyramid, its
    tables on the CPU, and features zero at padding rows."""
    rng = np.random.RandomState(0)
    cl = []
    for _ in range(2):
        pts = rng.uniform(0, 1.2, (1800, 3)).astype(np.float32)
        cl.append(sparse_quantize(pts, 0.03)[0])
    pyr = build_pyramid(batched_coordinates(cl), PyramidSpec(cap_multiple=256))
    tpyr = tcoords.build_pyramid(batched_coordinates(cl),
                                 tcoords.PyramidSpec(cap_multiple=256))
    feats = np.zeros((pyr.coords[0].shape[0], 3), np.float32)
    feats[:pyr.nvalid[0]] = rng.rand(pyr.nvalid[0], 3)
    return pyr, tpyr.to("cpu")[0], feats


def _close(got, want, rel, nvalid=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if nvalid is not None:
        got, want = got[:nvalid], want[:nvalid]
    peak = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * peak, (err, rel * peak)


def _table(pyr, kind):
    return {"stem": pyr.nbr_stem, "conv": pyr.nbr_conv[1],
            "down": pyr.nbr_down[0], "up": pyr.nbr_up[1]}[kind]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["stem", "conv", "down", "up"])
def test_sparse_conv_apply_matches_jax(scene, kind, dtype):
    """k=5 (stem), k=3 (L1), the k=2 down (L0 -> L1) and up (L2 -> L1)
    tables, with a bias."""
    pyr = scene[0]
    nbr = _table(pyr, kind)
    n_in = {"stem": pyr.coords[0], "conv": pyr.coords[1],
            "down": pyr.coords[0], "up": pyr.coords[2]}[kind].shape[0]
    rng = np.random.RandomState(1)
    x = rng.randn(n_in, 24).astype(np.float32)
    w = (rng.randn(nbr.shape[1], 24, 16) * 0.1).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]
    want = jsc.sparse_conv_apply(x, nbr, w, b, compute_dtype=jdt)
    got = tsc.sparse_conv_apply(torch.from_numpy(x), torch.from_numpy(nbr),
                                torch.from_numpy(w), torch.from_numpy(b),
                                compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (nbr.shape[0], 16)
    _close(got.numpy(), want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1x1_and_pool_match_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(300, 40).astype(np.float32)
    w = (rng.randn(1, 40, 24) * 0.2).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]
    _close(tsc.sparse_conv1x1(torch.from_numpy(x), torch.from_numpy(w),
                              compute_dtype=tdt).numpy(),
           jsc.sparse_conv1x1(x, w, compute_dtype=jdt), tol)
    for mode in ("max", "avg"):
        np.testing.assert_allclose(
            tsc.masked_global_pool(torch.from_numpy(x), 250, mode).numpy(),
            jsc.masked_global_pool(x, 250, mode), rtol=1e-6, atol=1e-6)


def test_masked_batchnorm_eval_and_train_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(200, 12).astype(np.float32) * 2 + 0.5
    x[150:] = 1e3  # padding rows must not move the statistics
    variables = {"params": {"scale": rng.rand(12).astype(np.float32) + 0.5,
                            "bias": rng.randn(12).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(12).astype(np.float32),
                                 "var": rng.rand(12).astype(np.float32) + 0.5}}
    jbn = JaxBN(12)
    bn = MaskedBatchNorm(12)
    bn.load_state_dict({k: torch.from_numpy(v) for d in variables.values()
                        for k, v in d.items()})
    _close(bn(torch.from_numpy(x), 150).detach().numpy(),
           jbn.apply(variables, x, 150, False), F32_TOL)
    want, upd = jbn.apply(variables, x, 150, True, 0.3, mutable=["batch_stats"])
    got = bn(torch.from_numpy(x), 150, True, 0.3).detach()
    _close(got[:150].numpy(), np.asarray(want)[:150], F32_TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   upd["batch_stats"][k], rtol=1e-6, atol=1e-6)


def _variables(module, rng):
    return randomize(variables_of(module), rng)


@pytest.mark.parametrize("block,cin,planes", [
    ("basic", 16, 16), ("basic", 12, 16), ("bottleneck", 16, 8),
    ("bottleneck", 32, 8)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_blocks_match_jax(scene, block, cin, planes, train):
    """Identity and 1x1 shortcuts, eval and train (running statistics)."""
    pyr, tpyr, _ = scene
    nbr, nv = pyr.nbr_conv[0], pyr.nvalid[0]
    rng = np.random.RandomState(4)
    x = rng.randn(nbr.shape[0], cin).astype(np.float32)
    ours = {"basic": BasicBlock, "bottleneck": Bottleneck}[block](
        cin, planes, compute_dtype="float32")
    theirs = {"basic": JaxBasic, "bottleneck": JaxBottleneck}[block](
        cin, planes, compute_dtype="float32")
    variables = _variables(ours, rng)
    from_jax_variables(ours, variables["params"], variables["batch_stats"])
    if train:
        want, upd = theirs.apply(variables, x, nbr, nv, True, 0.1,
                                 mutable=["batch_stats"])
    else:
        want = theirs.apply(variables, x, nbr, nv, False)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), tpyr["nbr_conv"][0], nv, train)
    _close(got.numpy(), want, F32_TOL, nv)
    if train:
        _close(ours.norm2.var.numpy(), upd["batch_stats"]["norm2"]["var"],
               F32_TOL)


NETS = {"basic_f32": ("basic", "float32", F32_TOL, False),
        "basic_bf16": ("basic", "bfloat16", NET_BF16_TOL, False),
        "bottleneck_f32": ("bottleneck", "float32", F32_TOL, False),
        "endpoints_f32": ("basic", "float32", F32_TOL, True)}


@pytest.mark.parametrize("net", NETS)
def test_minkunet_matches_jax(scene, net):
    """Narrow MinkUNetBase nets (basic, bottleneck, and with the five
    endpoints of MinkUNet34CF) against JAX's, on the valid rows."""
    pyr, tpyr, feats = scene
    block, dt, tol, ends = NETS[net]
    kw = dict(block=block, compute_dtype=dt, return_endpoints=ends, **TINY)
    ours = tmodels.MinkUNetBase(3, 8, **kw)
    variables = _variables(ours, np.random.RandomState(5))
    from_jax_variables(ours, variables["params"], variables["batch_stats"])
    theirs = jmodels.MinkUNetBase(in_channels=3, out_channels=8, **kw)
    want = jax.jit(lambda v, f, p: theirs.apply(v, f, p, False))(
        variables, feats, pyr.as_jax_inputs())
    with torch.no_grad():
        got = ours(torch.from_numpy(feats), tpyr)
    if ends:
        (got_e, got), (want_e, want) = got, want
        assert len(got_e) == len(want_e) == 5
        levels = [4, 3, 2, 1, 0]  # the stride-16 conv, then the ups
        for g, w, lvl in zip(got_e, want_e, levels):
            assert g.shape == w.shape
            _close(g.numpy(), w, tol, pyr.nvalid[lvl])
    _close(got.numpy(), want, tol, pyr.nvalid[0])


def test_train_mode_net_updates_running_stats_as_jax(scene):
    pyr, tpyr, feats = scene
    ours = tmodels.MinkUNetBase(3, 4, compute_dtype="float32", **TINY)
    variables = _variables(ours, np.random.RandomState(6))
    from_jax_variables(ours, variables["params"], variables["batch_stats"])
    theirs = jmodels.MinkUNetBase(in_channels=3, out_channels=4,
                                  compute_dtype="float32", **TINY)
    want, upd = jax.jit(lambda v, f, p: theirs.apply(
        v, f, p, True, 0.5, mutable=["batch_stats"]))(
        variables, feats, pyr.as_jax_inputs())
    with torch.no_grad():
        got = ours(torch.from_numpy(feats), tpyr, True, 0.5)
    _close(got.numpy(), want, F32_TOL, pyr.nvalid[0])
    for name in ("bn0", "bntr7"):
        for k in ("mean", "var"):
            _close(getattr(getattr(ours, name), k).numpy(),
                   upd["batch_stats"][name][k], F32_TOL)


def test_padding_rows_do_not_change_valid_rows():
    """The same scene padded to two capacities gives the same valid rows
    (tests/test_minkunet.py:82)."""
    rng = np.random.RandomState(7)
    c, _ = sparse_quantize(rng.uniform(0, 1.0, (200, 3)).astype(np.float32), 0.05)
    model = tmodels.MinkUNet14A(3, 4, compute_dtype="float32",
                                generator=torch.Generator().manual_seed(7))
    outs = []
    for m in (32, 100):
        pyr = tcoords.build_pyramid(batched_coordinates([c]),
                                    tcoords.PyramidSpec(cap_multiple=m))
        nv = pyr.nvalid[0]
        feats = torch.zeros(pyr.coords[0].shape[0], 3)
        feats[:nv] = torch.linspace(0, 1, nv * 3).reshape(nv, 3)
        feats[nv:] = 50.0  # junk in the padding rows
        with torch.no_grad():
            outs.append(model(feats, pyr.to("cpu")[0])[:nv])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)


def test_zoo_matches_jax():
    names = [n for n in dir(jmodels) if n.startswith("MinkUNet")
             and n != "MinkUNetBase"]
    assert len(names) == 16
    for name in names:
        j, t = getattr(jmodels, name)(3, 8), getattr(tmodels, name)(3, 8)
        assert (t.block, t.layers, t.planes, t.init_dim, t.stem_kernel,
                t.return_endpoints) == (j.block, j.layers, j.planes,
                                        j.init_dim, j.stem_kernel,
                                        j.return_endpoints), name


def test_minkunet34cf_endpoints_at_full_width():
    """MinkUNet34CF's five endpoints (upstream minkunet.py:273-308): the
    stride-16 encoder conv's output (128 channels, before its BN), then
    the four up-convs' (256, 128, 96, 96), on their levels' rows."""
    rng = np.random.RandomState(8)
    c, _ = sparse_quantize(rng.uniform(0, 1.0, (150, 3)).astype(np.float32), 0.03)
    pyr = tcoords.build_pyramid(batched_coordinates([c]),
                                tcoords.PyramidSpec(cap_multiple=64))
    model = tmodels.MinkUNet34CF(3, 8, compute_dtype="float32",
                                 generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        ends, out = model(torch.rand(pyr.coords[0].shape[0], 3), pyr.to("cpu")[0])
    assert out.shape == (pyr.coords[0].shape[0], 8)
    assert [e.shape for e in ends] == [
        (pyr.coords[lvl].shape[0], ch)
        for lvl, ch in zip((4, 3, 2, 1, 0), (128, 256, 128, 96, 96))]


def test_init_draws_from_the_generator():
    """Fan-out Kaiming kernels from an explicit generator: the same seed
    gives the same weights."""
    a = tmodels.MinkUNet14(3, 8, generator=torch.Generator().manual_seed(1))
    b = tmodels.MinkUNet14(3, 8, generator=torch.Generator().manual_seed(1))
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    w = a.block5_0.conv1.kernel
    std = (2.0 / (w.shape[0] * w.shape[2])) ** 0.5
    assert abs(float(w.detach().std()) / std - 1.0) < 0.05


def test_one_state_dict_loads_into_both_backbones():
    """The sparse and the dense MinkUNet34C share one tree: a state dict
    of either loads strictly into the other, and the sparse twin of a
    dense model carries its weights."""
    sparse = tmodels.MinkUNet34C(3, 8, generator=torch.Generator().manual_seed(2))
    dense = tmodels.DenseMinkUNet34C(3, 8)
    assert isinstance(dense, DenseMinkUNet)
    assert set(sparse.state_dict()) == set(dense.state_dict())
    dense.load_state_dict(sparse.state_dict(), strict=True)
    back = tmodels.sparse_twin(dense)
    for k, v in sparse.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    sparse.load_state_dict(tmodels.DenseMinkUNet34C(3, 8).state_dict(),
                           strict=True)
