"""The scatter-dense conv engine (ops/scatter_conv.py) and the
tpu.train_dense_levels route of the train step against the JAX package.

Each plan kind (the folded k=5 stem, a k=3 "sub" conv, the stride-2 down,
the transposed up) on the flat level ids of a two-scene batch (collate
with_flat_levels) against JAX's scatter_dense_conv and against the port's
gather-form conv at the same site: the output, and the gradients of the
rows and the kernel for a random output gradient. float32 within 1e-5 of
each output's peak (float32 sums in another order; cuDNN and XLA's CPU
conv order them differently from the gather's one product); bfloat16
forward against JAX within 1e-2 of the peak (the grid and the products
round to bfloat16 in both, their float32 sums in another order).

Then one joint train step of a narrow MinkUNetBase (float32, three scenes)
with tpu.train_dense_levels "stem" and "all" against JAX's step with the
same sites, at tests/test_torch_train_step.py's float32 tolerances
(losses 1e-5 relative; gradients, Adam moments and running statistics
1e-4 of each tensor's peak; updated parameters lr x 1e-3 where |g| >
1e-6), as tests/test_sparse_conv.py:235 holds JAX's engine to its gather
form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.config import Config as JConfig
from canonicalvoting_tpu.data import collate as jcollate
from canonicalvoting_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from canonicalvoting_tpu.ops import scatter_conv as jsc
from canonicalvoting_tpu.train import steps as jsteps

from canonicalvoting_tpu_torch.config import Config
from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.data.synthetic import make_scene
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.ops import scatter_conv as sc
from canonicalvoting_tpu_torch.ops.sparse_conv import sparse_conv_apply
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.train import steps as tsteps
from canonicalvoting_tpu_torch.utils.weights import flatten, from_jax_variables

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)
from tests.test_torch_train_step import (
    JOINT_OUT, LR, MOM, TINY, _jax_moments, _moments, _peak_rel)

# site, plan kind, (Cin, Cout), the gather form's table
SITES = {"stem_fold": ("stem", (3, 8), lambda p: p["nbr_stem"]),
         "sub": (("conv", 1), (16, 16), lambda p: p["nbr_conv"][1]),
         "down": (("down", 0), (8, 8), lambda p: p["nbr_down"][0]),
         "up": (("up", 1), (16, 16), lambda p: p["nbr_up"][1])}


def joint_items(rng, n):
    """Joint-training items of small scenes at 8 cm voxels: 32^3 grids
    (the XLA CPU convs of the JAX references set the file's time)."""
    items = []
    for i in range(n):
        s = make_scene(rng, extent=(0.5, 0.5, 0.5), n_background=300,
                       n_boxes=1, pts_per_box=150)
        coords, idx = sparse_quantize(s.points, 0.08)
        items.append((f"scene{i}", coords, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], s.class_labels[idx]))
    return items


@pytest.fixture(scope="module")
def batch():
    """Two scenes, collated with flat level ids (numpy), and on the CPU."""
    items = joint_items(np.random.RandomState(1), 2)
    host = tcollate.collate_joint(items, cap_multiple=128, with_flat_levels=True)
    jb = jcollate.collate_joint(items, cap_multiple=128, with_flat_levels=True)
    for a, b in zip(host["flat_levels"], jb["flat_levels"]):
        assert np.array_equal(a, b)
    assert host["meta"]["grid_dims"] == jb["meta"]["grid_dims"]
    return host, tcollate.upload_batch(host, "cpu")


def _inputs(kind, host, rng):
    site, (cin, cout), _ = SITES[kind]
    meta = host["meta"]
    n_in = {"stem": 0, ("conv", 1): 1, ("down", 0): 0, ("up", 1): 2}[site]
    n_out = {"stem": 0, ("conv", 1): 1, ("down", 0): 1, ("up", 1): 1}[site]
    k = {"stem": 5, ("conv", 1): 3, ("down", 0): 2, ("up", 1): 2}[site]
    caps = [c.shape[0] for c in host["pyramid"].coords]
    x = rng.randn(caps[n_in], cin).astype(np.float32)
    w = (rng.randn(k ** 3, cin, cout) * (2.0 / (k ** 3 * cout)) ** 0.5).astype(
        np.float32)
    b = rng.randn(cout).astype(np.float32) * 0.1
    g = rng.randn(caps[n_out], cout).astype(np.float32)
    nv_out = host["pyramid"].nvalid[n_out]
    g[nv_out:] = 0.0  # padding rows: the gather form's outputs there differ
    return site, meta, x, w, b, g, nv_out


def _port(fn, x, w, b, g):
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt, torch.from_numpy(b))
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("kind", SITES)
def test_plan_kind_matches_jax_and_the_gather_form(batch, kind):
    host, dev = batch
    site, meta, x, w, b, g, nv = _inputs(kind, host, np.random.RandomState(2))
    plan = tsteps.build_dense_plans(dev["flat_levels"], meta["grid_dims"],
                                    meta["n_scenes"], {site})[site]
    jplan = jsteps.build_dense_plans(
        tuple(jnp.asarray(f) for f in host["flat_levels"]), meta["grid_dims"],
        meta["n_scenes"], {site})[site]
    assert plan.kind == kind == jplan.kind and plan.grid_shape == jplan.grid_shape

    def jax_fn(x_, w_):
        return jsc.scatter_dense_conv(x_, w_, jnp.asarray(b), jplan,
                                      compute_dtype=jnp.float32)

    @jax.jit  # one compile: eager JAX dispatches the fold's slices one by one
    def jax_ref(x_, w_, g_):
        y, vjp = jax.vjp(jax_fn, x_, w_)
        return (y, *vjp(g_), jsc.scatter_dense_conv(x_, w_, jnp.asarray(b), jplan))

    jy, jdx, jdw, jy16 = jax.device_get(jax_ref(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(g)))
    got = _port(lambda xt, wt, bt: sc.scatter_dense_conv(
        xt, wt, bt, plan, compute_dtype="float32"), x, w, b, g)
    table = torch.from_numpy(SITES[kind][2](host["pyramid"].__dict__))
    gather = _port(lambda xt, wt, bt: sparse_conv_apply(
        xt, table, wt, bt, compute_dtype=torch.float32), x, w, b, g)
    for name, p, want, ref in zip(("y", "dx", "dw"), got,
                                  (jy, jdx, jdw), gather):
        want = np.asarray(want)
        if name == "y":
            p, want, ref = p[:nv], want[:nv], ref[:nv]
        assert _peak_rel(p, want) <= 1e-5, (name, "jax")
        assert _peak_rel(p, ref) <= 1e-5, (name, "gather")
    # bfloat16: the grid and the products in bfloat16, float32 rows out
    y16 = sc.scatter_dense_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), plan).detach().numpy()
    assert y16.dtype == np.float32
    assert _peak_rel(y16[:nv], jy16[:nv]) <= 1e-2


def test_the_grid_is_scattered_again_for_the_backward(batch):
    """The conv's saved input grid is kept as the rows: no saved tensor of
    the grid's size outlives the forward."""
    host, dev = batch
    site, meta, x, w, b, g, nv = _inputs("sub", host, np.random.RandomState(3))
    plan = tsteps.build_dense_plans(dev["flat_levels"], meta["grid_dims"],
                                    meta["n_scenes"], {site})[site]
    cells = int(np.prod(plan.grid_shape)) * x.shape[1]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    xt = torch.from_numpy(x).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = sc.scatter_dense_conv(xt, torch.from_numpy(w), None, plan,
                                  compute_dtype="float32")
    assert saved and max(saved) < cells
    y.sum().backward()
    assert xt.grad is not None


def _step_pair(sites):
    items = joint_items(np.random.RandomState(0), 3)
    variables = randomize(variables_of(MinkUNetBase(3, JOINT_OUT, **TINY)),
                          np.random.RandomState(3))
    cfg = Config()
    cfg.tpu.train_dense_levels = sites
    model = from_jax_variables(MinkUNetBase(3, JOINT_OUT, compute_dtype="float32",
                                            **TINY),
                               variables["params"], variables["batch_stats"])
    state = tsteps.create_train_state(model, 0.0, device="cpu")
    tb = tcollate.collate_joint(items, cap_multiple=128, with_flat_levels=True)
    state, losses = tsteps.make_joint_train_step(state.model, cfg)(
        state, tb, LR, MOM)
    jcfg = JConfig()
    jcfg.tpu.train_dense_levels = sites
    opt = jsteps.make_optimizer(0.0)
    jstate = jsteps.TrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=opt.init(variables["params"]),
                               step=jnp.zeros((), jnp.int32))
    jb = jcollate.collate_joint(items, cap_multiple=128, with_flat_levels=True)
    jnet = JaxMinkUNet(3, JOINT_OUT, compute_dtype="float32", **TINY)
    jst, jlosses = jsteps.make_joint_train_step(jnet, opt, jcfg)(
        jstate, jb, jnp.float32(LR), jnp.float32(MOM))
    return state, losses, jax.device_get(jst), jlosses


@pytest.mark.parametrize("sites", ["stem", "all"])
def test_dense_sites_step_matches_jax(sites):
    state, losses, jst, jlosses = _step_pair(sites)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got, want = _moments(state), _jax_moments(jst)
    for n in want:
        for i, part in enumerate(("grad", "mu", "nu")):
            assert _peak_rel(got[n][i], want[n][i]) <= 1e-4, (n, part)
    stats = {k: np.asarray(v) for k, v in flatten(jst.batch_stats)}
    for n, b in state.model.named_buffers():
        assert _peak_rel(b.numpy(), stats[n]) <= 1e-4, n
    params = {k: np.asarray(v) for k, v in flatten(jst.params)}
    for n, p in state.model.named_parameters():
        d = np.abs(p.detach().numpy() - params[n])
        sel = np.abs(want[n][0]) > 1e-6
        assert (d[sel] <= LR * 1e-3).all(), (n, float(d[sel].max()))
