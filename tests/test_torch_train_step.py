"""One joint and one separate train step of the port (train/steps.py)
against the JAX package's make_*_train_step on the CPU: the same batch of
four small scenes, the same weights (a narrow MinkUNetBase, one block a
stage), a fresh optimizer. Cases cover float32 and bfloat16, microbatch 0
(the whole batch) and 2 (two microbatches of two scenes: one backward
each, the BN statistics threaded through them, the gradients averaged),
Adam and AdamW.

The JAX gradient is read from its first Adam moment (mu = (1 - b1) g).

Tolerances, float32: losses within 1e-5 relative; each gradient, Adam
moment and running statistic within 1e-4 of its tensor's peak; updated
parameters within lr x 1e-3 wherever |g| > 1e-6 (Adam's first update is
lr g / (|g| + eps), so a tiny gradient amplifies its rounding). A ReLU
whose input lies within rounding of 0 takes its gradient by the rounding,
so the float32 cases first assert that no pre-activation of the port's
step lies within 1e-6 of 0 (the two packages' float32 pre-activations
agree to ~1e-7; the weights' seed is one whose step has no such input).

bfloat16: every conv rounds its operands, and a float32 sum taken in
another order moves a rounding by one step (2^-8) now and then; the
following convs, BatchNorms and ReLU kinks carry such steps on, so the
port's bfloat16 gradient differs from JAX's by about as much as JAX's
bfloat16 gradient differs from the float32 one. The measure is that
difference, the rounding noise: each gradient and moment tensor's L2 error
against JAX's within 4x its noise (the port's float32 step against JAX's
bfloat16 one), and the errors summed over the tensors within the noise
summed; losses within 2e-3 relative; running statistics within 1e-2 of
their peak (one or two forward passes, as the bfloat16 nets of
tests/test_torch_sparse_conv.py); updated parameters within lr x 1e-3
wherever |g| > 1e-5 and the two gradients agree within half of |g| (where
they differ more, the sign of lr g / (|g| + eps) is the rounding's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.config import Config as JConfig
from canonicalvoting_tpu.data import collate as jcollate
from canonicalvoting_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from canonicalvoting_tpu.train import steps as jsteps

from canonicalvoting_tpu_torch.config import Config
from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.data.geometry import NCLASSES, rotmat_y
from canonicalvoting_tpu_torch.data.synthetic import make_scene
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.train import steps as tsteps
from canonicalvoting_tpu_torch.utils.weights import flatten, from_jax_variables

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

TINY = dict(block="basic", layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8),
            init_dim=8)
JOINT_OUT = 6 * NCLASSES + NCLASSES + 1
LR, MOM, B1 = 1e-3, 0.3, 0.9
MAX_OBJECTS = 16


def joint_items(rng, n=4, extent=(0.5, 0.5, 0.5)):
    """Small joint-training items: (id, coords, rgb, xyz, scale, class)."""
    items = []
    for i in range(n):
        s = make_scene(rng, extent=extent, n_background=300, n_boxes=1,
                       pts_per_box=150)
        coords, idx = sparse_quantize(s.points, 0.03)
        items.append((f"scene{i}", coords, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], s.class_labels[idx]))
    return items


def separate_items(rng, n=4, extent=(0.6, 0.5, 0.6)):
    """Small separate-training items with object ids and a symmetry code
    an object (every code occurs)."""
    items = []
    for i in range(n):
        s = make_scene(rng, extent=extent, n_background=300, n_boxes=2,
                       pts_per_box=150)
        coords, idx = sparse_quantize(s.points, 0.03)
        cls = s.class_labels[idx]
        pw = coords.astype(np.float32) * 0.03
        oid = np.full(len(coords), -1, np.int32)
        for bi, b in enumerate(s.boxes):
            inv = ((pw - b.center) @ rotmat_y(b.yaw)) / b.scale
            oid[np.all(np.abs(inv) < 1, -1)] = bi
        sym = np.array([(i + bi) % 4 for bi in range(len(s.boxes))], np.int32)
        items.append((f"s{i}", coords, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], (cls < NCLASSES).astype(np.int32),
                      cls, oid, sym))
    return items


# kind, dtype, microbatch, weight decay
CASES = {"joint-f32-whole-adam": ("joint", "float32", 0, 0.0),
         "joint-bf16-mb2-adamw": ("joint", "bfloat16", 2, 1e-4),
         "separate-bf16-whole-adamw": ("separate", "bfloat16", 0, 1e-4),
         "separate-f32-mb2-adam": ("separate", "float32", 2, 0.0)}


def _items(kind):
    rng = np.random.RandomState(0)
    return joint_items(rng) if kind == "joint" else separate_items(rng)


def _port_model(kind, dtype, variables):
    m = MinkUNetBase(3, JOINT_OUT if kind == "joint" else 8,
                     compute_dtype=dtype, **TINY)
    return from_jax_variables(m, variables["params"], variables["batch_stats"])


def _port_step(kind, dtype, mb, wd, variables, items, relu_margin=None):
    """The port's state after one step, and its losses; ``relu_margin``
    (a list) collects the smallest |pre-activation| of every ReLU."""
    if kind == "joint":
        batch = tcollate.collate_joint(items, cap_multiple=256, microbatch=mb)
    else:
        batch = tcollate.collate_separate(items, cap_multiple=256,
                                          max_objects=MAX_OBJECTS, microbatch=mb)
    state = tsteps.create_train_state(_port_model(kind, dtype, variables), wd,
                                      device="cpu")
    step = (tsteps.make_joint_train_step(state.model, Config())
            if kind == "joint" else
            tsteps.make_separate_train_step(state.model, Config(), MAX_OBJECTS))
    relu = torch.relu
    if relu_margin is not None:
        def spy(x):
            relu_margin.append(float(x.detach().abs().min()))
            return relu(x)
        torch.relu = spy
    try:
        state, losses = step(state, batch, LR, MOM)
    finally:
        torch.relu = relu
    return state, losses


def _jax_step(kind, dtype, mb, wd, variables, items):
    if kind == "joint":
        batch = jcollate.collate_joint(items, cap_multiple=256, microbatch=mb)
    else:
        batch = jcollate.collate_separate(items, cap_multiple=256,
                                          max_objects=MAX_OBJECTS, microbatch=mb)
    opt = jsteps.make_optimizer(wd)
    state = jsteps.TrainState(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=opt.init(variables["params"]),
                              step=jnp.zeros((), jnp.int32))
    model = JaxMinkUNet(3, JOINT_OUT if kind == "joint" else 8,
                        compute_dtype=dtype, **TINY)
    step = (jsteps.make_joint_train_step(model, opt, JConfig())
            if kind == "joint" else
            jsteps.make_separate_train_step(model, opt, JConfig(), MAX_OBJECTS))
    return step(state, batch, jnp.float32(LR), jnp.float32(MOM))


@pytest.fixture(scope="module")
def runs():
    """Each case's port and JAX steps (and, for bfloat16, the port's
    float32 step), computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            kind, dtype, mb, wd = CASES[case]
            items = _items(kind)
            variables = randomize(
                variables_of(MinkUNetBase(3, JOINT_OUT if kind == "joint" else 8,
                                          **TINY)),
                np.random.RandomState(3))
            margin = []
            port = _port_step(kind, dtype, mb, wd, variables, items,
                              relu_margin=margin)
            ref = (None if dtype == "float32" else
                   _port_step(kind, "float32", mb, wd, variables, items))
            jst, jlosses = _jax_step(kind, dtype, mb, wd, variables, items)
            cache[case] = dict(port=port, ref=ref, jax=(jst, jlosses),
                               variables=variables, margin=min(margin))
        return cache[case]

    return get


def _moments(state):
    """The port's (grad, mu, nu) per parameter name."""
    out = {}
    for n, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        out[n] = (p.grad.numpy(), st["exp_avg"].numpy(), st["exp_avg_sq"].numpy())
    return out


def _jax_moments(jst):
    inner = jst.opt_state.inner_state[0]
    mu = {k: np.asarray(v) for k, v in flatten(jax.device_get(inner.mu))}
    nu = {k: np.asarray(v) for k, v in flatten(jax.device_get(inner.nu))}
    return {k: (mu[k] / (1 - B1), mu[k], nu[k]) for k in mu}


def _peak_rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("case", CASES)
def test_step_losses_match_jax(runs, case):
    r = runs(case)
    (_, losses), (_, jlosses) = r["port"], r["jax"]
    rtol = 1e-5 if CASES[case][1] == "float32" else 2e-3
    assert set(losses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_step_grads_and_moments_match_jax(runs, case):
    r = runs(case)
    got, want = _moments(r["port"][0]), _jax_moments(r["jax"][0])
    assert set(got) == set(want)
    if CASES[case][1] == "float32":
        assert r["margin"] > 1e-6, ("a ReLU input within rounding of 0",
                                    r["margin"])
        for n in want:
            for i, part in enumerate(("grad", "mu", "nu")):
                assert _peak_rel(got[n][i], want[n][i]) <= 1e-4, (n, part)
        return
    ref = _moments(r["ref"][0])
    for i, part in enumerate(("grad", "mu", "nu")):
        err = {n: float(np.linalg.norm(got[n][i] - want[n][i])) for n in want}
        noise = {n: float(np.linalg.norm(ref[n][i] - want[n][i])) for n in want}
        worst = max(want, key=lambda n: err[n] / max(noise[n], 1e-30))
        assert err[worst] <= 4 * noise[worst] + 1e-6 * float(
            np.linalg.norm(want[worst][i])), (part, worst, err[worst], noise[worst])
        assert sum(e * e for e in err.values()) <= sum(
            e * e for e in noise.values()), part


@pytest.mark.parametrize("case", CASES)
def test_step_bn_statistics_match_jax(runs, case):
    r = runs(case)
    jst = r["jax"][0]
    want = {f"{k}": np.asarray(v) for k, v in flatten(jax.device_get(jst.batch_stats))}
    got = {n: b.numpy() for n, b in r["port"][0].model.named_buffers()}
    tol = 1e-4 if CASES[case][1] == "float32" else 1e-2
    before = dict(flatten(r["variables"]["batch_stats"]))
    assert set(got) == set(want)
    for n in want:
        assert not np.array_equal(want[n], before[n]), n  # the step moved it
        assert _peak_rel(got[n], want[n]) <= tol, n


@pytest.mark.parametrize("case", CASES)
def test_step_updated_params_match_jax(runs, case):
    r = runs(case)
    state, jst = r["port"][0], r["jax"][0]
    assert state.step == int(jst.step) == 1
    want = {k: np.asarray(v) for k, v in flatten(jax.device_get(jst.params))}
    grads = _jax_moments(jst)
    for n, p in state.model.named_parameters():
        g_j, g_t = grads[n][0], p.grad.numpy()
        if CASES[case][1] == "float32":
            sel = np.abs(g_j) > 1e-6
        else:
            sel = (np.abs(g_j) > 1e-5) & (np.abs(g_t - g_j) < 0.5 * np.abs(g_j))
        d = np.abs(p.detach().numpy() - want[n])
        assert (d[sel] <= LR * 1e-3).all(), (n, float(d[sel].max()))
        # no update exceeds Adam's first-step size (and the decay)
        assert (d <= 2 * LR * (1 + np.abs(want[n]) * CASES[case][3])).all(), n
