"""The port's training losses (train/losses.py) and schedules
(train/schedules.py) against the JAX package's on the CPU: values and
gradients on the same random head rows and labels.

Tolerances: loss values within 1e-5 relative, gradients within 1e-5 of
their peak (float32 on both sides, sums in other orders), the tie case
exactly."""

import jax
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.train import losses as jl
from canonicalvoting_tpu.train import schedules as js

from canonicalvoting_tpu_torch.data.geometry import NCLASSES, SYM_CODES
from canonicalvoting_tpu_torch.train import losses as tl
from canonicalvoting_tpu_torch.train import schedules as ts

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401


def _close_grad(got, want, rel=1e-5):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got.numpy() - want).max()) <= rel * peak


def _jax_value_and_grad(f, out):
    """JAX's losses and the gradient of their sum "loss", in one compile."""
    return jax.jit(lambda o: (f(o), jax.grad(lambda x: f(x)["loss"])(o)))(out)


def _check(values_t, values_j):
    for k in values_j:
        np.testing.assert_allclose(float(values_t[k].detach()), float(values_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _joint_inputs(rng, n=96, nvalid=80):
    out = rng.randn(n, 6 * NCLASSES + NCLASSES + 1).astype(np.float32)
    xyz = rng.randn(n, 3).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    cls = rng.randint(0, NCLASSES + 1, (n,)).astype(np.int32)
    return out, xyz, scale, cls, nvalid


@pytest.mark.parametrize("log_scale", [True, False])
@pytest.mark.parametrize("positives", [True, False])
def test_joint_losses_and_grads_match_jax(log_scale, positives):
    """Values and the head rows' gradient; with no positive row every term
    is 0 by select (and takes no gradient)."""
    out, xyz, scale, cls, nvalid = _joint_inputs(np.random.RandomState(0))
    if not positives:
        cls[:] = NCLASSES
    args = (xyz, scale, cls, nvalid, (1.0, 2.0, 0.5), log_scale, 1.5, 0.7)

    def f(o):
        return jl.joint_losses(o, *args)

    want, g_want = _jax_value_and_grad(f, out)
    t = torch.from_numpy(out).requires_grad_()
    got = tl.joint_losses(t, *(torch.from_numpy(a) if isinstance(a, np.ndarray)
                               else a for a in args))
    _check(got, want)
    got["loss"].backward()
    _close_grad(t.grad, g_want)
    assert not t.grad[nvalid:].any()


def _separate_inputs(rng, n=120, n_obj=5, max_objects=8, nvalid=100):
    out = rng.randn(n, 8).astype(np.float32)
    base = rng.randn(n, 3).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    obj_lab = rng.randint(0, 2, (n,)).astype(np.int32)
    obj_id = rng.randint(-1, n_obj, (n,)).astype(np.int32)
    sym = np.zeros(max_objects, np.int32)
    sym[:n_obj] = [0, 1, 2, 3, 1]
    return out, base, scale, obj_lab, obj_id, sym, n_obj, nvalid, max_objects


def _separate_pair(inputs, weights=(1.0, 1.0, 1.0)):
    out, base, scale, obj_lab, obj_id, sym, n_obj, nvalid, mo = inputs

    def f(o):
        return jl.separate_losses(o, base, scale, obj_lab, obj_id, sym, n_obj,
                                  nvalid, weights, mo)

    t = torch.from_numpy(out).requires_grad_()
    got = tl.separate_losses(
        t, *(torch.from_numpy(a) for a in (base, scale, obj_lab, obj_id, sym)),
        n_obj, nvalid, weights, mo)
    got["loss"].backward()
    return (got, t.grad) + _jax_value_and_grad(f, out)


def test_separate_losses_and_grads_match_jax():
    """Every symmetry code, objects past num_objects ignored, padding rows
    and background points in the overflow bucket."""
    got, g_got, want, g_want = _separate_pair(
        _separate_inputs(np.random.RandomState(1)), (1.0, 0.5, 2.0))
    _check(got, want)
    _close_grad(g_got, g_want)


def test_symmetry_loss_tie_splits_the_gradient_as_jnp_min():
    """A ROTATE_UP_2 object whose base LCC has z = 0 and whose predicted x
    and z are 0: the two hypotheses' errors tie exactly, and their
    gradients on x are opposite. torch.amin splits the gradient evenly, as
    jnp.min does (the x gradients cancel); giving it to one index would not."""
    rng = np.random.RandomState(2)
    n, mo = 40, 4
    pred = rng.randn(n, 3).astype(np.float32)
    base = rng.randn(n, 3).astype(np.float32)
    obj_id = np.full(n, -1, np.int32)
    obj_id[:20] = 0
    pred[:20, [0, 2]] = 0.0
    base[:20, 2] = 0.0
    sym = np.zeros(mo, np.int32)
    sym[0] = SYM_CODES["__SYM_ROTATE_UP_2"]
    args = (obj_id, sym, 1, (1.0, 1.0, 1.0), mo, n)
    g_want = jax.jit(jax.grad(lambda p: jl.symmetry_xyz_loss(p, base, *args)))(
        pred)
    t = torch.from_numpy(pred).requires_grad_()
    loss = tl.symmetry_xyz_loss(t, torch.from_numpy(base),
                                *(torch.from_numpy(a) for a in (obj_id, sym)),
                                *args[2:])
    loss.backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(g_want))
    assert not t.grad[:20, 0].any()  # the tie: the two x gradients cancel
    c, s = np.cos(np.float32(-np.pi)), np.sin(np.float32(-np.pi))
    e0 = np.sum((pred[:20, 0] - base[:20, 0]) ** 2)
    e1 = np.sum((pred[:20, 0] - (c * base[:20, 0] - s * base[:20, 2])) ** 2)
    assert e0 == e1 and np.abs(base[:20, 0]).min() > 0


def test_symmetry_tables_match_jax():
    np.testing.assert_array_equal(tl._SYM_ANGLES, jl._SYM_ANGLES)
    np.testing.assert_array_equal(tl._SYM_VALID, jl._SYM_VALID)
    assert tl.MAX_HYPOTHESES == jl.MAX_HYPOTHESES


@pytest.mark.parametrize("epoch", [0, 19, 20, 79, 80, 121, 160, 1000])
def test_schedules_match_jax(epoch):
    steps, rates = [80, 120, 160], [0.1, 0.1, 0.1]
    assert ts.lr_for_epoch(epoch, 1e-3, steps, rates) == \
        js.lr_for_epoch(epoch, 1e-3, steps, rates)
    assert ts.bn_momentum_for_epoch(epoch, 20, 0.5) == \
        js.bn_momentum_for_epoch(epoch, 20, 0.5)

