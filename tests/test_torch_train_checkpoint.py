"""The port's checkpoint writer (train/checkpoint.py) and weight export
(utils/weights.py) against the JAX package's on the CPU: the msgpack
encoder byte for byte against flax's, a port checkpoint restored by JAX's
restore_checkpoint, a JAX checkpoint restored into the port's train state
(and the next step continuing its Adam moments), and export_torch_style's
state dict. Values cross exactly; the continued step's update is held to
Adam's closed form within 1e-7 absolute (a float32 step of the
parameters)."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.train import checkpoint as jckpt
from canonicalvoting_tpu.train import steps as jsteps

from canonicalvoting_tpu_torch.config import Config
from canonicalvoting_tpu_torch.data.collate import collate_joint
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.train import checkpoint as tckpt
from canonicalvoting_tpu_torch.train import steps as tsteps
from canonicalvoting_tpu_torch.utils.weights import (
    flatten, from_jax_variables, to_jax_variables)

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)
from tests.test_torch_train_step import JOINT_OUT, TINY, joint_items


def _model(seed=0):
    m = MinkUNetBase(3, JOINT_OUT, compute_dtype="float32", **TINY)
    v = randomize(variables_of(m), np.random.RandomState(seed))
    return from_jax_variables(m, v["params"], v["batch_stats"])


@pytest.fixture(scope="module")
def batch():
    return collate_joint(joint_items(np.random.RandomState(0), n=2),
                         cap_multiple=256)


def _trained_state(batch, wd):
    state = tsteps.create_train_state(_model(), wd, device="cpu")
    step = tsteps.make_joint_train_step(state.model, Config())
    for lr in (1e-3, 5e-4):
        state, _ = step(state, batch, lr, 0.5)
    return state


def _jax_template(variables, wd):
    opt = jsteps.make_optimizer(wd)
    return jsteps.TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=opt.init(variables["params"]),
                             step=jnp.zeros((), jnp.int32))


def _tree(x):
    return {k: np.asarray(v) for k, v in flatten(jax.device_get(x))}


def test_msgpack_serialize_equals_flax_byte_for_byte(monkeypatch):
    rng = np.random.RandomState(0)
    tree = {"epoch": 7, "neg": -5, "i8": -100, "u16": 70000, "i32": -40000,
            "big": 2 ** 40, "f": 0.5, "s": "x" * 40, "long": "y" * 300,
            "t": True, "n": None, "e": {}, "many": {str(i): i for i in range(20)},
            "arr": rng.randn(3, 4).astype(np.float32),
            "i": np.asarray(3, np.int32), "sc": np.float32(2.5),
            "u8": np.arange(5, dtype=np.uint8),
            "chunked": rng.randn(100).astype(np.float32)}
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    data = tckpt.msgpack_serialize(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    back = tckpt.msgpack_restore(data)
    np.testing.assert_array_equal(back["chunked"], tree["chunked"])
    assert back["sc"] == np.float32(2.5) and back["many"]["13"] == 13
    bf = torch.randn(3, 2).bfloat16()
    want = np.asarray(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))
    assert tckpt.msgpack_serialize({"w": bf}) == \
        flax.serialization.msgpack_serialize({"w": want})


@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["adam", "adamw"])
def test_port_checkpoint_restores_in_jax(batch, tmp_path, wd):
    state = _trained_state(batch, wd)
    path = str(tmp_path / "epoch4.ckpt")
    tckpt.save_checkpoint(path, state, 4)
    assert os.listdir(tmp_path) == ["epoch4.ckpt"]  # the .tmp was renamed
    template = _jax_template(to_jax_variables(state.model), wd)
    restored, epoch = jckpt.restore_checkpoint(path, template)
    assert epoch == 4 and int(restored.step) == state.step == 2
    for k, v in to_jax_variables(state.model).items():
        got = _tree(getattr(restored, k))
        for name, want in flatten(v):
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    inner = restored.opt_state.inner_state[0]
    mu, nu = _tree(inner.mu), _tree(inner.nu)
    assert int(inner.count) == int(restored.opt_state.count) == 2
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        np.testing.assert_array_equal(mu[name], st["exp_avg"].numpy())
        np.testing.assert_array_equal(nu[name], st["exp_avg_sq"].numpy())
    hyper = restored.opt_state.hyperparams
    assert float(hyper["learning_rate"]) == np.float32(5e-4)
    assert ("weight_decay" in hyper) == bool(wd)


def test_jax_checkpoint_resumes_in_the_port(batch, tmp_path):
    """JAX writes a state with Adam moments after 3 updates; the port
    restores it and its next step continues those moments."""
    m = _model(seed=1)
    variables = to_jax_variables(m)
    rng = np.random.RandomState(2)
    state = _jax_template(variables, 0.0)
    mu = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32)
                                * 1e-3, variables["params"])
    nu = jax.tree_util.tree_map(lambda p: rng.rand(*p.shape).astype(np.float32)
                                * 1e-6, variables["params"])
    count = jnp.asarray(3, jnp.int32)
    inner = state.opt_state.inner_state[0]._replace(count=count, mu=mu, nu=nu)
    opt_state = state.opt_state._replace(
        count=count, inner_state=(inner,) + state.opt_state.inner_state[1:])
    opt_state.hyperparams["learning_rate"] = jnp.float32(2e-4)
    state = state.replace(opt_state=opt_state, step=jnp.asarray(3, jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "epoch9.ckpt"), state, 9)
    jckpt.save_checkpoint(str(tmp_path / "epoch10x.ckpt"), state, 9)
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "epoch9.ckpt")

    port = tsteps.create_train_state(_model(seed=5), 0.0, device="cpu")
    port, epoch = tckpt.restore_checkpoint(path, port)
    assert epoch == 9 and port.step == 3
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)
    for name, t in port.model.state_dict().items():
        assert torch.equal(t, m.state_dict()[name]), name
    mu_f, nu_f = dict(flatten(mu)), dict(flatten(nu))
    before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    step = tsteps.make_joint_train_step(port.model, Config())
    lr = 1e-3
    port, _ = step(port, batch, lr, 0.5)
    assert port.step == 4
    b1, b2, eps = 0.9, 0.999, 1e-8
    for n, p in port.model.named_parameters():
        g = p.grad.double().numpy()
        m1 = b1 * mu_f[n] + (1 - b1) * g
        v1 = b2 * nu_f[n] + (1 - b2) * g * g
        upd = lr * (m1 / (1 - b1 ** 4)) / (np.sqrt(v1 / (1 - b2 ** 4)) + eps)
        np.testing.assert_allclose(p.detach().double().numpy(),
                                   before[n].double().numpy() - upd,
                                   rtol=0, atol=1e-7, err_msg=n)


def test_to_jax_variables_round_trips():
    m = _model(seed=3)
    v = to_jax_variables(m)
    assert {k: dict(flatten(t)).keys() for k, t in v.items()} == \
        {k: dict(flatten(t)).keys() for k, t in variables_of(m).items()}
    m2 = from_jax_variables(MinkUNetBase(3, JOINT_OUT, **TINY), v["params"],
                            v["batch_stats"])
    for (n, a), (_, b) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n


def test_export_torch_style_equals_jax(tmp_path):
    m = _model(seed=4)
    ours, theirs = str(tmp_path / "ours.pth"), str(tmp_path / "theirs.pth")
    tckpt.export_torch_style(ours, m)
    jckpt.export_torch_style(theirs, to_jax_variables(m))
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert sorted(a) == sorted(b)
    assert any(k.endswith("bn.running_var") for k in a)
    for k in b:
        assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
