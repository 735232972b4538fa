"""The dense training route of the port (models/dense_unet.py:
DenseMinkUNet.train_forward, MaskedGridNorm; data/collate.py's dense
collates; data/dense_prep.py:dense_flat_ids_batched; train/steps.py's dense
branch) on the CPU, on a narrow model (one block a stage) and small scenes.

- The train-mode forward against the JAX package's DenseMinkUNet
  (conv_impl="xla") train forward on the same variables (weight bridge),
  one and two scenes, float32: the joint loss within 1e-4 relative, each
  updated running statistic within 1e-5 of its tensor's peak. Forward only:
  JAX's dense backward takes a minute on the CPU.
- The port's dense step's gradients against the port's gather step's on
  the same variables and batch, float32, at the JAX package's own
  tolerance for that comparison (tests/test_train.py: atol 5e-4, rtol
  5e-3), joint and separate losses; the gather step is held against JAX by
  tests/test_torch_train_step.py.
- The dense collates and flat ids bitwise equal to the JAX package's.
- A dense-trained checkpoint restores in JAX's restore_checkpoint and into
  the port's gather model."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.data import collate as jcollate
from canonicalvoting_tpu.data import dense_prep as jdp
from canonicalvoting_tpu.models.dense_unet import DenseMinkUNet as JaxDense
from canonicalvoting_tpu.train import checkpoint as jckpt
from canonicalvoting_tpu.train import steps as jsteps
from canonicalvoting_tpu.train.losses import joint_losses as jax_joint_losses

from canonicalvoting_tpu_torch.config import Config
from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.data import dense_prep as tdp
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.train import checkpoint as tckpt
from canonicalvoting_tpu_torch.train import steps as tsteps
from canonicalvoting_tpu_torch.train.losses import joint_losses
from canonicalvoting_tpu_torch.utils.weights import (
    flatten, from_jax_variables, to_jax_variables)

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)
from tests.test_torch_train_step import (
    JOINT_OUT, MAX_OBJECTS, TINY, joint_items, separate_items)

PLAN = {k: v for k, v in TINY.items() if k != "block"}
MOM = 0.3


@functools.cache
def _variables(out_channels):
    return randomize(variables_of(MinkUNetBase(3, out_channels, **TINY)),
                     np.random.RandomState(3))


@functools.cache
def _joint_items():
    return joint_items(np.random.RandomState(0), n=2, extent=(0.3, 0.3, 0.3))


def _dense_model(out_channels, variables, dtype="float32"):
    return from_jax_variables(
        DenseMinkUNet(3, out_channels, compute_dtype=dtype, **PLAN),
        variables["params"], variables["batch_stats"])


@functools.cache
def _jax_forward(n_scenes):
    """JAX's dense train forward on the first n_scenes items: (rows, new
    batch_stats, loss), jitted once a scene count."""
    batch = jcollate.collate_joint_dense(_joint_items()[:n_scenes],
                                         cap_multiple=256)
    model = JaxDense(3, JOINT_OUT, compute_dtype="float32", conv_impl="xla",
                     **PLAN)
    dims = tuple(batch["meta"]["grid_dims"])
    fwd = jax.jit(lambda v, f, i, m: model.apply(
        v, f, i, m, dims, True, MOM, n_scenes=n_scenes,
        mutable=["batch_stats"]))
    out, upd = fwd(_variables(JOINT_OUT), jnp.asarray(batch["feats"]),
                   jnp.asarray(batch["flat_idx"]), jnp.asarray(batch["valid"]))
    loss = jax_joint_losses(out, batch["xyz_labels"], batch["scale_labels"],
                            batch["class_labels"], batch["nvalid"],
                            tuple(Config().xyz_weights))["loss"]
    return (np.asarray(out), dict(flatten(jax.device_get(upd["batch_stats"]))),
            float(loss))


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_dense_train_forward_matches_jax(n_scenes):
    items = _joint_items()[:n_scenes]
    b = tcollate.collate_joint_dense(items, cap_multiple=256)
    model = _dense_model(JOINT_OUT, _variables(JOINT_OUT))
    out = model.train_forward(*(torch.from_numpy(b[k]) for k in
                                ("feats", "flat_idx", "valid")),
                              b["meta"]["grid_dims"], MOM,
                              n_scenes=b["meta"]["n_scenes"])
    loss = joint_losses(out, *(torch.from_numpy(b[k]) for k in
                               ("xyz_labels", "scale_labels", "class_labels")),
                        b["nvalid"], tuple(Config().xyz_weights))["loss"]
    want_rows, want_stats, want_loss = _jax_forward(n_scenes)
    np.testing.assert_allclose(out.detach().numpy(), want_rows,
                               atol=1e-5 * np.abs(want_rows).max())
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    got_stats = dict(flatten(to_jax_variables(model)["batch_stats"]))
    assert set(got_stats) == set(want_stats)
    moved = 0
    for k, want in want_stats.items():
        want = np.asarray(want)
        np.testing.assert_allclose(got_stats[k], want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
        start = np.asarray(dict(flatten(_variables(JOINT_OUT)["batch_stats"]))[k])
        moved += not np.array_equal(want, start)
    assert moved == len(want_stats)  # every norm ran in train mode


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _step_grads(kind, backbone):
    """(loss, {name: grad}) of one port step on two scenes, float32."""
    out_ch = JOINT_OUT if kind == "joint" else 8
    variables = _variables(out_ch)
    dense = backbone == "dense"
    if kind == "joint":
        items = _joint_items()
        batch = (tcollate.collate_joint_dense(items, cap_multiple=256) if dense
                 else tcollate.collate_joint(items, cap_multiple=256))
    else:
        items = separate_items(np.random.RandomState(0), n=2,
                               extent=(0.4, 0.3, 0.4))
        batch = tcollate.collate_separate(items, cap_multiple=256,
                                          max_objects=MAX_OBJECTS, dense=dense)
    model = (_dense_model(out_ch, variables) if dense else from_jax_variables(
        MinkUNetBase(3, out_ch, compute_dtype="float32", **TINY),
        variables["params"], variables["batch_stats"]))
    state = tsteps.create_train_state(model, 0.0, device="cpu")
    step = (tsteps.make_joint_train_step(state.model, Config(), backbone=backbone)
            if kind == "joint" else tsteps.make_separate_train_step(
                state.model, Config(), MAX_OBJECTS, backbone=backbone))
    state, losses = step(state, batch, 0.0, 0.5)
    return float(losses["loss"]), _grads(state.model)


@pytest.mark.parametrize("kind", ["joint", "separate"])
def test_dense_grads_match_gather_grads(kind):
    lg, gg = _step_grads(kind, "gather")
    ld, gd = _step_grads(kind, "dense")
    np.testing.assert_allclose(ld, lg, rtol=1e-4)
    assert set(gd) == set(gg)
    assert any(float(g.abs().max()) > 1e-3 for g in gd.values())
    for name, want in gg.items():
        np.testing.assert_allclose(gd[name].numpy(), want.numpy(), atol=5e-4,
                                   rtol=5e-3, err_msg=name)


def _assert_same_batch(got, want):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        if k == "microbatches":
            assert len(got[k]) == len(v)
            for g, w in zip(got[k], v):
                _assert_same_batch(g, w)
        elif k == "meta":
            assert got[k]["ids"] == v["ids"]
            assert tuple(got[k]["grid_dims"]) == tuple(v["grid_dims"])
            assert got[k]["n_scenes"] == v["n_scenes"]
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_dense_collates_match_jax(microbatch):
    joint = joint_items(np.random.RandomState(1), n=4)
    _assert_same_batch(
        tcollate.collate_joint_dense(joint, 256, microbatch=microbatch),
        jcollate.collate_joint_dense(joint, 256, microbatch=microbatch))
    sep = separate_items(np.random.RandomState(1), n=4)
    kw = dict(cap_multiple=256, max_objects=MAX_OBJECTS, dense=True,
              microbatch=microbatch)
    _assert_same_batch(tcollate.collate_separate(sep, **kw),
                       jcollate.collate_separate(sep, **kw))


def test_dense_flat_ids_batched_matches_jax():
    coords = [it[1] for it in joint_items(np.random.RandomState(2), n=3)]
    coords[1] = coords[1] + np.array([40, -7, 3], coords[1].dtype)
    for dims in (None, (96, 64, 96)):
        got, got_dims, got_bases = tdp.dense_flat_ids_batched(coords, dims)
        want, want_dims, want_bases = jdp.dense_flat_ids_batched(coords, dims)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tuple(got_dims) == tuple(want_dims)
        assert all(np.array_equal(a, b) for a, b in zip(got_bases, want_bases))


def test_dense_trained_checkpoint_restores_in_jax_and_the_gather_model(tmp_path):
    """One dense step (AdamW), saved by the port's writer: JAX's
    restore_checkpoint reads it into its own state, and the port's gather
    model loads the same weights and statistics."""
    items = _joint_items()
    state = tsteps.create_train_state_dense(
        MinkUNetBase(3, JOINT_OUT, compute_dtype="float32",
                     generator=torch.Generator().manual_seed(5), **TINY),
        1e-4, device="cpu")
    assert isinstance(state.model, DenseMinkUNet)
    step = tsteps.make_joint_train_step(state.model, Config(), backbone="dense")
    state, _ = step(state, tcollate.collate_joint_dense(items, 256), 1e-3, 0.5)
    path = str(tmp_path / "epoch0.ckpt")
    tckpt.save_checkpoint(path, state, 0)
    variables = to_jax_variables(state.model)
    opt = jsteps.make_optimizer(1e-4)
    template = jsteps.TrainState(
        params=jax.tree_util.tree_map(jnp.zeros_like, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.zeros_like,
                                           variables["batch_stats"]),
        opt_state=opt.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    restored, epoch = jckpt.restore_checkpoint(path, template)
    assert epoch == 0 and int(restored.step) == 1
    for tree in ("params", "batch_stats"):
        got = dict(flatten(jax.device_get(getattr(restored, tree))))
        for k, v in flatten(variables[tree]):
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    gather = MinkUNetBase(3, JOINT_OUT, compute_dtype="float32", **TINY)
    gather, _ = tckpt.restore_checkpoint(
        path, tsteps.create_train_state(gather, 1e-4, device="cpu"))
    want = state.model.state_dict()
    for k, v in gather.model.state_dict().items():
        assert torch.equal(v, want[k]), k
