"""Block rematerialization (tpu.train_remat; models/norm.py:remat) on both
training backbones, on the CPU: one step with remat gives the losses,
gradients and running statistics of one step without it, bit for bit (the
recomputed forward repeats the same operations, and the non-reentrant
checkpoint keeps the autograd graph of a plain call); the recompute really
runs, and every norm's running statistics are updated once a step, where a
plain torch.utils.checkpoint of a train-mode norm would update them
twice."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from canonicalvoting_tpu_torch.config import Config
from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.models import norm as tnorm
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.train import steps as tsteps

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import JOINT_OUT, TINY, joint_items

PLAN = {k: v for k, v in TINY.items() if k != "block"}
# the two backbones: (model, collate, step backbone); gather in bf16, dense
# in float32 (the CPU's dense bf16 convs are slow)
BACKBONES = {
    "gather": (lambda: MinkUNetBase(3, JOINT_OUT, compute_dtype="bfloat16",
                                    generator=torch.Generator().manual_seed(1),
                                    **TINY),
               tcollate.collate_joint, "gather"),
    "dense": (lambda: DenseMinkUNet(3, JOINT_OUT, compute_dtype="float32",
                                    **PLAN), tcollate.collate_joint_dense,
              "dense"),
}


@functools.cache
def _step(backbone, remat):
    """(losses, grads, buffers, version bumps a buffer, recomputed blocks)
    of one step on two scenes, computed once."""
    make, collate, route = BACKBONES[backbone]
    torch.manual_seed(2)
    state = tsteps.create_train_state(make(), 0.0, device="cpu", remat=remat)
    step = tsteps.make_joint_train_step(state.model, Config(), backbone=route)
    batch = collate(joint_items(np.random.RandomState(0), n=2), cap_multiple=256)
    versions = {n: b._version for n, b in state.model.named_buffers()}
    recomputed = []
    frozen = tnorm.frozen_running_stats

    @contextlib.contextmanager
    def spy():  # entered when the backward recomputes a block
        recomputed.append(1)
        with frozen():
            yield

    tnorm.frozen_running_stats = spy
    try:
        state, losses = step(state, batch, 1e-3, 0.3)
    finally:
        tnorm.frozen_running_stats = frozen
    bumps = {n: b._version - versions[n] for n, b in state.model.named_buffers()}
    return (losses, {n: p.grad for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()}, bumps,
            len(recomputed))


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_remat_step_is_bitwise_neutral(backbone):
    l0, g0, b0, _, n0 = _step(backbone, False)
    l1, g1, b1, _, n1 = _step(backbone, True)
    n_blocks = sum(TINY["layers"])
    assert n0 == 0 and n1 == n_blocks  # each block's forward ran again
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    assert set(g0) == set(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_running_stats_move_once_a_step_under_remat(backbone):
    """Each buffer takes one running update a step: two in-place ops
    (mul_, add_), with remat as without."""
    _, _, _, plain_bumps, _ = _step(backbone, False)
    _, _, after, bumps, _ = _step(backbone, True)
    assert bumps and set(bumps.values()) == set(plain_bumps.values()) == {2}
    torch.manual_seed(2)
    fresh = dict(BACKBONES[backbone][0]().named_buffers())
    assert all(not torch.equal(after[n], fresh[n]) for n in after)


def test_a_plain_checkpoint_would_update_twice():
    """What remat guards against: a train-mode norm under a bare
    torch.utils.checkpoint updates its statistics again when the backward
    recomputes it; under models/norm.py:remat it does not."""
    x = torch.randn(64, 4, requires_grad=True)
    for wrap, want in ((lambda f, *a: torch.utils.checkpoint.checkpoint(
            f, *a, use_reentrant=False), 4), (tnorm.remat, 2)):
        bn = tnorm.MaskedBatchNorm(4)
        v0 = bn.mean._version
        wrap(bn, x, 64, True, 0.1).sum().backward()
        assert bn.mean._version - v0 == want
