"""The sparse ResNet classifier of the port (models/resnet_classifier.py)
against the JAX package's: the toy patterns equal JAX's draws, the logits
(evaluation and training mode, and the running statistics a training
forward leaves) equal JAX's on the same weights (the port's as a JAX
variables tree, which JAX's classifier applies and utils/weights.py
loads back) within 1e-5 of their peak (float32 sums in another order), and the toy demo learns (JAX tests/test_resnet_classifier.py:17:
six samples, fifteen epochs of Adam at 5e-3, the last epoch's loss below
the first's)."""

import jax
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.models.resnet_classifier import (
    SparseResNetClassifier as JaxClassifier)
from canonicalvoting_tpu.models.resnet_classifier import (
    toy_pattern_batch as jax_toy_pattern_batch)
from canonicalvoting_tpu.ops.coords import PyramidSpec as JaxSpec
from canonicalvoting_tpu.ops.coords import build_pyramid as jax_build_pyramid

from canonicalvoting_tpu_torch.models.resnet_classifier import (
    SparseResNetClassifier, toy_pattern_batch)
from canonicalvoting_tpu_torch.ops.coords import PyramidSpec, build_pyramid
from canonicalvoting_tpu_torch.utils.weights import (
    flatten, from_jax_variables, to_jax_variables)

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401

NARROW = dict(layers=(1, 1, 1, 1), planes=(8, 16, 16, 16), init_dim=8)


def _samples(seed, n=6):
    """The JAX test's fixed set: draws until every class is in and there
    are six."""
    rng = np.random.RandomState(seed)
    samples = []
    while {s[2] for s in samples} != {0, 1, 2} or len(samples) < n:
        samples.append(toy_pattern_batch(rng))
    return samples


def _prep(coords, feats):
    pyr = build_pyramid(coords, PyramidSpec(cap_multiple=64))
    f = np.zeros((pyr.coords[0].shape[0], 1), np.float32)
    f[:len(feats)] = feats
    tables, (ft,) = pyr.to("cpu", [f])
    return ft, tables, pyr


def test_toy_patterns_equal_jax_draws():
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(5):
        for x, y in zip(toy_pattern_batch(a), jax_toy_pattern_batch(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("train", [False, True])
def test_logits_match_jax_on_the_same_weights(train):
    """Weights drawn by the port, as a JAX variables tree (to_jax_variables)
    in JAX's classifier, and loaded back into a fresh port model
    (from_jax_variables)."""
    coords, feats, _ = _samples(0, 3)[0]
    ft, tables, _ = _prep(coords, feats)
    jpyr = jax_build_pyramid(coords, JaxSpec(cap_multiple=64)).as_jax_inputs()
    jmodel = JaxClassifier(1, 3, **NARROW)
    variables = to_jax_variables(SparseResNetClassifier(
        1, 3, **NARROW, generator=torch.Generator().manual_seed(1)))
    model = SparseResNetClassifier(1, 3, **NARROW)
    from_jax_variables(model, variables["params"], variables["batch_stats"])
    if train:
        want, upd = jmodel.apply(variables, ft.numpy(), jpyr, True, 0.3,
                                 mutable=["batch_stats"])
        got = model(ft, tables, True, 0.3)
        stats = dict(flatten(jax.device_get(upd["batch_stats"])))
        for n, b in model.named_buffers():
            want_b = np.asarray(stats[n])
            assert float(np.abs(b.numpy() - want_b).max()) <= 1e-5 * float(
                np.abs(want_b).max()), n
    else:
        want = jmodel.apply(variables, ft.numpy(), jpyr, False)
        got = model(ft, tables, False)
    want = np.asarray(want)
    assert got.shape == want.shape == (3,)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_toy_classifier_learns():
    torch.manual_seed(0)
    model = SparseResNetClassifier(1, 3, **NARROW,
                                   generator=torch.Generator().manual_seed(0))
    preps = [(*_prep(c, f)[:2], label) for c, f, label in _samples(0)]
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    totals = []
    for _ in range(15):
        total = 0.0
        for f, tables, label in preps:
            logits = model(f, tables, True)
            loss = -torch.log_softmax(logits, -1)[label]
            opt.zero_grad()
            loss.backward()
            opt.step()
            total += float(loss.detach())
        totals.append(total)
    assert totals[-1] < totals[0], totals
