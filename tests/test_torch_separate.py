"""The port's SeparateDetectionPipeline on the CPU against the JAX package's
SeparateDetectionPipeline(backbone="dense", conv_impl="xla"), on the planted
three-category scene of tests/test_separate_eval.py:199-257 (2 x 1.2 x 2 m,
4,000 background points, 2 boxes, res 0.05 m)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.decode.peeling import PeelConfig as JaxPeelConfig
from canonicalvoting_tpu.eval.separate import (
    SeparateDetectionPipeline as JaxSeparate)
from canonicalvoting_tpu.models.dense_unet import DenseMinkUNet as JaxDenseMinkUNet
from canonicalvoting_tpu.models.minkunet import MinkUNetBase

from canonicalvoting_tpu_torch.data.synthetic import (
    encode_separate_head_rows, make_scene, perfect_predictions)
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.separate import SeparateDetectionPipeline
from canonicalvoting_tpu_torch.models.dense_unet import (
    DOWN_KERNELS, DenseMinkUNet)
from canonicalvoting_tpu_torch.ops.tiled_conv import (
    down2_weights, prefold_stem_weights)
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.utils.weights import jax_state_dict

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    TINY_PLANES, one_torch_thread, randomize, variables_of)

RES, ROTS = 0.05, 24
CATS = ["c0", "c1", "c2"]
SMALL = dict(layers=(1,) * 8, planes=TINY_PLANES, init_dim=8,
             compute_dtype="float32")


def _model():
    return DenseMinkUNet(3, 8, **SMALL)


def _pipe(**kw):
    return SeparateDetectionPipeline(
        model=_model(), categories=CATS, res=RES, num_rots=ROTS,
        grid_multiple=16, cap_multiple=512,
        peel=PeelConfig(res=RES, max_boxes=8, max_iters=24,
                        elimination_inclusive=False), device="cpu", **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    sc = make_scene(rng, extent=(2.0, 1.2, 2.0), n_background=4000,
                    n_boxes=2, pts_per_box=1500)
    coords, _ = sparse_quantize(sc.points, RES)
    feats = rng.rand(len(coords), 3).astype(np.float32)
    variables = [randomize(variables_of(_model()), np.random.RandomState(i))
                 for i in range(len(CATS))]
    state_dicts = [jax_state_dict(v["params"], v["batch_stats"])
                   for v in variables]
    pipe = _pipe(state_dicts=state_dicts)
    args = pipe.prepare_quantized(coords, feats)
    # box c's confident points plant category c; the third stays empty
    vmask = args.valid.numpy() > 0
    pw = args.coords_w.numpy()[vmask]
    xyz, scl, prob, cls = perfect_predictions(sc, pw)
    cls_cat = np.full_like(cls, -1)
    for bi, b in enumerate(sc.boxes):
        cls_cat[cls == b.class_idx] = bi
    planted = np.stack([encode_separate_head_rows(
        pw, xyz, scl, (prob > 0.5) & (cls_cat == c), len(vmask))
        for c in range(len(CATS))])
    jpipe = JaxSeparate(
        model=MinkUNetBase(in_channels=3, out_channels=8, block="basic",
                           **SMALL),
        stacked_variables=None, categories=CATS, res=RES, num_rots=ROTS,
        backbone="dense", conv_impl="xla", grid_multiple=16, cap_multiple=512,
        peel=JaxPeelConfig(res=RES, max_boxes=8, max_iters=24,
                           elimination_inclusive=False))
    jpipe.set_variables_list(variables)
    jargs = jpipe.prepare_quantized(coords, feats)
    return state_dicts, variables, pipe, args, planted, jpipe, jargs


def test_planted_scene_matches_jax(setup, monkeypatch):
    """The lazy tail splats the three categories in one hv_splat call
    (objectness with a leading category axis) and finds the JAX package's
    detections."""
    import canonicalvoting_tpu_torch.ops.hough_voting as thv

    _, _, pipe, args, planted, jpipe, jargs = setup
    calls, real = [], thv.hv_splat
    monkeypatch.setattr(thv, "hv_splat", lambda *a, **k: calls.append(
        tuple(a[3].shape)) or real(*a, **k))
    out = pipe.run_scene(args, planted=planted)
    assert calls == [(len(CATS), args.valid.shape[0])]
    jout = jax.device_get(jpipe.run_scene(jargs, planted=planted))
    n = out["n_boxes"].numpy()
    np.testing.assert_array_equal(n, np.asarray(jout["n_boxes"]))
    assert n[0] >= 1 and n[1] >= 1 and n[2] == 0
    for c in range(len(CATS)):
        # f32 on both sides: a borderline cell of the elimination can flip
        # and move a later argmax a cell (tests/test_torch_pipeline.py)
        np.testing.assert_allclose(out["boxes"][c, :n[c]].numpy(),
                                   np.asarray(jout["boxes"])[c, :n[c]],
                                   atol=8e-3)
        np.testing.assert_allclose(out["scores"][c, :n[c]].numpy(),
                                   np.asarray(jout["scores"])[c, :n[c]],
                                   atol=1e-5)
    got, want = pipe.postprocess(out), jpipe.postprocess(jout)
    assert sorted(c for c, _, _ in got) == sorted(c for c, _, _ in want)
    assert {c for c, _, _ in got} == {"c0", "c1"}


def test_head_rows_match_jax(setup):
    """Random JAX weights for three categories, carried across by
    utils.weights.jax_state_dict: the same head rows as the JAX dense XLA
    backbone (atol 2e-3, as tests/test_torch_dense_unet.py)."""
    _, variables, pipe, args, _, jpipe, _ = setup
    heads = pipe.backbones(args).numpy()
    jmodel = JaxDenseMinkUNet(in_channels=3, out_channels=8, block="basic",
                              conv_impl="xla", **SMALL)
    apply = jax.jit(lambda v, f, fl, va: jmodel.apply(
        v, f, fl, va, args.dense_dims, False))
    feats, flat, valid = (args.feats.numpy(), args.flat.numpy(),
                          args.valid.numpy())
    for c, v in enumerate(variables):
        want = np.asarray(apply(v, feats, flat, valid))
        np.testing.assert_allclose(heads[c], want, atol=2e-3, rtol=1e-3)
    assert np.abs(heads).max() > 0.1


def test_each_category_stem_is_folded_once(setup):
    """The prefold stem's weights are folded K-major once per category when
    the weights are installed: each is prefold_stem_weights of that
    category's stem kernel."""
    state_dicts, _, pipe, _, _, _, _ = setup
    assert len(pipe.stem_wt) == len(CATS)
    for sd, wt in zip(state_dicts, pipe.stem_wt):
        want = prefold_stem_weights(torch.as_tensor(sd["conv0p1s1.kernel"]), 5,
                                    dtype=torch.float32, device="cpu")
        torch.testing.assert_close(wt, want, rtol=0, atol=0)


def test_each_category_down_is_laid_out_once(setup):
    """The four down convs' weights are laid out K-major once per category
    when the weights are installed: each is down2_weights of that
    category's kernel, in DOWN_KERNELS' order."""
    state_dicts, _, pipe, _, _, _, _ = setup
    assert len(pipe.down_wt) == len(CATS)
    for sd, wts in zip(state_dicts, pipe.down_wt):
        assert len(wts) == len(DOWN_KERNELS)
        for key, wt in zip(DOWN_KERNELS, wts):
            want = down2_weights(torch.as_tensor(sd[key]), dtype=torch.float32,
                                 device="cpu")
            torch.testing.assert_close(wt, want, rtol=0, atol=0)


def test_grouped_equals_single(setup):
    """group_size=2 (three categories: groups [0, 1] and [2, 2]) gives the
    per-category nets' head rows and detections."""
    state_dicts, _, pipe, args, _, _, _ = setup
    pipe2 = _pipe(state_dicts=state_dicts, group_size=2)
    h1, h2 = pipe.backbones(args), pipe2.backbones(args)
    torch.testing.assert_close(h2, h1, rtol=1e-5, atol=1e-5)
    o1, o2 = pipe.tail(h1, args), pipe2.tail(h2, args)
    torch.testing.assert_close(o2["n_boxes"], o1["n_boxes"], rtol=0, atol=0)
    torch.testing.assert_close(o2["boxes"], o1["boxes"], rtol=1e-4, atol=1e-4)
    assert len(pipe2.postprocess(o2)) == len(pipe.postprocess(o1))


def test_nonlazy_equals_lazy(setup):
    """lazy_rot_scale=False (one hough_voting over the categories, and the
    batched peel on the rotation and scale grids) finds the lazy pipeline's
    boxes: same counts, boxes within one vote cell."""
    state_dicts, _, pipe, args, planted, _, _ = setup
    full = _pipe(state_dicts=state_dicts, lazy_rot_scale=False)
    votes = full.vote(torch.as_tensor(planted), args)
    assert all(g.shape == (len(CATS),) + args.grid_shape + tail for g, tail in
               zip(votes["grids"], ((), (2,), (3,))))
    lazy, out = pipe.run_scene(args, planted=planted), full.run_scene(
        args, planted=planted)
    n = lazy["n_boxes"].numpy()
    np.testing.assert_array_equal(out["n_boxes"].numpy(), n)
    assert n[0] >= 1 and n[1] >= 1 and n[2] == 0
    for c in range(len(CATS)):
        np.testing.assert_allclose(out["boxes"][c, :n[c]].numpy(),
                                   lazy["boxes"][c, :n[c]].numpy(), atol=RES)


def test_nonlazy_tail_splats_the_categories_once(setup, monkeypatch):
    """The non-lazy tail makes one 6-channel splat over the categories; its
    grids equal the per-category calls stacked, bitwise (each category's
    sums are its own call's), and the batched peel finds the same boxes on
    both."""
    import canonicalvoting_tpu_torch.ops.hough_voting as thv

    state_dicts, _, _, args, planted, _, _ = setup
    full = _pipe(state_dicts=state_dicts, lazy_rot_scale=False)
    calls, real = [], thv.hv_splat6
    monkeypatch.setattr(thv, "hv_splat6", lambda *a, **k: calls.append(
        tuple(a[3].shape)) or real(*a, **k))
    votes = full.vote(torch.as_tensor(planted), args)
    assert calls == [(len(CATS), args.valid.shape[0])]
    kw = dict(res=RES, num_rots=ROTS, grid_shape=args.grid_shape,
              corners=votes["corners"], valid=args.valid)
    singles = [thv.hough_voting(args.coords_w, votes["xyz"][c],
                                votes["scale"][c], votes["prob"][c], **kw)
               for c in range(len(CATS))]
    stacked = tuple(torch.stack(g) for g in zip(*singles))
    for got, want in zip(votes["grids"], stacked):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    out = full.peel_votes(votes, args)
    before = full.peel_votes(dict(votes, grids=stacked), args)
    assert out.keys() == before.keys()
    for k in out:
        torch.testing.assert_close(out[k], before[k], rtol=0, atol=0)
    assert out["n_boxes"][0] >= 1 and out["n_boxes"][1] >= 1


def test_variants_give_the_default_detections(setup, monkeypatch):
    """up_impl="into" in every category's model (through the model's
    config()) and hv_method="pallas_windowed" for the splats, over a vote
    grid of 32-cell x buckets: the variant runs every category's into-convs
    and one windowed splat over the categories, and finds the default
    routes' detections."""
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as thv

    state_dicts, _, default, args, planted, _, _ = setup
    calls, real_up, real_splat = [], du.tiled_up2_into, thv.hv_splat_windowed
    monkeypatch.setattr(du, "tiled_up2_into", lambda *a, **k: calls.append(
        "into") or real_up(*a, **k))
    monkeypatch.setattr(thv, "hv_splat_windowed", lambda *a, **k: calls.append(
        "windowed") or real_splat(*a, **k))
    variant = SeparateDetectionPipeline(
        model=DenseMinkUNet(3, 8, up_impl="into", **SMALL),
        state_dicts=state_dicts, categories=CATS, res=RES, num_rots=ROTS,
        cap_multiple=512, peel=default.peel, hv_method="pallas_windowed",
        device="cpu")
    assert variant.net.up_impl == "into"
    gs = args.grid_shape
    args = dataclasses.replace(args, grid_shape=(-(-gs[0] // 32) * 32,) + gs[1:])
    heads = torch.as_tensor(planted)
    want, got = default.tail(heads, args), variant.run_scene(args, planted=heads)
    assert calls[:2 * len(CATS)] == ["into"] * 2 * len(CATS)
    assert calls.count("windowed") == 1  # the categories in one call
    assert want["n_boxes"].tolist()[:2] >= [1, 1]
    torch.testing.assert_close(got["n_boxes"], want["n_boxes"], rtol=0, atol=0)
    torch.testing.assert_close(got["boxes"], want["boxes"], rtol=0, atol=1e-5)
    assert [c for c, _, _ in variant.postprocess(got)] == \
        [c for c, _, _ in default.postprocess(want)]
    with pytest.raises(ValueError, match="hv_method"):
        _pipe(hv_method="pallas_interpret")


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        assert SeparateDetectionPipeline(model=_model()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            SeparateDetectionPipeline(model=_model())
    # backbone="sparse" is ported (tests/test_torch_sparse_pipeline.py): it
    # defaults to the card too, and an unknown backbone raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            SeparateDetectionPipeline(model=_model(), backbone="sparse")
    with pytest.raises(ValueError, match="backbone"):
        SeparateDetectionPipeline(model=_model(), backbone="gather",
                                  device="cpu")
