"""backbone="sparse" on the port's DetectionPipeline and
SeparateDetectionPipeline, on the CPU, against the JAX package's
backbone="sparse" pipelines: head rows (float32, within 1e-5 of their peak)
and detections on planted scenes. The sparse args pad their rows at
far-away coordinates, and the planted rows here hold junk in those padding
rows: every tail stage must drop them, so the detections equal the dense
args' bit for bit. The JAX tails are given finite junk: their lazy
rot/scale sampling multiplies a padding row's zero weight by its scale,
which is NaN where the scale is infinite (ROADMAP.md, section C)."""

import jax
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.decode.peeling import PeelConfig as JaxPeelConfig
from canonicalvoting_tpu.eval.pipeline import DetectionPipeline as JaxPipeline
from canonicalvoting_tpu.eval.separate import (
    SeparateDetectionPipeline as JaxSeparate)
from canonicalvoting_tpu.eval.pipeline import slice_separate_heads as jax_heads
from canonicalvoting_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet

from canonicalvoting_tpu_torch.data.geometry import NCLASSES
from canonicalvoting_tpu_torch.data.synthetic import (
    encode_joint_head_rows, encode_separate_head_rows, make_scene,
    perfect_predictions)
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.pipeline import (
    DetectionPipeline, SceneArgs, SparseSceneArgs)
from canonicalvoting_tpu_torch.eval.separate import SeparateDetectionPipeline
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.utils.weights import (
    from_jax_variables, jax_state_dict)

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

RES, ROTS = 0.05, 24
TINY = dict(layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8), init_dim=8,
            compute_dtype="float32")
OUT = 6 * NCLASSES + NCLASSES + 1
ROW_TOL = 1e-5


def _junk(rows, valid, seed, size):
    """Rows with junk (random, ``size`` times a unit normal) in the padding
    rows: 1e4 makes their exp(scale) infinite, 3 keeps it finite."""
    rows = np.array(rows, np.float32, copy=True)
    pad = np.asarray(valid) == 0
    rng = np.random.RandomState(seed)
    rows[..., pad, :] = rng.randn(*rows[..., pad, :].shape) * size
    return rows


def _rows_close(got, want, nvalid):
    got, want = np.asarray(got)[..., :nvalid, :], np.asarray(want)[..., :nvalid, :]
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= ROW_TOL * peak


def _same_detections(out, ref, n):
    np.testing.assert_array_equal(out["classes"][:n].numpy(),
                                  np.asarray(ref["classes"])[:n])
    # f32 on both sides: a borderline cell of the elimination can flip and
    # move a later argmax a cell (tests/test_torch_pipeline.py)
    np.testing.assert_allclose(out["boxes"][:n].numpy(),
                               np.asarray(ref["boxes"])[:n], atol=8e-3)
    np.testing.assert_allclose(out["scores"][:n].numpy(),
                               np.asarray(ref["scores"])[:n], atol=1e-5)


@pytest.fixture(scope="module")
def joint():
    scene = make_scene(np.random.RandomState(0), extent=(4.0, 2.0, 4.0),
                       n_background=9000, n_boxes=3, pts_per_box=2000)
    model = MinkUNetBase(3, OUT, **TINY)
    variables = randomize(variables_of(model), np.random.RandomState(1))
    from_jax_variables(model, variables["params"], variables["batch_stats"])
    kw = dict(res=RES, num_rots=ROTS, grid_multiple=16, cap_multiple=1024)
    pipe = DetectionPipeline(model=model, backbone="sparse", device="cpu",
                             peel=PeelConfig(res=RES, max_boxes=16, max_iters=48),
                             **kw)
    jpipe = JaxPipeline(model=JaxMinkUNet(in_channels=3, out_channels=OUT, **TINY),
                        variables=variables, backbone="sparse",
                        peel=JaxPeelConfig(res=RES, max_boxes=16, max_iters=48),
                        **kw)
    args = pipe.prepare_scene(scene.points, scene.rgb)
    jargs = jpipe.prepare_scene(scene.points, scene.rgb)
    return scene, pipe, jpipe, args, jargs


def test_sparse_args_match_jax(joint):
    """The sparse prep: the pyramid, the padded feature rows and the rows'
    coordinates with the far-away padding, as JAX's."""
    _, _, _, args, jargs = joint
    assert isinstance(args, SparseSceneArgs)
    _, feats, pyr, coords_w, grid_shape = jargs
    np.testing.assert_array_equal(args.feats.numpy(), np.asarray(feats))
    np.testing.assert_array_equal(args.coords_w.numpy(), np.asarray(coords_w))
    assert args.grid_shape == grid_shape
    assert args.pyramid["nvalid"] == tuple(int(v) for v in pyr["nvalid"])
    for key in ("nbr_conv", "nbr_down", "nbr_up"):
        for a, b in zip(args.pyramid[key], pyr[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(args.pyramid["nbr_stem"].numpy(),
                                  np.asarray(pyr["nbr_stem"]))
    n = args.pyramid["nvalid"][0]
    assert float(args.valid.sum()) == n and float(args.valid[:n].min()) == 1.0
    assert args.table_bytes == sum(np.asarray(t).nbytes for t in (
        pyr["nbr_stem"], *pyr["nbr_conv"], *pyr["nbr_down"], *pyr["nbr_up"]))


def test_sparse_backbone_and_tail_match_jax(joint):
    _, pipe, jpipe, args, jargs = joint
    rows = pipe.run_backbone(args)
    _, feats, pyr, coords_w, grid_shape = jargs
    rows_j = np.asarray(jpipe._backbone_fn(jpipe.variables, feats, pyr))
    n = args.pyramid["nvalid"][0]
    _rows_close(rows.numpy(), rows_j, n)
    out = pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    jout = jpipe.run_scene(jargs)
    assert int(out["n_boxes"]) == int(jout["n_boxes"])
    assert bool(out["truncated"]) == bool(jout["truncated"])


def test_planted_sparse_args_match_jax_and_dense_args(joint):
    """Planted rows (junk in the padding rows) through the sparse args'
    tail: JAX's sparse tail's detections (finite junk), and the dense
    args' (clean rows) bit for bit (non-finite junk)."""
    scene, pipe, jpipe, args, jargs = joint
    valid = args.valid.numpy()
    n = int(valid.sum())
    points_w = args.coords_w.numpy()[:n]
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    clean = encode_joint_head_rows(points_w, xyz, scl, prob > 0.5, cls,
                                   len(valid))
    rows = _junk(clean, valid, 2, 3.0)
    out = pipe.tail(torch.from_numpy(rows), args.coords_w, args.valid,
                    args.grid_shape)
    jout = jpipe._tail_fn(rows, np.asarray(jargs[3]), valid, jargs[4])
    nb = int(out["n_boxes"])
    assert nb == int(jout["n_boxes"]) == 3 and not bool(out["truncated"])
    _same_detections(out, jout, nb)
    dense = DetectionPipeline(
        model=DenseMinkUNet(3, OUT, **TINY), res=RES, num_rots=ROTS,
        peel=pipe.peel, grid_multiple=16, cap_multiple=1024, device="cpu")
    dargs = dense.prepare_scene(scene.points, scene.rgb)
    assert isinstance(dargs, SceneArgs)
    torch.testing.assert_close(dargs.coords_w[:n], args.coords_w[:n], rtol=0,
                               atol=0)
    want = dense.tail(torch.from_numpy(clean), dargs.coords_w, dargs.valid,
                      dargs.grid_shape)
    big = pipe.tail(torch.from_numpy(_junk(clean, valid, 2, 1e4)),
                    args.coords_w, args.valid, args.grid_shape)
    for k in want:
        assert torch.equal(out[k], want[k]) and torch.equal(big[k], want[k]), k


def test_dense_model_runs_sparse_through_its_twin(joint):
    """A DenseMinkUNet handed to backbone="sparse" runs its own weights on
    the sparse backbone."""
    _, pipe, _, args, _ = joint
    dense = DenseMinkUNet(3, OUT, **TINY)
    dense.load_state_dict(pipe.model.state_dict())
    twin = DetectionPipeline(model=dense, backbone="sparse", device="cpu",
                             res=RES, cap_multiple=1024, grid_multiple=16)
    assert isinstance(twin.model, MinkUNetBase)
    torch.testing.assert_close(twin.run_backbone(args), pipe.run_backbone(args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="backbone"):
        DetectionPipeline(model=dense, backbone="gather", device="cpu")


CATS = ["c0", "c1", "c2"]


@pytest.fixture(scope="module")
def separate():
    rng = np.random.RandomState(0)
    sc = make_scene(rng, extent=(2.0, 1.2, 2.0), n_background=4000,
                    n_boxes=2, pts_per_box=1500)
    coords, _ = sparse_quantize(sc.points, RES)
    feats = rng.rand(len(coords), 3).astype(np.float32)
    plan = DenseMinkUNet(3, 8, **TINY)
    variables = [randomize(variables_of(plan), np.random.RandomState(i))
                 for i in range(len(CATS))]
    pipe = SeparateDetectionPipeline(
        model=plan, categories=CATS, res=RES, num_rots=ROTS, grid_multiple=16,
        cap_multiple=512, backbone="sparse", device="cpu",
        peel=PeelConfig(res=RES, max_boxes=8, max_iters=24,
                        elimination_inclusive=False),
        state_dicts=[jax_state_dict(v["params"], v["batch_stats"])
                     for v in variables])
    args = pipe.prepare_quantized(coords, feats)
    jmodel = JaxMinkUNet(in_channels=3, out_channels=8, **TINY)
    jpipe = JaxSeparate(
        model=jmodel, stacked_variables=None, categories=CATS, res=RES,
        num_rots=ROTS, backbone="sparse", grid_multiple=16, cap_multiple=512,
        peel=JaxPeelConfig(res=RES, max_boxes=8, max_iters=24,
                           elimination_inclusive=False))
    jpipe.set_variables_list(variables)
    jargs = jpipe.prepare_quantized(coords, feats)
    return sc, variables, pipe, args, jpipe, jargs, jmodel, (coords, feats)


def test_separate_sparse_head_rows_and_scene_match_jax(separate):
    _, variables, pipe, args, jpipe, jargs, jmodel, _ = separate
    heads = pipe.backbones(args)
    assert heads.shape == (len(CATS), args.valid.shape[0], 8)
    _, feats, pyr, _, _ = jargs
    apply = jax.jit(lambda v, f, p: jmodel.apply(v, f, p, False))
    n = args.pyramid["nvalid"][0]
    for c, v in enumerate(variables):
        _rows_close(heads[c].numpy(), np.asarray(apply(v, feats, pyr)), n)
    out = pipe.run_scene(args)
    jout = jax.device_get(jpipe.run_scene(jargs))
    np.testing.assert_array_equal(out["n_boxes"].numpy(),
                                  np.asarray(jout["n_boxes"]))


def test_separate_planted_sparse_args_match_jax_and_dense_args(separate):
    """Planted rows (junk in the padding rows): each category's detections
    equal JAX's sparse tail's and, bit for bit, the dense args'."""
    sc, _, pipe, args, jpipe, jargs, _, quantized = separate
    valid = args.valid.numpy()
    n = int(valid.sum())
    pw = args.coords_w.numpy()[:n]
    xyz, scl, prob, cls = perfect_predictions(sc, pw)
    cls_cat = np.full_like(cls, -1)
    for bi, b in enumerate(sc.boxes):
        cls_cat[cls == b.class_idx] = bi
    clean = np.stack([encode_separate_head_rows(
        pw, xyz, scl, (prob > 0.5) & (cls_cat == c), len(valid))
        for c in range(len(CATS))])
    planted = _junk(clean, valid, 3, 3.0)
    out = pipe.run_scene(args, planted=planted)
    nb = out["n_boxes"].numpy()
    assert nb[0] >= 1 and nb[1] >= 1 and nb[2] == 0
    _, _, _, coords_w, grid_shape = jargs
    tail = jax.jit(lambda r: jpipe._vote_and_peel(
        *_exp_heads(r), coords_w, valid, grid_shape))
    for c in range(len(CATS)):
        jout = jax.device_get(tail(planted[c]))
        assert int(jout["n_boxes"]) == nb[c]
        _same_detections({k: v[c] for k, v in out.items()}, jout, nb[c])
    dense = SeparateDetectionPipeline(
        model=DenseMinkUNet(3, 8, **TINY), categories=CATS, res=RES,
        num_rots=ROTS, grid_multiple=16, cap_multiple=512, peel=pipe.peel,
        device="cpu")
    dargs = dense.prepare_quantized(*quantized)
    want = dense.tail(torch.from_numpy(clean), dargs)
    big = pipe.run_scene(args, planted=_junk(clean, valid, 3, 1e4))
    for k in want:
        assert torch.equal(out[k], want[k]) and torch.equal(big[k], want[k]), k
    with pytest.raises(ValueError, match="group_size"):
        SeparateDetectionPipeline(model=DenseMinkUNet(3, 8, **TINY),
                                  backbone="sparse", group_size=2, device="cpu")


def _exp_heads(rows):
    import jax.numpy as jnp

    xyz, scale, prob = jax_heads(rows)
    return xyz, jnp.exp(scale), prob



def test_default_device_is_the_gpu():
    model = MinkUNetBase(3, OUT, **TINY)
    if torch.cuda.is_available():
        assert DetectionPipeline(model=model, backbone="sparse").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            DetectionPipeline(model=model, backbone="sparse")
