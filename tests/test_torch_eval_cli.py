"""The port's evaluation CLIs on the CPU over toy data trees, and its reader
of the JAX package's ``.ckpt`` files.

``eval_joint.main`` (ScanNet and ``--scenenn``) and ``eval_separate.main``
must hand ``compute_map`` the detections the port's pipelines give on the
dataset's arrays with the same weights, and the ground truth of the tree.
The model constructor is narrowed, so that the plain CPU convs stay cheap,
and the separate pipeline takes 24 rotations and 512-row padding, so that
its nine categories' peel does; the pipelines themselves are held against JAX by test_torch_pipeline.py
and test_torch_separate.py. The backbones run, and their rows are compared,
but the tails decode planted rows (the scene's own boxes), so that the
detections are not empty.
"""

import functools
import json
import os
import re
import sys

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.train.checkpoint import (
    export_torch_style, save_checkpoint)
from canonicalvoting_tpu.train.steps import TrainState, make_optimizer

import canonicalvoting_tpu_torch.eval.separate as separate
import canonicalvoting_tpu_torch.metrics.ap as ap
import canonicalvoting_tpu_torch.models as models
from canonicalvoting_tpu_torch import eval_joint, eval_separate
from canonicalvoting_tpu_torch.config import load_config
from canonicalvoting_tpu_torch.data.scannet import (
    SceneNNDataset, ScanNetXYZProbMultiDataset)
from canonicalvoting_tpu_torch.data.synthetic import (
    encode_joint_head_rows, encode_separate_head_rows, make_scene,
    perfect_predictions)
from canonicalvoting_tpu_torch.data.synthetic_tree import (
    write_scannet_tree, write_scenenn_tree)
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.gt import load_gt_scene
from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
from canonicalvoting_tpu_torch.eval.separate import (
    ALL_CATEGORIES, SeparateDetectionPipeline)
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.train.checkpoint import (
    msgpack_restore, read_checkpoint)
from canonicalvoting_tpu_torch.utils.weights import (
    category_state_dicts, jax_state_dict, load_ckpt)

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    TINY_PLANES, _cached_setup, one_torch_thread, randomize, variables_of)

RES = 0.08
# the separate pipeline's rotations and row padding in these tests
SEPARATE_KW = dict(num_rots=24, cap_multiple=512)
ARGS = ["--cpu", "--no-mesh", f"scannet_res={RES}", "tpu.conv_dtype=float32"]


def narrow_unet(in_channels, out_channels, **kw):
    return DenseMinkUNet(in_channels, out_channels, layers=(1,) * 8,
                         planes=TINY_PLANES, init_dim=8, **kw)


@pytest.fixture(scope="module")
def scene():
    """A 1 x 0.7 x 1 m room with two boxes (1,400 points)."""
    return make_scene(np.random.RandomState(0), extent=(1.0, 0.7, 1.0),
                      n_background=800, n_boxes=2, pts_per_box=300,
                      scale_range=(0.15, 0.25))


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(models, "DenseMinkUNet34C", narrow_unet)
    monkeypatch.setattr(separate, "SeparateDetectionPipeline", functools.partial(
        SeparateDetectionPipeline, **SEPARATE_KW))


def _rows(scene, args, n_categories=None):
    valid = args.valid.numpy() > 0
    pw = args.coords_w.numpy()[valid]
    xyz, scl, prob, cls = perfect_predictions(scene, pw)
    if n_categories is None:
        return torch.from_numpy(encode_joint_head_rows(
            pw, xyz, scl, prob > 0.5, cls, len(valid)))
    return torch.from_numpy(np.stack([encode_separate_head_rows(
        pw, xyz, scl, (prob > 0.5) & (cls == c), len(valid))
        for c in range(n_categories)]))


@pytest.fixture
def planted(monkeypatch, scene):
    """The backbones run and their rows are recorded; the tails get the
    scene's planted rows."""
    heads = []
    joint, sep = DetectionPipeline.run_backbone, SeparateDetectionPipeline.backbones

    def backbone(self, args):
        heads.append(joint(self, args))
        return _rows(scene, args)

    def backbones(self, args, shared=None):
        heads.append(sep(self, args, shared))
        return _rows(scene, args, len(self.categories))

    monkeypatch.setattr(DetectionPipeline, "run_backbone", backbone)
    monkeypatch.setattr(SeparateDetectionPipeline, "backbones", backbones)
    return heads


@pytest.fixture
def captured(monkeypatch):
    """What the CLI hands compute_map, at each threshold."""
    calls = []
    real = ap.compute_map

    def compute_map(pred, gt, **kw):
        calls.append((pred, gt, kw["ovthresh"]))
        return real(pred, gt, **kw)

    monkeypatch.setattr(ap, "compute_map", compute_map)
    return calls


def assert_same_detections(got, want):
    assert [(c, s) for c, _, s in got] == [(c, s) for c, _, s in want]
    for (_, b, _), (_, wb, _) in zip(got, want):
        assert np.array_equal(b, wb)


@pytest.mark.parametrize("source", ["scannet", "scenenn"])
def test_eval_joint_matches_pipeline(tmp_path, scene, narrow, planted,
                                     captured, source):
    if source == "scenenn":
        pytest.importorskip("h5py")
        overrides = write_scenenn_tree(str(tmp_path), [scene], ids=("011",))
        argv = ["--scenenn"] + overrides
    else:
        overrides = write_scannet_tree(str(tmp_path), [scene])
        argv = overrides
    results = eval_joint.main(argv + ARGS)
    cli_heads = planted[:]
    assert sorted(results) == [0.25, 0.5]
    assert all(np.isfinite(d["mAP"]) for d in results.values())
    assert [t for _, _, t in captured] == [0.25, 0.5]
    pred, gt, _ = captured[0]

    cfg = load_config(None, overrides + ARGS)
    ds = (SceneNNDataset if source == "scenenn" else
          ScanNetXYZProbMultiDataset)(cfg, training=False, augment=False)
    torch.manual_seed(0)
    pipe = DetectionPipeline(
        model=narrow_unet(3, 64, compute_dtype="float32"), res=RES,
        peel=PeelConfig(res=RES, max_boxes=64), device="cpu")
    id_scan, coords, feats = ds[0][:3]
    want = pipe.postprocess(pipe.run_scene_with_retry(
        pipe.prepare_quantized(coords, feats)))
    gt_dir = (os.path.join(str(tmp_path), "results_gt")
              if source == "scenenn" else cfg.data.gt_path)
    if source == "scenenn":
        want = [d for d in want if d[0] in eval_joint.SCENENN_CLASSES]
    assert list(pred) == [id_scan] and want
    assert_same_detections(pred[id_scan], want)
    assert len(cli_heads) == len(planted) - len(cli_heads)
    for a, b in zip(cli_heads, planted[len(cli_heads):]):
        assert torch.equal(a, b)
    want_gt = load_gt_scene(gt_dir, id_scan, scenenn=source == "scenenn")
    assert [c for c, _ in gt[id_scan]] == [c for c, _ in want_gt]
    for (_, b), (_, wb) in zip(gt[id_scan], want_gt):
        assert np.array_equal(b, wb)
    if source == "scenenn":  # SceneNN's "television" is Scan2CAD's display
        assert "display" in [c for c, _ in gt[id_scan]]


def test_eval_separate_matches_pipeline(tmp_path, scene, narrow, planted,
                                        captured):
    overrides = write_scannet_tree(str(tmp_path), [scene])
    results = eval_separate.main(overrides + ARGS)
    cli_heads = planted[:]
    assert all(np.isfinite(d["mAP"]) for d in results.values())
    pred, gt, _ = captured[0]

    cfg = load_config(None, overrides + ARGS)
    ds = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)
    plan = narrow_unet(3, 8, compute_dtype="float32")
    pipe = SeparateDetectionPipeline(
        model=plan, res=RES,
        peel=PeelConfig(res=RES, elimination_inclusive=False, max_boxes=64),
        device="cpu", **SEPARATE_KW)
    pipe.set_state_dicts(category_state_dicts(plan, ALL_CATEGORIES))
    id_scan, coords, feats = ds[0][:3]
    want = pipe.detect(coords, feats)
    assert list(pred) == [id_scan] and want
    assert_same_detections(pred[id_scan], want)
    assert torch.equal(cli_heads[0], planted[1])
    want_gt = load_gt_scene(cfg.data.gt_path, id_scan)
    assert [c for c, _ in gt[id_scan]] == [c for c, _ in want_gt]


# ---------------------------------------------------------------------------
# the JAX package's .ckpt

def test_ckpt_reader_matches_save_checkpoint(tmp_path):
    """A TrainState of the toy dense UNet's variables and an Adam state,
    written by the JAX package's save_checkpoint: every params and
    batch-stats leaf comes back bit for bit, with the epoch, and the port
    model loaded from it gives the JAX model's rows."""
    model, variables, args, want = _cached_setup((1,) * 8)
    params = variables["params"]
    state = TrainState(params=params, batch_stats=variables["batch_stats"],
                       opt_state=make_optimizer(0.0).init(params),
                       step=jnp.zeros((), jnp.int32))
    path = str(tmp_path / "epoch7.ckpt")
    save_checkpoint(path, state, epoch=7)
    tree, epoch = read_checkpoint(path)
    assert epoch == 7
    assert set(tree) == {"params", "batch_stats", "opt_state", "step"}

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    for name in ("params", "batch_stats"):
        got, ref = dict(leaves(tree[name])), dict(leaves(variables[name]))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
    assert int(tree["step"]) == 0

    fresh = DenseMinkUNet(3, 10, layers=(1,) * 8, planes=TINY_PLANES,
                          init_dim=8, compute_dtype="float32")
    load_ckpt(fresh, path)
    # the tolerance of test_torch_dense_unet.py's JAX parity
    np.testing.assert_allclose(fresh(*args).numpy(), want, atol=2e-3, rtol=1e-3)


def test_msgpack_restore_matches_flax(monkeypatch):
    """Chunked arrays (flax's MAX_CHUNK_SIZE made small), bfloat16, numpy
    scalars and every msgpack type flax's msgpack_serialize writes."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(5)
    tree = {
        "chunked": rng.randn(10, 10).astype(np.float32),
        "bf16_chunked": jnp.asarray(rng.randn(5, 8), jnp.bfloat16),
        "bf16": jnp.asarray(rng.randn(3), jnp.bfloat16),
        "int8": np.arange(-4, 4, dtype=np.int8), "f32": np.float32(1.5),
        "i64": np.int64(-9), "none": None, "yes": True, "no": False,
        "text": "t" * 40, "long": "u" * 300, "bytes": b"\x00\x01",
        "float": 3.25, "list": list(range(20)) + ["x", [1.5]],
        "ints": [5, 200, 60000, 2 ** 31, 2 ** 40, -5, -100, -30000,
                 -2 ** 31, -2 ** 40],
        "map": {str(i): i for i in range(20)},
    }
    data = flax.serialization.msgpack_serialize(tree)
    got = msgpack_restore(data)
    want = flax.serialization.msgpack_restore(data)
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if k.startswith("bf16"):
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        elif isinstance(w, (np.ndarray, np.generic)):
            assert type(g) is type(w) and g.dtype == w.dtype
            assert np.array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w, k
    assert got["chunked"].shape == (10, 10)
    # bfloat16 leaves enter a state dict as float32
    sd = jax_state_dict({"w": got["bf16"]}, {})
    assert sd["w"].dtype == torch.float32
    assert torch.equal(sd["w"], got["bf16"].float())


def test_category_weights_follow_the_jax_lookup(tmp_path):
    """pretrained_dir: <wnid>.pth first, then <category>.ckpt, else the
    seeded random weights."""
    plan = narrow_unet(3, 8, compute_dtype="float32")
    var = [randomize(variables_of(plan), np.random.RandomState(i))
           for i in range(3)]
    export_torch_style(str(tmp_path / "03211117.pth"), var[0])  # display
    save_checkpoint(str(tmp_path / "display.ckpt"), TrainState(
        var[1]["params"], var[1]["batch_stats"], {}, 0), 1)
    save_checkpoint(str(tmp_path / "table.ckpt"), TrainState(
        var[2]["params"], var[2]["batch_stats"], {}, 0), 1)
    cats = ["others", "display", "table"]
    got = category_state_dicts(plan, cats, str(tmp_path))
    rand = category_state_dicts(plan, cats)
    for k, v in got[0].items():
        assert torch.equal(v, rand[0][k])
    for sd, v in ((got[1], var[0]), (got[2], var[2])):
        assert torch.equal(sd["final.kernel"],
                           torch.from_numpy(v["params"]["final"]["kernel"]))
        assert torch.equal(sd["bn0.mean"],
                           torch.from_numpy(v["batch_stats"]["bn0"]["mean"]))


# ---------------------------------------------------------------------------
# errors

@pytest.mark.parametrize("missing", ["annotations", "ply", "checkpoint"])
def test_missing_file_is_named(tmp_path, scene, narrow, missing):
    overrides = write_scannet_tree(str(tmp_path), [scene])
    argv = overrides + ARGS
    if missing == "annotations":
        path = str(tmp_path / "full_annotations.json")
    elif missing == "ply":
        path = str(tmp_path / "scans" / "scene0000_00"
                   / "scene0000_00_vh_clean_2.ply")
    else:
        path = str(tmp_path / "none.ckpt")
        argv.append(f"checkpoint={path}")
    if os.path.exists(path):
        os.remove(path)
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        eval_joint.main(argv)


def test_bad_ckpt_is_named(tmp_path):
    path = str(tmp_path / "bad.ckpt")
    with open(path, "wb") as f:
        f.write(b"\x92\x01")  # a two-item array cut after its first item
    with pytest.raises(ValueError, match=re.escape(path)):
        read_checkpoint(path)


def test_scenenn_without_h5py_raises(tmp_path, narrow, monkeypatch):
    with open(tmp_path / "full_annotations.json", "w") as f:
        json.dump([{"id_scan": "011", "aligned_models": [], "trs": {
            "translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
            "scale": [1, 1, 1]}}], f)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        eval_joint.main(["--scenenn", f"data.scene_nn_root={tmp_path}"] + ARGS)
