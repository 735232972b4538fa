"""The port's training loops and CLIs (train/joint_loop.py,
train/separate_loop.py, train_joint.py, train_separate.py) on the CPU with a
narrow MinkUNetBase (one block a stage): an epoch of each loop with
validation (detection and mAP at both thresholds), checkpoints and the
auto-resume, a JAX checkpoint resumed by the port's loop, the loop's first
step equal to the step function's on the same batch, the CLIs over
synthetic scenes and over a ScanNet-format tree (the datasets' training
branch, augmentation on), the dense training route and block remat through
both loops, and mesh training raising without a process group."""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.train import checkpoint as jckpt
from canonicalvoting_tpu.train import steps as jsteps

import canonicalvoting_tpu_torch.train.joint_loop as joint_loop
import canonicalvoting_tpu_torch.train.separate_loop as separate_loop
from canonicalvoting_tpu_torch import train_joint, train_separate
from canonicalvoting_tpu_torch.config import load_config
from canonicalvoting_tpu_torch.data.collate import collate_joint
from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME
from canonicalvoting_tpu_torch.data.loader import ListDataset
from canonicalvoting_tpu_torch.data.synthetic import make_scene
from canonicalvoting_tpu_torch.data.synthetic_tree import (
    wnid_of, write_scannet_tree)
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.models.minkunet import MinkUNetBase
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.train import steps as tsteps
from canonicalvoting_tpu_torch.utils.weights import to_jax_variables

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import (
    JOINT_OUT, TINY, joint_items, separate_items)

BASE = ["batch_size=2", "num_workers=0"]


def _narrow(in_channels, out_channels, compute_dtype="bfloat16", generator=None):
    return MinkUNetBase(in_channels, out_channels, compute_dtype=compute_dtype,
                        generator=generator, **TINY)


def _gts(n, prefix):
    return {f"{prefix}{i}": [] for i in range(n)}


def _finite_map(ret):
    assert set(ret) == {0.25, 0.5}
    for d in ret.values():
        assert math.isfinite(d["mAP"]) and math.isfinite(d["AR"])


@pytest.fixture(scope="module")
def joint_data():
    """Two small scenes as joint items, and their ground truth."""
    rng = np.random.RandomState(0)
    items, gts = [], {}
    for i in range(2):
        s = make_scene(rng, extent=(0.5, 0.5, 0.5), n_background=300,
                       n_boxes=1, pts_per_box=150)
        coords, idx = sparse_quantize(s.points, 0.03)
        items.append((f"scene{i}", coords, s.rgb[idx], s.xyz_labels[idx],
                      s.scale_labels[idx], s.class_labels[idx]))
        gts[f"scene{i}"] = [(NAME2CATNAME[IDX2NAME[ci]], c)
                            for ci, c in s.gt_corners()]
    return items, gts


# each epoch's row and each validation's table (utils/metrics_log.py)
METRICS_FILES = [f"{name}.{ext}" for name in ("train", "val_iou0.25",
                                              "val_iou0.5")
                 for ext in ("csv", "jsonl")]


def test_joint_loop_validates_checkpoints_and_resumes(tmp_path, joint_data):
    items, gts = joint_data
    cfg = load_config(None, BASE + ["max_epoch=1"])
    workdir = str(tmp_path)
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(items), ListDataset(items[:1]), workdir=workdir,
        gt_lookup=gts.get, eval_every=1, cap_multiple=256,
        model=_narrow(3, JOINT_OUT), device="cpu")
    assert state.step == 2  # epochs 0 and 1, one batch each
    assert sorted(os.listdir(workdir)) == ["epoch0.ckpt", "epoch1.ckpt",
                                           *METRICS_FILES]
    _finite_map(ret)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    # a second call resumes after epoch 1 and trains epoch 2 only
    cfg = load_config(None, BASE + ["max_epoch=2"])
    state2, ret2 = joint_loop.run_joint_training(
        cfg, ListDataset(items), ListDataset(items[:1]), workdir=workdir,
        gt_lookup=gts.get, eval_every=2, cap_multiple=256,
        model=_narrow(3, JOINT_OUT), device="cpu")
    assert state2.step == 3 and "epoch2.ckpt" in os.listdir(workdir)
    _finite_map(ret2)
    moved = [k for k, v in state2.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved  # trained on from the restored weights


def test_joint_loop_first_step_equals_the_step_function(tmp_path, joint_data):
    """One epoch (epoch 0, which validates); the same weights and batch
    through the step function give the same parameters, bit for bit."""
    items, _ = joint_data
    cfg = load_config(None, BASE + ["max_epoch=0"])
    seed_model = _narrow(3, JOINT_OUT, "float32",
                         torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in seed_model.state_dict().items()}
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(items), ListDataset(items[:1]), workdir=str(tmp_path),
        gt_lookup=lambda _: [], eval_every=5, cap_multiple=256,
        model=seed_model, device="cpu")
    assert state.step == 1
    _finite_map(ret)
    # the loader's first shuffle with seed 0
    order = np.arange(len(items))
    np.random.RandomState(0).shuffle(order)
    model = _narrow(3, JOINT_OUT, "float32")
    model.load_state_dict(init)
    ref = tsteps.create_train_state(model, 0.0, device="cpu")
    step = tsteps.make_joint_train_step(ref.model, cfg)
    # the loop collates flat level ids for the default dense site (the stem)
    step(ref, collate_joint([items[i] for i in order], cap_multiple=256,
                            with_flat_levels=True), 1e-3, 0.5)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


def test_joint_loop_resumes_a_jax_checkpoint(tmp_path, joint_data):
    items, gts = joint_data
    model = _narrow(3, JOINT_OUT, "float32", torch.Generator().manual_seed(4))
    variables = to_jax_variables(model)
    opt = jsteps.make_optimizer(0.0)
    jstate = jsteps.TrainState(params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=opt.init(variables["params"]),
                               step=jnp.asarray(7, jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "epoch3.ckpt"), jstate, 3)
    cfg = load_config(None, BASE + ["max_epoch=3"])
    fresh = _narrow(3, JOINT_OUT, "float32", torch.Generator().manual_seed(9))
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(items), ListDataset(items[:1]), workdir=str(tmp_path),
        gt_lookup=gts.get, eval_every=1, cap_multiple=256, model=fresh,
        device="cpu")
    # nothing left to train: the state is JAX's
    assert ret is None and state.step == 7
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    cfg = load_config(None, BASE + ["max_epoch=4"])
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(items), ListDataset(items[:1]), workdir=str(tmp_path),
        gt_lookup=gts.get, eval_every=1, cap_multiple=256, model=fresh,
        device="cpu")
    assert state.step == 8 and "epoch4.ckpt" in os.listdir(tmp_path)
    _finite_map(ret)


def test_separate_loop_validates_one_category(tmp_path):
    items = separate_items(np.random.RandomState(0), n=2)
    cfg = load_config(None, BASE + ["category=03001627"])
    state, ret = separate_loop.run_separate_training(
        cfg, ListDataset(items), ListDataset(items[:1]),
        workdir=str(tmp_path), gt_lookup=_gts(2, "s").get, eval_every=1,
        max_epoch=0, cap_multiple=256, model=_narrow(3, 8), device="cpu")
    assert state.step == 1 and sorted(os.listdir(tmp_path)) == [
        "epoch0.ckpt", *METRICS_FILES]
    _finite_map(ret)


@pytest.mark.parametrize("route,override", [("mesh", "tpu.mesh_data=2")])
def test_mesh_training_needs_a_process_group(tmp_path, route, override):
    """Mesh training runs one process a device: without an initialized
    process group both loops raise, naming torchrun and run_ranks
    (tests/test_torch_mesh_train.py trains the mesh on four ranks)."""
    cfg = load_config(None, BASE + [override])
    for run in (joint_loop.run_joint_training,
                separate_loop.run_separate_training):
        with pytest.raises(RuntimeError, match="torchrun.*run_ranks"):
            run(cfg, ListDataset([]), ListDataset([]), workdir=str(tmp_path),
                model=_narrow(3, 8), device="cpu")


@pytest.mark.parametrize("route,overrides", [
    ("dense", ["tpu.train_backbone=dense", "tpu.conv_dtype=float32"]),
    ("remat", ["tpu.train_remat=true"])])
def test_dense_and_remat_routes_train_both_loops(tmp_path, joint_data, route,
                                                 overrides):
    """The dense training route (as the JAX package's wiring test runs it,
    tests/test_train.py:331: float32) and block remat through both loops:
    an epoch, a checkpoint, a validation with a finite mAP, and a second
    call that resumes and trains the next epoch."""
    items, gts = joint_data
    sep_items = separate_items(np.random.RandomState(0), n=2)
    runs = (
        (joint_loop.run_joint_training, items, gts.get, JOINT_OUT, []),
        (separate_loop.run_separate_training, sep_items, _gts(2, "s").get, 8,
         ["category=03001627"]))
    for run, data, gt_lookup, out_ch, extra in runs:
        workdir = str(tmp_path / str(out_ch))
        models = []
        for max_epoch in (0, 1):
            cfg = load_config(None, BASE + overrides + extra
                              + [f"max_epoch={max_epoch}"])
            model = _narrow(3, out_ch, cfg.tpu.conv_dtype,
                            torch.Generator().manual_seed(5))
            state, ret = run(cfg, ListDataset(data), ListDataset(data[:1]),
                             workdir=workdir, gt_lookup=gt_lookup,
                             eval_every=1, cap_multiple=256, model=model,
                             device="cpu")
            assert state.step == max_epoch + 1
            assert f"epoch{max_epoch}.ckpt" in os.listdir(workdir)
            _finite_map(ret)
            models.append(state.model)
        # the route's model: the dense twin, or the gather model with remat
        want = DenseMinkUNet if route == "dense" else MinkUNetBase
        assert all(type(m) is want for m in models)
        assert route == "dense" or models[1].remat
        moved = [k for k, v in models[1].state_dict().items()
                 if not torch.equal(v, models[0].state_dict()[k])]
        assert moved  # the resumed call trained on


def test_dense_sites_key_is_parsed_and_the_gather_form_runs():
    cfg = load_config(None, ["tpu.train_dense_levels=stem,0,down1,up2"])
    assert tsteps.parse_dense_sites(cfg.tpu.train_dense_levels) == frozenset(
        {"stem", ("conv", 0), ("down", 1), ("up", 2)})
    assert tsteps.parse_dense_sites("all") == jsteps.parse_dense_sites("all")
    tsteps.make_joint_train_step(_narrow(3, JOINT_OUT), cfg)
    with pytest.raises(ValueError):
        tsteps.make_joint_train_step(_narrow(3, JOINT_OUT), load_config(
            None, ["tpu.train_dense_levels=stemx"]))


@pytest.fixture
def narrow_clis(monkeypatch):
    monkeypatch.setattr(joint_loop, "MinkUNet34C", _narrow)
    monkeypatch.setattr(separate_loop, "MinkUNet34C", _narrow)


def test_cli_synthetic_runs(tmp_path, narrow_clis, monkeypatch):
    """Both CLIs' --synthetic runs with --cpu, on small scenes; the
    separate CLI's ``category=a,b -m`` sweep trains one model a category."""
    def small_joint(cfg, n_train=8, n_val=2, seed=0):
        items = joint_items(np.random.RandomState(seed), n=n_train // 4 + 1)
        return (ListDataset(items[:2]), ListDataset(items[2:]),
                lambda _id: [])

    def small_sym(cfg, n_scenes=6, seed=0):
        return ListDataset(separate_items(np.random.RandomState(seed), n=2)), \
            lambda _id: []

    monkeypatch.setattr(train_joint, "build_synthetic", small_joint)
    monkeypatch.setattr(train_separate, "build_synthetic_sym", small_sym)
    state, ret = train_joint.main(["--synthetic", "--cpu", "max_epoch=0",
                                   f"workdir={tmp_path}/j"] + BASE)
    assert state.step == 1 and state.model.conv0p1s1.kernel.device.type == "cpu"
    _finite_map(ret)
    # the epoch's row and the validation's tables (utils/metrics_log.py)
    with open(f"{tmp_path}/j/train.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert row["step"] == 0 and row["loss"] == state.history[0]["loss"]
    for t in (0.25, 0.5):
        with open(f"{tmp_path}/j/val_iou{t}.jsonl") as f:
            (row,) = [json.loads(line) for line in f]
        assert row[f"iou{t}/mAP"] == float(ret[t]["mAP"])
    out = train_separate.main(["--synthetic", "--cpu", "max_epoch=0", "-m",
                               "category=03001627,04379243",
                               f"workdir={tmp_path}/s"] + BASE)
    assert list(out) == ["03001627", "04379243"]
    for cat, (st, r) in out.items():
        assert st.step == 1 and os.path.exists(f"{tmp_path}/s/{cat}/epoch0.ckpt")
        _finite_map(r)


def test_cli_trains_on_a_scannet_tree(tmp_path, narrow_clis):
    """The datasets' training branch (augmentation on) feeds both CLIs;
    validation reads the tree's results_gt."""
    rng = np.random.RandomState(7)
    scenes = [make_scene(rng, extent=(1.0, 0.8, 1.0), n_background=600,
                         n_boxes=2, pts_per_box=200) for _ in range(2)]
    overrides = write_scannet_tree(str(tmp_path / "tree"), scenes)
    state, ret = train_joint.main(overrides + BASE + [
        "--cpu", "max_epoch=0", f"workdir={tmp_path}/j"])
    assert state.step == 1
    _finite_map(ret)
    # one scan a batch: the category's scans are those holding its boxes
    cat = wnid_of(scenes[0].boxes[0].class_idx)
    out = train_separate.main(overrides + [
        "num_workers=0", "batch_size=1", "--cpu", "max_epoch=0",
        f"category={cat}", f"workdir={tmp_path}/s"])
    (st, r), = out.values()
    assert st.step >= 1
    _finite_map(r)


def test_cuda_default_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsteps.create_train_state(_narrow(3, 8))
