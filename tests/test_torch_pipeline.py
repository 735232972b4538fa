"""The whole slice: the port's DetectionPipeline on the CPU against the JAX
package's DetectionPipeline and the float64 oracle of the upstream tail, on
the planted scene of tests/test_parity_e2e.py; and the port's import
boundary (no JAX, nothing of canonicalvoting_tpu)."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.decode.peeling import PeelConfig as JaxPeelConfig
from canonicalvoting_tpu.eval.pipeline import DetectionPipeline as JaxPipeline
from canonicalvoting_tpu.metrics.ap import compute_map as jax_compute_map
from canonicalvoting_tpu.models.dense_unet import DenseMinkUNet as JaxDenseMinkUNet

from canonicalvoting_tpu_torch.data.geometry import IDX2NAME, NAME2CATNAME, NCLASSES
from canonicalvoting_tpu_torch.data.synthetic import (
    encode_joint_head_rows, make_scene, perfect_predictions)
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
from canonicalvoting_tpu_torch.metrics.ap import compute_map
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables

from tests.reference_impls import reference_eval_joint_tail
from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

RES, ROTS = 0.05, 24
TINY_PLANES = (8, 16, 32, 32, 32, 32, 16, 16)
OUT = 6 * NCLASSES + NCLASSES + 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planted():
    scene = make_scene(np.random.RandomState(0), extent=(4.0, 2.0, 4.0),
                       n_background=9000, n_boxes=3, pts_per_box=2000)
    model = DenseMinkUNet(3, OUT, layers=(1,) * 8, planes=TINY_PLANES,
                          init_dim=8, compute_dtype="float32")
    pipe = DetectionPipeline(model=model, res=RES, num_rots=ROTS,
                             peel=PeelConfig(res=RES, max_boxes=16, max_iters=48),
                             grid_multiple=16, cap_multiple=1024, device="cpu")
    jpipe = JaxPipeline(model=None, variables=None, res=RES, num_rots=ROTS,
                        peel=JaxPeelConfig(res=RES, max_boxes=16, max_iters=48),
                        grid_multiple=16, cap_multiple=1024, backbone="dense",
                        conv_impl="xla")
    args = pipe.prepare_scene(scene.points, scene.rgb)
    return scene, pipe, jpipe, args


def _map(dets, scene, fn):
    gt = [(NAME2CATNAME[IDX2NAME[ci]], c8) for ci, c8 in scene.gt_corners()]
    return fn({"s": dets}, {"s": gt}, ovthresh=0.5, processes=1)


def test_planted_scene_matches_jax_and_oracle(planted):
    scene, pipe, jpipe, args = planted
    coords_w = args.coords_w.numpy()
    valid = args.valid.numpy()
    points_w = coords_w[valid > 0]
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    rows = encode_joint_head_rows(points_w, xyz, scl, prob > 0.5, cls,
                                  len(valid))

    out = pipe.tail(torch.from_numpy(rows), args.coords_w, args.valid,
                    args.grid_shape)
    got = pipe.postprocess(out)
    jout = jpipe._tail_fn(rows, coords_w, valid, args.grid_shape)
    want = jpipe.postprocess(jout)
    map_ref, boxes_ref, scores_ref, classes_ref = reference_eval_joint_tail(
        rows[:len(points_w)], points_w, RES, ROTS, pipe.peel)

    n = int(out["n_boxes"])
    assert n == int(jout["n_boxes"]) == len(boxes_ref) == 3
    assert not bool(out["truncated"])
    for ref_boxes, ref_scores, ref_classes in (
            (np.asarray(jout["boxes"])[:n], np.asarray(jout["scores"])[:n],
             np.asarray(jout["classes"])[:n]),
            (boxes_ref, scores_ref, classes_ref)):
        np.testing.assert_array_equal(out["classes"][:n].numpy(), ref_classes)
        # f32 against f32 (JAX) or f64 (oracle): a borderline |inv| = 1
        # cell can flip during elimination and move a later argmax a cell
        np.testing.assert_allclose(out["boxes"][:n].numpy(), ref_boxes,
                                   atol=8e-3)
        np.testing.assert_allclose(out["scores"][:n].numpy(), ref_scores,
                                   atol=1e-5)
    for ref in (want, map_ref):
        assert sorted(c for c, _, _ in got) == sorted(c for c, _, _ in ref)
    d = _map(got, scene, compute_map)
    for ref in (_map(want, scene, jax_compute_map),
                _map(map_ref, scene, jax_compute_map)):
        assert d["mAP"] == pytest.approx(ref["mAP"], abs=1e-9)
        assert d["AR"] == pytest.approx(ref["AR"], abs=1e-9)
    assert d["mAP"] > 0.99


def test_backbone_branch_matches_jax(planted):
    """Random weights through both backbones (TINY widths: the tail does
    not depend on the width) and both tails, on a 2 x 1.2 x 2 m scene: the
    JAX dense XLA backbone on the CPU sets this test's time, and the tails
    need only agree on n_boxes and truncated."""
    _, pipe, jpipe, _ = planted
    scene = make_scene(np.random.RandomState(0), extent=(2.0, 1.2, 2.0),
                       n_background=4000, n_boxes=2, pts_per_box=1500)
    args = pipe.prepare_scene(scene.points, scene.rgb)
    feats, flat, valid = (args.feats.numpy(), args.flat.numpy(),
                          args.valid.numpy())
    jmodel = JaxDenseMinkUNet(in_channels=3, out_channels=OUT, block="basic",
                              layers=(1,) * 8, planes=TINY_PLANES, init_dim=8,
                              compute_dtype="float32", conv_impl="xla")
    variables = randomize(variables_of(pipe.model), np.random.RandomState(1))
    rows_j = np.asarray(jax.jit(lambda var, f, fl, v: jmodel.apply(
        var, f, fl, v, args.dense_dims, False))(variables, feats, flat, valid))
    from_jax_variables(pipe.model, variables["params"],
                       variables["batch_stats"])
    rows = pipe.run_backbone(args)
    np.testing.assert_allclose(rows.numpy(), rows_j, atol=2e-3, rtol=1e-3)
    out = pipe.tail(rows, args.coords_w, args.valid, args.grid_shape)
    jout = jpipe._tail_fn(rows_j, args.coords_w.numpy(), valid,
                          args.grid_shape)
    assert int(out["n_boxes"]) == int(jout["n_boxes"])
    assert bool(out["truncated"]) == bool(jout["truncated"])


def test_variants_give_the_default_boxes(planted, monkeypatch):
    """up_impl="into" and hv_method="pallas_windowed" against the default
    routes on the planted scene, over a vote grid whose x extent is a
    multiple of the windowed splat's 32-cell buckets: the variant backbone
    runs its two into-convs (its rows are held to the concat route's by
    tests/test_torch_dense_unet.py) and the tails find the same boxes."""
    import canonicalvoting_tpu_torch.models.dense_unet as du
    import canonicalvoting_tpu_torch.ops.hough_voting as thv

    scene, pipe, _, _ = planted
    calls, real_up, real_splat = [], du.tiled_up2_into, thv.hv_splat_windowed
    monkeypatch.setattr(du, "tiled_up2_into", lambda *a, **k: calls.append(
        "into") or real_up(*a, **k))
    monkeypatch.setattr(thv, "hv_splat_windowed", lambda *a, **k: calls.append(
        "windowed") or real_splat(*a, **k))
    kw = dict(res=RES, num_rots=ROTS, peel=pipe.peel, grid_multiple=(32, 16, 16),
              cap_multiple=1024, device="cpu")
    default = DetectionPipeline(model=pipe.model, **kw)
    into = DenseMinkUNet(**{**pipe.model.config(), "up_impl": "into"})
    into.load_state_dict(pipe.model.state_dict())
    variant = DetectionPipeline(model=into, hv_method="pallas_windowed", **kw)
    # the backbone on a 1.5 m corner of the scene: it only has to run
    corner = np.all(scene.points[:, [0, 2]] < scene.points[:, [0, 2]].min(0) + 1.5, 1)
    small = default.prepare_scene(scene.points[corner], scene.rgb[corner])
    assert bool(torch.isfinite(variant.run_backbone(small)).all())
    args = default.prepare_scene(scene.points, scene.rgb)
    assert args.grid_shape[0] % 32 == 0
    valid = args.valid.numpy() > 0
    points_w = args.coords_w.numpy()[valid]
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    rows = torch.from_numpy(encode_joint_head_rows(
        points_w, xyz, scl, prob > 0.5, cls, len(valid)))
    want = default.tail(rows, args.coords_w, args.valid, args.grid_shape)
    got = variant.tail(rows, args.coords_w, args.valid, args.grid_shape)
    assert calls == ["into", "into", "windowed"]
    n = int(want["n_boxes"])
    assert n == int(got["n_boxes"]) == 3
    torch.testing.assert_close(got["classes"][:n], want["classes"][:n])
    torch.testing.assert_close(got["boxes"][:n], want["boxes"][:n], rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="hv_method"):
        DetectionPipeline(model=pipe.model, hv_method="xla", device="cpu")


def test_default_device_is_the_gpu():
    model = DenseMinkUNet(3, OUT, layers=(1,) * 8, planes=TINY_PLANES,
                          init_dim=8)
    if torch.cuda.is_available():
        assert DetectionPipeline(model=model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="GPU"):
            DetectionPipeline(model=model)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither jax,
    flax, optax, msgpack nor anything of canonicalvoting_tpu, and h5py and
    yaml only inside the functions that read such files."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import canonicalvoting_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax',\n"
        "              'canonicalvoting_tpu', 'msgpack', 'h5py', 'yaml'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # imports inside functions too (chip_smoke.py imports in its phases)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in
        os.walk(os.path.join(REPO, "canonicalvoting_tpu_torch"))
        for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "optax", "msgpack",
                    "canonicalvoting_tpu"), (path, m)
