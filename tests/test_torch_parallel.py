"""The port's multi-device modules on the CPU (``parallel/``, the CLIs'
fan-out, ``utils/profiling.py``, ``utils/metrics_log.py``) against the JAX
package's, which runs on the eight virtual CPU devices of conftest.py.

One pair of gloo ranks is spawned for the module (``parallel/launch.py``:
the ranks import only the port) and runs every rank-side case once; the
same cases run again in this process on a gloo group of one rank. Two
ranks must equal one rank bit for bit, and the one-rank point-sharded
voting the port's single-device ``hough_voting``. Against JAX: the voting
grids within 1e-4 (objectness) and 1e-3 (rotation, scale), as
tests/test_parallel.py holds JAX's sharded voting to its own; the fan-outs'
detections with the same scene ids and class names in the same order, and
boxes and scores within tests/test_torch_sparse_pipeline.py's tolerances.
The JAX fan-outs run on a two-device mesh (two scenes a dispatch, the last
one padded by repetition), the port's over the two ranks. Toy models and
24 rotations keep the JAX compiles short; the peel's vote thresholds are
lowered so that the random backbones' heads give boxes. Random heads leave
a box's yaw and score ill-conditioned (see _same_boxes), so the joint and
separate fan-outs also run on planted head rows (perfect predictions, in
place of both packages' backbones), where boxes and scores are compared
whole; the port's planted runs are one rank in this process.
"""

import functools
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from canonicalvoting_tpu.decode.peeling import PeelConfig as JaxPeelConfig
from canonicalvoting_tpu.eval.separate import stack_variables
from canonicalvoting_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from canonicalvoting_tpu.ops.hough_voting import hough_voting as jax_hough_voting
from canonicalvoting_tpu.parallel import scene_parallel as jsp
from canonicalvoting_tpu.parallel.hv_sharded import (
    hough_voting_sharded as jax_hv_sharded)
from canonicalvoting_tpu.parallel.mesh import factor_mesh as jax_factor_mesh
from canonicalvoting_tpu.parallel.mesh import make_mesh as jax_make_mesh
from canonicalvoting_tpu.utils.metrics_log import MetricsLogger as JaxLogger
from canonicalvoting_tpu.utils.profiling import PhaseTimer as JaxTimer

from canonicalvoting_tpu_torch import eval_joint
from canonicalvoting_tpu_torch.data.geometry import NCLASSES
from canonicalvoting_tpu_torch.data.synthetic import (
    encode_joint_head_rows, encode_separate_head_rows, make_scene,
    perfect_predictions)
from canonicalvoting_tpu_torch.data.synthetic_tree import write_scannet_tree
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
from canonicalvoting_tpu_torch.eval.separate import (
    SeparateDetectionPipeline, stack_state_dicts)
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet
from canonicalvoting_tpu_torch.ops.hough_voting import hough_voting
from canonicalvoting_tpu_torch.ops.voxelize import sparse_quantize
from canonicalvoting_tpu_torch.parallel import scene_parallel as sp
from canonicalvoting_tpu_torch.parallel.hv_sharded import hough_voting_sharded
from canonicalvoting_tpu_torch.parallel.launch import run_ranks
from canonicalvoting_tpu_torch.parallel.mesh import Mesh, factor_mesh, make_mesh
from canonicalvoting_tpu_torch.utils.metrics_log import MetricsLogger
from canonicalvoting_tpu_torch.utils.profiling import PhaseTimer, device_trace
from canonicalvoting_tpu_torch.utils.weights import from_jax_variables, jax_state_dict

from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)

RES, ROTS = 0.03, 24
TINY = dict(layers=(1,) * 8, planes=(8, 16, 16, 16, 16, 16, 8, 8), init_dim=8,
            compute_dtype="float32")
OUT = 6 * NCLASSES + NCLASSES + 1
CATS = ["chair", "table"]
# low vote thresholds: random heads spread their votes thin
PEEL = dict(res=RES, max_boxes=16, max_iters=64, thresh_high=0.2, thresh_low=1,
            prob_thresh=0.05, err_thresh=2.0, valid_ratio=0.05)
SEP_PEEL = dict(PEEL, thresh_high=2.0)
FAN = dict(res=RES, num_rots=ROTS, cap_multiple=512, grid_multiple=(16, 16, 16))
HV = dict(res=0.05, num_rots=12, grid_shape=(24, 24, 24))
VP = dict(res=RES, num_rots=12, grid_shape=(32, 32, 32))
VP_PEEL = dict(res=RES, max_boxes=8, max_iters=16, thresh_high=8.0,
               thresh_low=5)
# the planted fan-outs: two boxes a scene (classes 0 and 1, so both
# separate categories find one), perfect heads
PLANT_PEEL = dict(res=RES, max_boxes=8, max_iters=16, thresh_high=8.0,
                  thresh_low=5)
CLI_RES = 0.08
# the rank-side cases, in the order of Case.calls
CASES = ("modules", "voting", "sparse", "dense", "separate", "votepeel", "cli")


def _scene(rng, extent, n_background, pts_per_box, n_boxes=1):
    sc = make_scene(rng, extent=extent, n_background=n_background,
                    n_boxes=n_boxes, pts_per_box=pts_per_box)
    coords, idx = sparse_quantize(sc.points, RES)
    return sc, coords, sc.rgb[idx]


class Case:
    """The module's inputs (numpy, from seeds) and both packages' models."""

    def __init__(self, root):
        rng = np.random.RandomState(0)
        n = 64
        self.hv = (rng.uniform(0, 1, (n, 3)).astype(np.float32),
                   rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                   rng.uniform(0.1, 0.4, (n, 3)).astype(np.float32),
                   rng.uniform(0, 1, (n,)).astype(np.float32))
        self.hv_corners = np.stack([self.hv[0].min(0), self.hv[0].max(0)])
        # three joint scenes of 400 + 150 points, two separate ones
        self.scenes = [(f"s{i}", *_scene(rng, (0.85, 0.8, 0.85), 400, 150)[1:])
                       for i in range(3)]
        self.sep_scenes = [(f"s{i}", *_scene(rng, (0.6, 0.55, 0.6), 300, 120)[1:])
                           for i in range(2)]
        self.model = DenseMinkUNet(3, OUT, **TINY)
        self.variables = randomize(variables_of(self.model),
                                   np.random.RandomState(1))
        from_jax_variables(self.model, self.variables["params"],
                           self.variables["batch_stats"])
        plan = DenseMinkUNet(3, 8, **TINY)
        self.sep_plan = plan
        self.sep_variables = [randomize(variables_of(plan),
                                        np.random.RandomState(2 + c))
                              for c in range(len(CATS))]
        self.votepeel = self._planted()
        self.plant_scenes = [_scene(np.random.RandomState(200 + i),
                                    (2.4, 1.2, 2.4), 200, 400 + 20 * i,
                                    n_boxes=2) for i in range(3)]
        self.cli_argv = write_scannet_tree(
            os.path.join(root, "tree"), [_scene(np.random.RandomState(7 + i),
                                                (0.8, 0.6, 0.8), 600, 250)[0]
                                         for i in range(2)]) + [
            "--cpu", f"scannet_res={CLI_RES}"]

    def _planted(self):
        """Two scenes of perfect heads (__graft_entry__.dryrun_multichip's
        recipe), padded to 1,024 rows."""
        cap, out = 1024, {k: [] for k in sp.VOTEPEEL_KEYS}
        for d in range(2):
            sc, coords, _ = _scene(np.random.RandomState(100 + d),
                                   (0.9, 0.8, 0.9), 300, 600)
            n = len(coords)
            coords_w = np.zeros((cap, 3), np.float32)
            coords_w[:n] = coords.astype(np.float32) * RES
            xyz, scl, prob, cls = perfect_predictions(sc, coords_w[:n])

            def pad(a):
                return np.concatenate([a, np.zeros((cap - n,) + a.shape[1:],
                                                   a.dtype)])

            valid = np.zeros((cap,), np.float32)
            valid[:n] = 1.0
            for k, v in zip(sp.VOTEPEEL_KEYS, (
                    coords_w, pad(xyz), pad(np.maximum(scl, 1e-3)), pad(prob),
                    pad(cls), valid)):
                out[k].append(v)
        return {k: np.stack(v) for k, v in out.items()}

    def sep_stacked(self):
        return stack_state_dicts([jax_state_dict(v["params"], v["batch_stats"])
                                  for v in self.sep_variables])

    def planted_tables(self, cap):
        """{voxel count: rows} of the planted scenes at the row capacity
        ``cap``: the joint (cap, 64) rows and the separate (C, cap, 8)
        ones (category c takes the class-c box)."""
        joint, sep = {}, {}
        for sc, coords, _ in self.plant_scenes:
            points_w = coords.astype(np.float32) * RES
            xyz, scl, prob, cls = perfect_predictions(sc, points_w)
            joint[len(coords)] = encode_joint_head_rows(
                points_w, xyz, scl, prob > 0.5, cls, cap)
            sep[len(coords)] = np.stack([encode_separate_head_rows(
                points_w, xyz, scl, (prob > 0.5) & (cls == c), cap)
                for c in range(len(CATS))])
        assert len(joint) == len(self.plant_scenes), "voxel counts must differ"
        return joint, sep

    def plant_items(self):
        return [(f"p{i}", coords, feats)
                for i, (_, coords, feats) in enumerate(self.plant_scenes)]

    def calls(self):
        """The rank-side cases (each one pickles: the port's functions)."""
        return [
            functools.partial(eval, "sorted(__import__('sys').modules)"),
            functools.partial(hough_voting_sharded, *self.hv,
                              self.hv_corners, device="cpu", **HV),
            functools.partial(sp.evaluate_scenes_sharded, self.model, None,
                              self.scenes, device="cpu",
                              peel=PeelConfig(**PEEL), **FAN),
            functools.partial(sp.evaluate_scenes_sharded, self.model, None,
                              self.scenes, device="cpu",
                              peel=PeelConfig(**PEEL), backbone="dense",
                              **FAN),
            functools.partial(sp.evaluate_scenes_sharded_separate,
                              self.sep_plan, self.sep_stacked(),
                              self.sep_scenes, CATS, device="cpu",
                              peel=PeelConfig(**SEP_PEEL,
                                              elimination_inclusive=False),
                              **FAN),
            functools.partial(sp.votepeel_sharded, self.votepeel,
                              device="cpu", peel=PeelConfig(**VP_PEEL), **VP),
            functools.partial(eval_joint.main, self.cli_argv),
        ]


def _one_rank(tmp, calls):
    """``calls`` in this process, on a gloo group of one rank."""
    store = os.path.join(tmp, "store1")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        return [call() for call in calls]
    finally:
        dist.destroy_process_group()


def _jax_jobs(names, c):
    """The JAX package's results ``names`` on the module's inputs."""
    out = {}
    for name in names:
        out.update(_jax_job(name, c))
    return out


class _JaxPlanted:
    """Stands in for the JAX package's dense twin (``dense_xla_twin``) in
    its fan-outs: the planted rows of the scene with as many valid rows,
    of the category that the variables name on the separate path."""

    def __init__(self, table):
        self.counts = jax.numpy.asarray(sorted(table), jax.numpy.float32)
        self.rows = jax.numpy.asarray(np.stack([table[n]
                                                for n in sorted(table)]))

    def apply(self, variables, feats, flat, valid, dims, train):
        s = jax.numpy.argmax(self.counts == valid.sum())
        if self.rows.ndim == 3:
            return self.rows[s]
        return self.rows[s, variables["category"]]


def _planted_jax(c, cap):
    """JAX's dense joint and separate fan-outs over the planted scenes."""
    joint, sep = c.planted_tables(cap)
    fan = dict(FAN, mesh=jax_make_mesh(data=2, model=1))
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jsp, "dense_xla_twin", lambda model: _JaxPlanted(joint))
        out = {"planted_joint": jsp.evaluate_scenes_sharded(
            None, c.variables, c.plant_items(), backbone="dense",
            peel=JaxPeelConfig(**PLANT_PEEL), **fan)}
        mp_.setattr(jsp, "dense_xla_twin", lambda model: _JaxPlanted(sep))
        out["planted_separate"] = jsp.evaluate_scenes_sharded_separate(
            None, {"category": np.arange(len(CATS))}, c.plant_items(), CATS,
            peel=JaxPeelConfig(**PLANT_PEEL, elimination_inclusive=False),
            **fan)
    return out


def _planted_port(c, tmp):
    """The port's joint and separate fan-outs over the planted scenes, one
    rank in this process, the pipelines' backbones replaced by the rows."""
    def planted_rows(table):
        def rows(self, args, shared=None):
            return torch.from_numpy(table[int(args.valid.sum())])
        return rows

    with pytest.MonkeyPatch.context() as mp_:
        def run():
            shapes = sp.shared_shapes(
                make_mesh(device="cpu"), [co for _, co, _ in c.plant_items()],
                cap_multiple=FAN["cap_multiple"],
                grid_multiple=FAN["grid_multiple"], dense=True)
            joint, sep = c.planted_tables(shapes["cap"])
            mp_.setattr(DetectionPipeline, "run_backbone", planted_rows(joint))
            mp_.setattr(SeparateDetectionPipeline, "backbones",
                        planted_rows(sep))
            return shapes["cap"], {
                "planted_joint": sp.evaluate_scenes_sharded(
                    c.model, None, c.plant_items(), device="cpu",
                    backbone="dense", peel=PeelConfig(**PLANT_PEEL), **FAN),
                "planted_separate": sp.evaluate_scenes_sharded_separate(
                    c.sep_plan, c.sep_stacked(), c.plant_items(), CATS,
                    device="cpu", peel=PeelConfig(
                        **PLANT_PEEL, elimination_inclusive=False), **FAN)}

        return _one_rank(tmp, [run])[0]


def _jax_job(name, c):
    """One JAX reference: the fan-outs on a two-device mesh, the voting on
    all eight."""
    jax.config.update("jax_platforms", "cpu")
    mesh2 = jax_make_mesh(data=2, model=1)
    fan = dict(FAN, mesh=mesh2)
    if name == "voting":
        mesh8 = jax_make_mesh(data=8, model=1)
        with mesh8:
            sharded = jax_hv_sharded(*c.hv, c.hv_corners, mesh=mesh8,
                                     axis="data", **HV)
        single = jax_hough_voting(*c.hv, corners=c.hv_corners, **HV)
        return {"voting": [np.asarray(g) for g in sharded],
                "voting_single": [np.asarray(g) for g in single]}
    if name == "separate":
        return {name: jsp.evaluate_scenes_sharded_separate(
            JaxMinkUNet(in_channels=3, out_channels=8, block="basic", **TINY),
            stack_variables(c.sep_variables), c.sep_scenes, CATS,
            peel=JaxPeelConfig(**SEP_PEEL, elimination_inclusive=False),
            **fan)}
    out = {name: jsp.evaluate_scenes_sharded(
        JaxMinkUNet(in_channels=3, out_channels=OUT, block="basic", **TINY),
        c.variables, c.scenes, backbone=name, peel=JaxPeelConfig(**PEEL),
        **fan)}
    if name == "sparse":
        out["votepeel"] = jax.device_get(jsp.make_sharded_votepeel_fn(
            mesh2, peel=JaxPeelConfig(**VP_PEEL), **VP)(c.votepeel))
    return out


def _trace(logdir):
    """device_trace's file of a small computation, and its no-op."""
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(logdir):
        torch.ones(4).sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Every result of the module, computed at once: the two ranks, a rank
    alone, a rank that raises and the single-process CLI in processes of
    their own, beside the JAX references in this one."""
    root = str(tmp_path_factory.mktemp("parallel"))
    c = Case(root)
    calls = [functools.partial(torch.set_num_threads, 1)] + c.calls()
    # a group of one rank: eval_joint.main runs its single-process path
    cli = [calls[0], calls[-1]]
    with ThreadPoolExecutor(6) as threads:
        runs = [threads.submit(run_ranks, cs, n, os.path.join(root, name))
                for cs, n, name in ((calls, 2, "two"), (calls[:-1], 1, "one"),
                                    (cli, 1, "cli"),
                                    ([functools.partial(int, "x")], 1,
                                     "failing"))]
        # JAX's dense fan-out, then its planted ones (they swap its dense
        # twin), in one thread; the voting and the sparse fan-out in another
        jax_runs = [threads.submit(_jax_jobs, ("voting", "sparse"), c)]
        cap, c.planted = _planted_port(c, root)
        jax_runs.append(threads.submit(
            lambda: {**_jax_job("dense", c), **_planted_jax(c, cap)}))
        c.jax = {}
        for r in jax_runs:
            c.jax.update(r.result())
        c.two = [dict(zip(CASES, r[1:])) for r in runs[0].result()]
        c.one = dict(zip(CASES, runs[1].result()[0][1:]))
        c.cli_single = runs[2].result()[0][1]
        c.failing = runs[3].exception()
    return c


@pytest.fixture(scope="module")
def jax_ref(case):
    return case.jax


@pytest.fixture(scope="module")
def jax_separate_ref(case):
    """JAX's separate fan-out: its XLA dense twin compiles for 8-11 s on
    the CPU, on top of the module's dense one."""
    return _jax_jobs(("separate",), case)


def _shape(box):
    """A box's center and its corner-to-corner distances, sorted: all of
    it but the yaw."""
    box = np.asarray(box, np.float64)
    return np.concatenate([box.mean(0),
                           np.sort(np.linalg.norm(box[1:] - box[0], axis=1))])


def _same_boxes(got, want):
    """Scene ids and names in the same order; box centers and extents
    within tests/test_torch_sparse_pipeline.py's box tolerance. At a peak
    the random heads' rotation votes can cancel to near zero (a normalized
    rotation vector of norm 5e-4 at one of these scenes' peaks), so a box's
    yaw may be the angle of a vector near zero, and its score (the largest
    probability of the points inside the rotated box) follows the yaw:
    neither is compared here; the planted heads' are
    (test_planted_votepeel_matches_jax)."""
    assert list(got) == list(want)
    for id_scan in want:
        assert [d[0] for d in got[id_scan]] == [d[0] for d in want[id_scan]]
        for (_, b, _), (_, wb, _) in zip(got[id_scan], want[id_scan]):
            np.testing.assert_allclose(_shape(b), _shape(wb), atol=8e-3)


def _bitwise(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _bitwise(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b) and a.dtype == b.dtype
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# mesh

def test_factor_mesh_matches_jax():
    for n in range(1, 10):
        assert factor_mesh(n) == jax_factor_mesh(n)


def test_make_mesh_raises_beyond_the_world(tmp_path):
    def build():
        mesh = make_mesh(device="cpu")
        assert (mesh.data, mesh.model, mesh.rank, mesh.device) == (
            1, 1, 0, torch.device("cpu"))
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            make_mesh(data=2, device="cpu")
        with pytest.raises(ValueError, match="need 4 devices, have 1"):
            make_mesh(data=2, model=2, device="cpu")
        # a gloo group computes on the card too unless the CPU is asked for
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make_mesh()

    _one_rank(str(tmp_path), [build])
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh()


def test_ranks_import_no_jax(case):
    for rank in case.two:
        bad = [m for m in rank["modules"] if m.split(".")[0] in
               ("jax", "jaxlib", "flax", "canonicalvoting_tpu")]
        assert not bad and "canonicalvoting_tpu_torch.parallel.scene_parallel" \
            in rank["modules"]


def test_a_rank_that_raises_fails_the_call(case):
    assert isinstance(case.failing, mp.ProcessRaisedException)
    assert "invalid literal" in str(case.failing)


# ---------------------------------------------------------------------------
# point-sharded voting

def test_point_sharded_voting_matches_jax(case, jax_ref):
    for rank in case.two:
        for got, want, single, tol in zip(rank["voting"], jax_ref["voting"],
                                          jax_ref["voting_single"],
                                          (1e-4, 1e-3, 1e-3)):
            np.testing.assert_allclose(got.numpy(), want, atol=tol)
            np.testing.assert_allclose(got.numpy(), single, atol=tol)


def test_point_sharded_voting_one_rank_is_single_device(case):
    want = hough_voting(*(torch.from_numpy(a) for a in case.hv),
                        corners=torch.from_numpy(case.hv_corners), **HV)
    _bitwise(list(case.one["voting"]), list(want))


def test_point_sharded_voting_checks_its_shards():
    mesh = Mesh(data=3, model=1, rank=0, device=torch.device("cpu"))
    pts = np.zeros((64, 3), np.float32)
    with pytest.raises(ValueError, match="do not divide over 3 ranks"):
        hough_voting_sharded(pts, pts, pts, pts[:, 0], np.zeros((2, 3)),
                             mesh=mesh, **HV)
    with pytest.raises(ValueError, match="explicit"):
        hough_voting_sharded(pts[:63], pts[:63], pts[:63], pts[:63, 0],
                             np.zeros((3,)), mesh=mesh, **HV)


# ---------------------------------------------------------------------------
# scene-parallel evaluation

def test_sparse_fan_out_matches_jax(case, jax_ref):
    for rank in case.two:
        _same_boxes(rank["sparse"], jax_ref["sparse"])
    assert sum(len(d) for d in jax_ref["sparse"].values()) >= 1


@pytest.mark.parametrize("name", [
    "dense", pytest.param("separate", marks=pytest.mark.slow)])
def test_dense_fan_out_matches_jax(case, request, name):
    want = (case.jax if name == "dense"
            else request.getfixturevalue("jax_separate_ref"))[name]
    for rank in case.two:
        _same_boxes(rank[name], want)
    assert sum(len(d) for d in want.values()) >= 1


@pytest.mark.parametrize("name", ["planted_joint", "planted_separate"])
def test_planted_fan_out_matches_jax(case, name):
    """The fan-outs' drivers and tails (escalation, host NMS, the merge)
    on planted heads against JAX's: the same scene ids, class names, boxes
    (with their yaw) within 8e-3 and scores within 1e-5, as
    tests/test_torch_sparse_pipeline.py holds the pipeline to JAX's."""
    got, want = case.planted[name], case.jax[name]
    assert list(got) == list(want)
    assert all(len(d) >= 1 for d in want.values())  # the accept branch
    for id_scan in want:
        assert [d[0] for d in got[id_scan]] == [d[0] for d in want[id_scan]]
        for (_, b, sc), (_, wb, wsc) in zip(got[id_scan], want[id_scan]):
            np.testing.assert_allclose(b, wb, atol=8e-3)
            np.testing.assert_allclose(sc, wsc, atol=1e-5)


def test_planted_votepeel_matches_jax(case, jax_ref):
    want = jax_ref["votepeel"]
    assert np.all(want["n_boxes"] >= 1)  # the accept branch runs
    for rank in case.two:
        got = rank["votepeel"]
        np.testing.assert_array_equal(got["n_boxes"], want["n_boxes"])
        for s, nb in enumerate(want["n_boxes"]):
            np.testing.assert_array_equal(got["classes"][s, :nb],
                                          want["classes"][s, :nb])
            np.testing.assert_allclose(got["boxes"][s, :nb],
                                       want["boxes"][s, :nb], atol=8e-3)
            np.testing.assert_allclose(got["scores"][s, :nb],
                                       want["scores"][s, :nb], atol=1e-5)


@pytest.mark.parametrize("name", CASES[1:-1])
def test_two_ranks_equal_one_rank(case, name):
    _bitwise(case.two[0][name], case.one[name])
    _bitwise(case.two[1][name], case.one[name])


def test_shared_shapes_and_collates_match_jax(case, tmp_path):
    """The run's shared capacity, vote grid and dense dims, and the
    collates' rows, as the JAX package's collates give them."""
    coords = [c for _, c, _ in case.scenes]
    feats = [f for _, _, f in case.scenes]
    shapes = _one_rank(str(tmp_path), [
        lambda: sp.shared_shapes(make_mesh(device="cpu"), coords,
                                 cap_multiple=512,
                                 grid_multiple=(16, 16, 16), dense=True)])[0]
    cap = shapes["cap"]
    from canonicalvoting_tpu.data.dense_prep import dense_grid_geometry
    from canonicalvoting_tpu.ops.hough_voting import round_grid_shape
    assert cap == 512 * int(np.ceil(max(map(len, coords)) / 512))
    assert shapes["grid_shape"] == round_grid_shape(np.max(
        [c.max(0) - c.min(0) + 1 for c in coords], 0), (16, 16, 16))
    assert shapes["dense_dims"] == tuple(
        max(dense_grid_geometry(c)[1][a] for c in coords) for a in range(3))
    pairs = list(zip(coords, feats))
    jd = jsp.collate_eval_scenes_dense(pairs, cap, shapes["dense_dims"], res=RES)
    dense = sp.collate_eval_scenes_dense(pairs, cap, shapes["dense_dims"],
                                         grid_shape=shapes["grid_shape"],
                                         res=RES, device="cpu")
    js = jsp.collate_eval_scenes(pairs, cap, res=RES)
    sparse = sp.collate_eval_scenes(pairs, cap, grid_shape=shapes["grid_shape"],
                                    res=RES, device="cpu")
    for s, (d, a) in enumerate(zip(dense, sparse)):
        assert d.grid_shape == a.grid_shape == shapes["grid_shape"]
        assert d.dense_dims == shapes["dense_dims"]
        for key, got in (("feats", d.feats), ("flat", d.flat),
                         ("valid", d.valid), ("coords_w", d.coords_w)):
            np.testing.assert_array_equal(got.numpy(), jd[key][s])
        np.testing.assert_array_equal(a.feats.numpy(), js["feats"][s])
        np.testing.assert_array_equal(a.coords_w.numpy(), js["coords_w"][s])
        for key in ("nbr_conv", "nbr_down", "nbr_up"):
            for x, y in zip(a.pyramid[key], js["pyramid"][key]):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y)[s])


def test_fan_out_reports_and_escalates(case, tmp_path):
    """A one-rank run's stats (its scenes, its phases in PhaseTimer's
    format, its launches: none on the CPU); a peel that exits on its budget
    escalates per scene to what the larger budget gives at once, and warns
    as JAX's fan-out warns where the budget stays too small."""
    def fan(max_iters, max_retries, stats=None):
        peel = PeelConfig(**dict(PEEL, max_iters=max_iters, max_boxes=16))
        return sp.evaluate_scenes_sharded(
            case.model, None, case.scenes, device="cpu", peel=peel,
            max_retries=max_retries, stats=stats, **FAN)

    stats = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        big, escalated = _one_rank(str(tmp_path), [
            lambda: fan(64, 0, stats), lambda: fan(4, 2)])
    _bitwise(escalated, big)
    with pytest.warns(RuntimeWarning, match="still budget-exited after 0"):
        _one_rank(str(tmp_path), [lambda: fan(1, 0)])
    (st,) = stats
    assert st["rank"] == 0 and st["scenes"] == ["s0", "s1", "s2"]
    assert set(st["timer"]) == {"read", "shapes", "prep", "scene", "nms"}
    assert st["timer"]["scene"]["count"] == 3
    assert set(st["launches"]) == set(sp.launch_counts())
    assert not any(st["launches"].values()) and st["peak_mem_bytes"] is None


def test_cli_fans_out_to_the_single_process_map(case):
    """eval_joint.main under the two ranks gives the single-process run's
    mAP; the second rank returns nothing."""
    want = case.cli_single
    got, other = case.two[0]["cli"], case.two[1]["cli"]
    assert other == {} and sorted(got) == sorted(want) == [0.25, 0.5]
    for t in want:
        assert set(got[t]) == set(want[t])
        for k in want[t]:
            np.testing.assert_array_equal(np.asarray(got[t][k]),
                                          np.asarray(want[t][k]))


# ---------------------------------------------------------------------------
# utilities

def test_phase_timer_matches_jax(monkeypatch, tmp_path):
    clock = iter(np.arange(0.0, 100.0, 0.0123457).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timers = (PhaseTimer(), JaxTimer())
    for name in ("b", "a", "b"):
        with timers[0].phase(name, sync_value=[torch.zeros(2)]):
            pass
        with timers[1].phase(name):
            pass
    got, want = (t.summary() for t in timers)
    assert got == want and list(got) == ["a", "b"]
    assert want["b"] == {"total_s": round(2 * 0.0123457, 4), "count": 2,
                         "mean_ms": round(1000 * 0.0123457, 3)}
    for t, name in zip(timers, ("port.json", "jax.json")):
        t.dump_json(str(tmp_path / name))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    assert "traceEvents" in _trace(str(tmp_path / "trace"))


def test_metrics_logger_files_match_jax(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "time", lambda: 1234.56789)
    rows = [(1, {"loss": 0.5, "lr": np.float32(1e-3), "name": "x"}, ""),
            (2, {"loss": 0.25, "extra": 3}, ""),
            (3, {"chair AP": 0.1, "mAP": 0.2}, "iou0.25/")]
    for cls, sub in ((MetricsLogger, "port"), (JaxLogger, "jax")):
        log = cls(str(tmp_path / sub), name="m")
        for step, metrics, prefix in rows[:2]:
            log.log(step, metrics, prefix)
        log.log_map_table(rows[2][0], rows[2][1], 0.25)
    for ext in ("csv", "jsonl"):
        assert (tmp_path / "port" / f"m.{ext}").read_bytes() == \
            (tmp_path / "jax" / f"m.{ext}").read_bytes()
