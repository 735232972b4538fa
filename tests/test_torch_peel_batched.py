"""The peel's grid branch and its batched form: peeling on the dense
rot/scale grids of the 6-channel splat gives the lazy branch's boxes, the
batched peel over C grids gives exactly what C single peels give, and the
joint pipeline's non-lazy tail finds the lazy tail's boxes."""

import numpy as np
import pytest
import torch

from canonicalvoting_tpu_torch.decode.peeling import (
    PeelConfig, peel_boxes, peel_boxes_batched)
from canonicalvoting_tpu_torch.ops.hough_voting import (
    clipped_grid_dims, compute_corners, grid_dims_from_corners, hough_voting,
    hough_voting_obj, vote_stats_at_cell)

from tests.test_peeling import _scene_with_boxes
from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401  (autouse)

RES, ROTS = 0.06, 24
CFG = PeelConfig(res=RES, max_boxes=8, max_iters=32)


@pytest.fixture(scope="module")
def scene():
    """Two boxes; category c of three keeps box c's confident points (the
    third keeps none)."""
    specs = [
        (np.array([1.0, 0.6, 1.0], np.float32),
         np.array([0.45, 0.5, 0.35], np.float32), 0.4),
        (np.array([3.0, 0.5, 2.8], np.float32),
         np.array([0.5, 0.4, 0.5], np.float32), -0.9),
    ]
    points, xyz, scl, prob, cls = _scene_with_boxes(
        np.random.RandomState(0), specs)
    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        points=points, xyz=xyz, scl=scl, prob=prob, cls=cls).items()}
    valid = torch.ones(len(points))
    valid[::50] = 0.0
    corners = compute_corners(t["points"], valid)
    gshape = tuple(int(d) for d in grid_dims_from_corners(corners, RES))
    keep = [torch.from_numpy((cls == c) & (prob > 0.5)) for c in range(3)]
    prob_c = torch.stack([torch.where(k, t["prob"], torch.full_like(t["prob"], 0.02))
                          for k in keep])
    return t, valid, corners, gshape, prob_c


def _lazy_fn(t, valid, corners, gshape, xyz, prob):
    dims = clipped_grid_dims(corners, RES, gshape)

    def fn(cand):
        return vote_stats_at_cell(t["points"], xyz, t["scl"], prob, corners[0],
                                  dims, RES, ROTS, cand, valid=valid)
    return fn


def test_grid_branch_matches_lazy(scene):
    t, valid, corners, gshape, _ = scene
    kw = dict(res=RES, num_rots=ROTS, grid_shape=gshape, corners=corners,
              valid=valid)
    go, gr, gs = hough_voting(t["points"], t["xyz"], t["scl"], t["prob"], **kw)
    go_lazy = hough_voting_obj(t["points"], t["xyz"], t["scl"], t["prob"], **kw)
    torch.testing.assert_close(go, go_lazy, rtol=0, atol=0)
    args = (t["points"], t["xyz"], t["prob"], t["cls"], corners[0], CFG)
    grid = peel_boxes(go, *args, valid=valid, grid_rot=gr, grid_scale=gs)
    lazy = peel_boxes(go_lazy, *args,
                      _lazy_fn(t, valid, corners, gshape, t["xyz"], t["prob"]),
                      valid=valid)
    n = int(lazy["n_boxes"])
    assert n == 2 and int(grid["n_boxes"]) == n
    for k in ("classes", "accepted", "exit_on_threshold", "truncated"):
        torch.testing.assert_close(grid[k], lazy[k], rtol=0, atol=0)
    # rot/scale read from the grids or summed at the cell: f32 rounding only
    torch.testing.assert_close(grid["boxes"][:n], lazy["boxes"][:n],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "grids"])
def test_batched_peel_equals_single_peels(scene, lazy):
    """Exact equality needs the autouse one-thread fixture: a multi-threaded
    CPU sum of one long vector splits it across threads and adds the parts
    in another order than a row of a batched sum."""
    t, valid, corners, gshape, prob_c = scene
    kw = dict(res=RES, num_rots=ROTS, grid_shape=gshape, corners=corners,
              valid=valid)
    xyz_c = torch.stack([t["xyz"]] * 3)
    if lazy:
        grids = [(hough_voting_obj(t["points"], t["xyz"], t["scl"], p, **kw),
                  None, None) for p in prob_c]
    else:
        grids = [hough_voting(t["points"], t["xyz"], t["scl"], p, **kw)
                 for p in prob_c]
    singles = []
    for c, (go, gr, gs) in enumerate(grids):
        fn = _lazy_fn(t, valid, corners, gshape, t["xyz"], prob_c[c]) \
            if lazy else None
        singles.append(peel_boxes(go, t["points"], t["xyz"], prob_c[c], None,
                                  corners[0], CFG, fn, valid=valid,
                                  grid_rot=gr, grid_scale=gs))
    stacked = [None if g[0] is None else torch.stack(g)
               for g in zip(*grids)]
    fn = _lazy_fn(t, valid, corners, gshape, xyz_c, prob_c) if lazy else None
    batched = peel_boxes_batched(stacked[0], t["points"], xyz_c, prob_c, None,
                                 corners[0], CFG, fn, valid=valid,
                                 grid_rot=stacked[1], grid_scale=stacked[2])
    assert [int(s["n_boxes"]) for s in singles] == [1, 1, 0]
    for k, v in batched.items():
        torch.testing.assert_close(v, torch.stack([s[k] for s in singles]),
                                   rtol=0, atol=0)


def test_non_lazy_joint_tail_matches_lazy():
    """DetectionPipeline(lazy_rot_scale=False) on the planted scene of
    tests/test_torch_pipeline.py, cut to 3 x 2 x 3 m: the same boxes as the
    lazy tail, within one vote cell."""
    from canonicalvoting_tpu_torch.data.geometry import NCLASSES
    from canonicalvoting_tpu_torch.data.synthetic import (
        encode_joint_head_rows, make_scene, perfect_predictions)
    from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
    from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet

    res = 0.05
    sc = make_scene(np.random.RandomState(0), extent=(3.0, 2.0, 3.0),
                    n_background=5000, n_boxes=3, pts_per_box=1500)
    model = DenseMinkUNet(3, 6 * NCLASSES + NCLASSES + 1, layers=(1,) * 8,
                          planes=(8, 16, 16, 16, 16, 16, 8, 8), init_dim=8,
                          compute_dtype="float32")
    outs = []
    for lazy in (True, False):
        pipe = DetectionPipeline(model=model, res=res, num_rots=ROTS,
                                 peel=PeelConfig(res=res, max_boxes=16, max_iters=48),
                                 grid_multiple=16, cap_multiple=1024,
                                 lazy_rot_scale=lazy, device="cpu")
        args = pipe.prepare_scene(sc.points, sc.rgb)
        pw = args.coords_w.numpy()[args.valid.numpy() > 0]
        xyz, scl, prob, cls = perfect_predictions(sc, pw)
        rows = encode_joint_head_rows(pw, xyz, scl, prob > 0.5, cls,
                                      len(args.valid))
        outs.append(pipe.tail(torch.from_numpy(rows), args.coords_w,
                              args.valid, args.grid_shape))
    n = int(outs[0]["n_boxes"])
    assert n >= 2 and int(outs[1]["n_boxes"]) == n
    torch.testing.assert_close(outs[1]["classes"][:n], outs[0]["classes"][:n],
                               rtol=0, atol=0)
    torch.testing.assert_close(outs[1]["boxes"][:n], outs[0]["boxes"][:n],
                               rtol=0, atol=res)
