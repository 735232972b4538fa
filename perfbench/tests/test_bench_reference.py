"""The reference tail against the generator's planted boxes: on a small
room, each planted box is found once, in its own category, where it was
planted, and a category without one finds nothing."""

import numpy as np
import torch

from harness import scenes
from reference import tail


def test_reference_finds_the_planted_boxes():
    res = 0.03
    rng = np.random.RandomState(sub := scenes.sub_seed(2 ** 31 + 7, 1, 0))
    assert sub < 2 ** 32
    objects = [(0, [0.2, 0.15, 0.25], 0.0), (1, [0.15, 0.2, 0.15], 0.0)]
    s = scenes.make_scene(rng, (1.5, 0.8, 1.5), 2000, objects, 640)
    coords = scenes.sparse_quantize(s.points, res)[0]
    n = len(coords)
    rows = torch.from_numpy(scenes.planted_separate_rows(s, coords, res, n, 3))
    pts = torch.from_numpy(coords.astype(np.float32) * np.float32(res))
    grid_shape = (64, 32, 64)
    corner, dims = tail.corners_and_dims(pts, res, grid_shape)
    xyz, scale, prob = tail.heads_of(rows)
    for c in range(3):
        g = tail.splat(pts, xyz[c], scale[c], prob[c], corner, dims, res, 120,
                       grid_shape)
        p = tail.peel(g, pts, xyz[c], scale[c], prob[c], corner, dims, 120,
                      tail.PeelSettings(res=res))
        boxes = p["boxes"].double().numpy()
        keep = tail.nms(boxes, p["scores"].numpy(), 0.3)
        planted = [b for b in s.boxes if b.class_idx == c]
        assert len(keep) == len(planted), (c, len(keep))
        assert len(boxes) == len(planted), (c, len(boxes))
        assert not p["truncated"]
        for b in planted:
            want = (scenes.rotmat_y(b.yaw) @ (scenes.unit_box_corners()
                                              * b.scale).T).T + b.center
            gap = min(np.abs(boxes[j] - want).max() for j in keep)
            assert gap < 3 * res, (c, gap)


def test_each_scan_costs_the_same_on_every_seed():
    tr = {"categories": ["chair", "table", "cabinet"], "layout_seed": 5,
          "background_points_per_m2": 300, "object_points_per_m2": 500,
          "half_extents_m": {"chair": [0.15, 0.2, 0.15], "table": [0.3, 0.15, 0.2],
                             "cabinet": [0.2, 0.25, 0.1]},
          "elevation_m": {"cabinet": 0.3},
          "scans": [{"room": "a", "room_m": [1.6, 0.8, 1.8], "voxels": 2000,
                     "objects": {"chair": 2, "table": 1}},
                    {"room": "b", "room_m": [1.4, 0.8, 1.4], "voxels": 1500,
                     "objects": {"cabinet": 1}}]}
    for member, n, counts in ((0, 2000, [2, 1, 0]), (1, 1500, [0, 0, 1]),
                              (2, 2000, [2, 1, 0])):
        s, rows = scenes.member_scan(tr, 3, member, 0.03)
        assert len(rows[0]) == n and all(len(r) == n for r in rows)
        assert [sum(b.class_idx == c for b in s.boxes) for c in range(3)] == counts
        for b in s.boxes:
            assert b.center[1] - b.scale[1] >= 0.02 - 1e-6
        keys = [tuple(c) for c in rows[0]]
        assert keys == sorted(keys) and len(set(keys)) == n
        # another seed: the same voxels and labels, other colours
        other = scenes.member_scan(tr, 2 ** 31 + 11, member, 0.03)[1]
        for i in (0, 2, 3, 4):
            assert np.array_equal(rows[i], other[i])
        assert not np.array_equal(rows[1], other[1])
    assert sorted(scenes.cycle_order(8, 3)) == list(range(8))


def test_iou_of_boxes():
    unit = tail.unit_corners("cpu", torch.float64).numpy()
    a = unit * 0.5
    assert tail.iou3d(a, a) == 1.0
    assert tail.iou3d(a, a + np.array([2.0, 0, 0])) == 0.0
    half = tail.iou3d(a, a + np.array([0.5, 0, 0]))
    assert abs(half - 1 / 3) < 1e-9
    boxes = np.stack([a, a + 0.01, a + 3.0])
    assert tail.nms(boxes, np.array([0.9, 0.8, 0.7]), 0.3) == [0, 2]
