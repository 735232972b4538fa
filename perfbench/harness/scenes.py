"""The benchmark's scene generator: ScanNet-scale synthetic rooms with
planted oriented boxes.

A frozen copy of the recipe of ``canonicalvoting_tpu_torch/data/
synthetic.py`` (``make_scene``, ``perfect_predictions``,
``encode_separate_head_rows``) and of its voxelization, kept here so that
the yardstick does not move when the program does. The changes: each scan
type of the traffic file, with the file's layout seed, fixes its room,
its boxes and its voxel count; boxes stand on the floor, clear of each
other and of the walls; and the run's seed draws the colours and the
order of the pool, so every seed costs the same work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

NCLASSES = 9
GAP_M = 0.1      # the least distance between two boxes' footprint circles


def rotmat_y(angle: float) -> np.ndarray:
    """3x3 yaw rotation, rows [c, 0, -s], [0, 1, 0], [s, 0, c]."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def unit_box_corners() -> np.ndarray:
    """(8, 3) corners of the [-1, 1]^3 box; 0-3 the top face (+y)."""
    x = [1, 1, -1, -1, 1, 1, -1, -1]
    y = [1, 1, 1, 1, -1, -1, -1, -1]
    z = [1, -1, -1, 1, 1, -1, -1, 1]
    return np.array([x, y, z], dtype=np.float64).T


def sub_seed(seed: int, *path: int) -> int:
    """A 32-bit seed for one part of a run, derived from the run's
    ``--seed`` (any size) and the part's path."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *path])
               .generate_state(1)[0])


@dataclass
class Box:
    center: np.ndarray
    scale: np.ndarray   # half-extents
    yaw: float
    class_idx: int


@dataclass
class Scene:
    points: np.ndarray        # (N, 3) float32, world
    rgb: np.ndarray           # (N, 3) float32 in [0, 1]
    xyz_labels: np.ndarray    # (N, 3) local canonical coordinates
    scale_labels: np.ndarray  # (N, 3)
    class_labels: np.ndarray  # (N,) int32, NCLASSES = background
    boxes: List[Box]


def _room_surface(rng, ex, n):
    areas = np.array([ex[0] * ex[2], ex[0] * ex[1], ex[0] * ex[1],
                      ex[2] * ex[1], ex[2] * ex[1]])
    counts = (n * areas / areas.sum()).astype(int)
    pts = []
    u = rng.uniform(size=(counts[0], 2))
    pts.append(np.stack([u[:, 0] * ex[0], np.zeros(counts[0]), u[:, 1] * ex[2]], -1))
    for i, z in ((1, 0.0), (2, float(ex[2]))):
        u = rng.uniform(size=(counts[i], 2))
        pts.append(np.stack([u[:, 0] * ex[0], u[:, 1] * ex[1],
                             np.full(counts[i], z)], -1))
    for i, x in ((3, 0.0), (4, float(ex[0]))):
        u = rng.uniform(size=(counts[i], 2))
        pts.append(np.stack([np.full(counts[i], x), u[:, 1] * ex[1],
                             u[:, 0] * ex[2]], -1))
    out = np.concatenate(pts, 0).astype(np.float32)
    return out + rng.randn(len(out), 3).astype(np.float32) * 0.01


def _box_surface_lcc(rng, n):
    face = rng.randint(6, size=n)
    u = rng.uniform(-0.98, 0.98, (n, 2)).astype(np.float32)
    sign = np.where(face % 2 == 0, -0.98, 0.98).astype(np.float32)
    axis = face // 2
    lcc = np.zeros((n, 3), np.float32)
    for a in range(3):
        sel = axis == a
        others = [b for b in range(3) if b != a]
        lcc[sel, a] = sign[sel]
        lcc[sel, others[0]] = u[sel, 0]
        lcc[sel, others[1]] = u[sel, 1]
    return lcc


def make_scene(rng: np.random.RandomState, extent: Sequence[float],
               n_background: int, objects: Sequence[Tuple[int, Sequence[float], float]],
               points_per_m2: float) -> Scene:
    """A room of ``extent`` metres: ``n_background`` surface points on its
    floor and four walls, and one box for each ``(class, half-extents,
    elevation)`` of ``objects``, its surface sampled at ``points_per_m2``.
    Each box stands ``elevation`` above the floor, inside the walls, its
    footprint circle ``GAP_M`` clear of every other, at its own yaw."""
    ex = np.asarray(extent, np.float32)
    pts = [_room_surface(rng, ex, n_background)]
    boxes: List[Box] = []
    # the widest footprints first, so that the draws below find room
    for cls, he, elevation in sorted(objects, key=lambda o: -np.hypot(o[1][0], o[1][2])):
        scale = np.asarray(he, np.float32)
        r = float(np.hypot(scale[0], scale[2]))
        for _ in range(10000):
            center = np.array([rng.uniform(r + 0.05, ex[0] - r - 0.05),
                               scale[1] + elevation + 0.02,
                               rng.uniform(r + 0.05, ex[2] - r - 0.05)], np.float32)
            if all(np.hypot(*(center - b.center)[[0, 2]])
                   > r + float(np.hypot(b.scale[0], b.scale[2])) + GAP_M
                   for b in boxes):
                break
        else:
            raise ValueError(f"{len(objects)} boxes do not fit a room of {extent}")
        yaw = float(rng.uniform(-np.pi, np.pi))
        area = 8.0 * float(scale[0] * scale[1] + scale[1] * scale[2]
                           + scale[0] * scale[2])
        lcc = _box_surface_lcc(rng, int(round(points_per_m2 * area)))
        world = (rotmat_y(yaw) @ (lcc * scale).T).T + center
        pts.append(world.astype(np.float32))
        boxes.append(Box(center, scale, yaw, int(cls)))
    points = np.concatenate(pts, 0)
    xyz = np.zeros_like(points)
    scl = np.full_like(points, 0.25)
    cls_l = np.full((len(points),), NCLASSES, np.int32)
    for b in boxes:
        inv = ((points - b.center) @ rotmat_y(b.yaw)) / b.scale
        inside = np.all(np.abs(inv) < 1.0, axis=-1)
        xyz[inside] = inv[inside]
        scl[inside] = b.scale
        cls_l[inside] = b.class_idx
    rgb = rng.uniform(0, 1, points.shape).astype(np.float32)
    return Scene(points.astype(np.float32), rgb, xyz.astype(np.float32),
                 scl.astype(np.float32), cls_l, boxes)


def sparse_quantize(points: np.ndarray, res: float):
    """(coords (M, 3) int32, index (M,)): the unique voxels floor(p / res)
    (float32 division), each keeping its first point, sorted by (x, y, z)."""
    p = np.ascontiguousarray(points[:, :3], np.float32)
    vox = np.floor(p / np.float32(res)).astype(np.int64)
    shifted = vox - vox.min(0)
    keys = (shifted[:, 0] << 42) | (shifted[:, 1] << 21) | shifted[:, 2]
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.ones(len(keys), bool)
    first[1:] = sk[1:] != sk[:-1]
    index = order[first]
    return vox[index].astype(np.int32), index


def perfect_predictions(scene: Scene, points_w: np.ndarray,
                        base_prob: float = 0.02, obj_prob: float = 0.95):
    """Ideal per-point outputs at quantized world points: (xyz, scale,
    prob, class)."""
    xyz = np.zeros_like(points_w)
    scl = np.full_like(points_w, 0.25)
    prob = np.full((len(points_w),), base_prob, np.float32)
    cls = np.zeros((len(points_w),), np.int32)
    for b in scene.boxes:
        inv = ((points_w - b.center) @ rotmat_y(b.yaw)) / b.scale
        inside = np.all(np.abs(inv) < 1.0, axis=-1)
        xyz[inside] = inv[inside]
        scl[inside] = b.scale
        prob[inside] = obj_prob
        cls[inside] = b.class_idx
    return xyz.astype(np.float32), scl.astype(np.float32), prob, cls


def encode_separate_head_rows(points_w, xyz, scl, prob_is_high, cap):
    """Per-point predictions -> raw per-category head rows (cap, 8): xyz 3,
    log scale 3, binary objectness logits 2 (foreground rows 0 / 4,
    background and padding rows 4 / 0)."""
    n = len(points_w)
    rows = np.zeros((cap, 8), np.float32)
    rows[:, 6] = 4.0
    r = np.arange(n)[prob_is_high]
    rows[r, 0:3] = xyz[prob_is_high]
    rows[r, 3:6] = np.log(scl[prob_is_high])
    rows[r, 6] = 0.0
    rows[r, 7] = 4.0
    return rows


def planted_separate_rows(scene: Scene, coords: np.ndarray, res: float,
                          cap: int, n_categories: int) -> np.ndarray:
    """(C, cap, 8) head rows: category c holds the confident points of the
    scene's class-c boxes."""
    points_w = coords.astype(np.float32) * np.float32(res)
    xyz, scl, prob, cls = perfect_predictions(scene, points_w)
    return np.stack([encode_separate_head_rows(
        points_w, xyz, scl, (prob > 0.5) & (cls == c), cap)
        for c in range(n_categories)])


def room_area(extent: Sequence[float]) -> float:
    """m^2 of a room's floor and four walls."""
    x, y, z = (float(v) for v in extent)
    return x * z + 2.0 * y * (x + z)


def scan_spec(traffic: dict, member: int) -> dict:
    """The scan type of pool member ``member``: the traffic's scans in
    turn."""
    return traffic["scans"][member % len(traffic["scans"])]


def member_scan(traffic: dict, seed: int, member: int, res: float):
    """Pool member ``member`` of a traffic mix of scans, for ``seed``: (the
    scene, its voxels' (coords (M, 3) int32, rgb, xyz, scale, class)).

    The scan type and the traffic's ``layout_seed`` fix the scan's
    geometry: the room, the boxes (categories, sizes, positions and yaws)
    and M, the voxel count (the room's surface is oversampled and
    background voxels are dropped down to M). ``seed`` draws the colours.
    So every seed costs the same work, down to the peel's iterations, which
    follow the boxes' poses."""
    spec = scan_spec(traffic, member)
    cats = list(traffic["categories"])
    objects = []
    for name, count in spec["objects"].items():
        he = traffic["half_extents_m"][name]
        lift = float(traffic.get("elevation_m", {}).get(name, 0.0))
        objects += [(cats.index(name), he, lift)] * int(count)
    rng = np.random.RandomState(sub_seed(traffic["layout_seed"], 1, member))
    n_bg = int(round(traffic["background_points_per_m2"]
                     * room_area(spec["room_m"])))
    s = make_scene(rng, spec["room_m"], n_bg, objects,
                   traffic["object_points_per_m2"])
    coords, idx = sparse_quantize(s.points, res)
    cls = s.class_labels[idx]
    background = np.flatnonzero(cls == NCLASSES)
    drop = len(coords) - int(spec["voxels"])
    if drop < 0 or drop > len(background):
        raise ValueError(f"scan {spec['room']}: {len(coords)} voxels, "
                         f"{len(background)} of them background, cannot "
                         f"make {spec['voxels']}")
    keep = np.ones(len(coords), bool)
    keep[rng.choice(background, drop, replace=False)] = False
    idx = idx[keep]
    s.rgb = np.random.RandomState(sub_seed(seed, 2, member)).uniform(
        0, 1, s.points.shape).astype(np.float32)
    return s, (coords[keep], s.rgb[idx], s.xyz_labels[idx],
               s.scale_labels[idx], s.class_labels[idx])


def cycle_order(n: int, seed: int) -> np.ndarray:
    """The order, drawn from ``seed``, in which a window cycles through a
    pool of ``n`` members."""
    return np.random.RandomState(sub_seed(seed, 4)).permutation(n)
