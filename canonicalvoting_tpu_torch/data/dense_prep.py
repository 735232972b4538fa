"""Host-side prep for the dense-execution backbone.

The port's copy of ``canonicalvoting_tpu/data/dense_prep.py``: per scene, the
L0 dense-grid geometry, each point's flat cell id, the occupied-tile lists of
every tiled kernel and the occupancy pyramid. The base voxel coordinate is
aligned DOWN to the coarsest stride (16) so dense stride-2 downsampling
reproduces the floor-division semantics of the sparse pyramid exactly.

All grids are MARGINED: stored with (MX, MY, MZ) = (2, 2, 16) zero borders
around the interior. The margins are the JAX package's layout; the port keeps
them so flat ids and tile lists are the same integers in both packages, and a
conv window never leaves the grid. Grids carry their real channel count,
channel-last: (X + 2MX, Y + 2MY, Z + 2MZ, C).

The tile plans were swept on the TPU. They are the defaults of the
``tile_plan`` / ``stem_plan`` / ``conv_plan`` / ``trans_plan`` parameters of
:func:`level_tiles`; a plan tuned for the H100 is passed there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

MX, MY, MZ = 2, 2, 16
STRIDE_ALIGN = 16

Plan = Tuple[Tuple[int, int, int], int]  # (tile_shape, group)

# per-level lists: the down kernels into L2-L4 and the up kernels into L1-L3
TILE_PLAN: Dict[int, Plan] = {
    0: ((4, 4, 8), 16),
    1: ((8, 8, 16), 4),
    2: ((8, 8, 16), 2),
    3: ((4, 4, 16), 4),
    4: ((2, 8, 8), 4),
}
# the k=5 stem's list (an int key: the JAX package's tiles dict keys)
STEM_KEY = -1
STEM_TILE_PLAN: Plan = ((4, 2, 8), 32)
# dedicated level-transition lists: up into L0, down into L1
TRANS_KEYS: Dict[Tuple[str, int], int] = {("up", 0): -2, ("down", 1): -3}
TRANS_LEVEL: Dict[int, int] = {-2: 0, -3: 1}
TRANS_TILE_PLAN: Dict[int, Plan] = {-2: ((8, 8, 32), 2), -3: ((4, 4, 8), 16)}
# the k=3 block convs at L0/L1, keyed CONV_KEY_OFF + level
CONV_KEY_OFF = 10
CONV_TILE_PLAN: Dict[int, Plan] = {0: ((2, 2, 8), 64), 1: ((4, 4, 8), 16)}


def dense_grid_geometry(coords: np.ndarray, dim_multiple: int = 32,
                        ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(base (3,) int32, INTERIOR dims (X, Y, Z)) for raw L0 voxel coords."""
    c = coords[:, -3:].astype(np.int64)
    lo = c.min(0)
    hi = c.max(0)
    base = (lo // STRIDE_ALIGN) * STRIDE_ALIGN
    m = int(np.lcm(STRIDE_ALIGN, dim_multiple))
    dims = tuple(int(np.ceil((h - b + 1) / m) * m) for h, b in zip(hi, base))
    return base.astype(np.int32), dims


def dense_flat_ids(coords: np.ndarray, base: np.ndarray,
                   dims: Tuple[int, int, int]) -> np.ndarray:
    """Flat MARGINED cell index per point; -1 when outside the interior."""
    c = coords[:, -3:].astype(np.int64) - base.astype(np.int64)
    ok = np.all((c >= 0) & (c < np.asarray(dims)), axis=1)
    ym, zm = dims[1] + 2 * MY, dims[2] + 2 * MZ
    flat = ((c[:, 0] + MX) * ym + (c[:, 1] + MY)) * zm + (c[:, 2] + MZ)
    return np.where(ok, flat, -1).astype(np.int32)


def _interior_coords(coords, base, dims):
    c0 = coords[:, -3:].astype(np.int64) - base.astype(np.int64)
    return c0[np.all((c0 >= 0) & (c0 < np.asarray(dims)), axis=1)]


def level_tiles(coords: np.ndarray, base: np.ndarray,
                dims: Tuple[int, int, int], tile_plan=None, stem_plan=None,
                conv_plan=None, trans_plan=None):
    """{key: (T, 3) int32} occupied-tile coordinates of every tiled kernel.

    Keys: levels 0-4 (``tile_plan``), ``STEM_KEY`` (``stem_plan``),
    ``CONV_KEY_OFF + level`` (``conv_plan``) and the ``TRANS_KEYS`` values
    (``trans_plan``); each defaults to the JAX package's plan. Tile coords
    index the INTERIOR in tile units. T is padded up to a geometric bucket
    (a multiple of lcm(32, group)) by repeating the last tile: a
    repeated tile rewrites identical values. Keys whose level dims do not
    divide by the tile shape are skipped.
    """
    tile_plan = TILE_PLAN if tile_plan is None else tile_plan
    stem_plan = STEM_TILE_PLAN if stem_plan is None else stem_plan
    conv_plan = CONV_TILE_PLAN if conv_plan is None else conv_plan
    trans_plan = TRANS_TILE_PLAN if trans_plan is None else trans_plan
    c0 = _interior_coords(coords, base, dims)
    entries = [(lvl, lvl, p) for lvl, p in tile_plan.items()]
    entries.append((STEM_KEY, 0, stem_plan))
    entries.extend((CONV_KEY_OFF + lvl, lvl, p) for lvl, p in conv_plan.items())
    entries.extend((key, TRANS_LEVEL[key], p) for key, p in trans_plan.items())
    out = {}
    for key, lvl, (tile_shape, group) in entries:
        ts = np.asarray(tile_shape)
        d = tuple(x >> lvl for x in dims)
        if any(dd % tt for dd, tt in zip(d, ts)):
            continue
        tc = (c0 >> lvl) // ts
        nty, ntz = d[1] // int(ts[1]), d[2] // int(ts[2])
        fl = np.unique((tc[:, 0] * nty + tc[:, 1]) * ntz + tc[:, 2])
        t = np.stack([fl // (nty * ntz), (fl // ntz) % nty, fl % ntz],
                     axis=1).astype(np.int32)
        m = int(np.lcm(32, group))
        m = int(np.lcm(m, 1 << max(int(len(t)).bit_length() - 4, 0)))
        pad = int(np.ceil(len(t) / m) * m) - len(t)
        if pad:
            t = np.concatenate([t, np.repeat(t[-1:], pad, axis=0)], axis=0)
        out[key] = t
    return out


def fit_plans(dims: Tuple[int, int, int]) -> Dict[str, object]:
    """The default plans, each tile axis cut to its gcd with the level's
    interior dims, as keyword arguments of :func:`level_tiles` and
    :func:`tile_plan_for_key`. Where a default shape divides the dims it is
    kept, so the lists equal the JAX package's; elsewhere (a level the JAX
    package runs through its dense XLA conv instead) a smaller tile divides
    them, and every kernel of the backbone gets a list."""
    def fit(plan: Plan, lvl: int) -> Plan:
        ts, group = plan
        return tuple(int(np.gcd(t, d >> lvl)) for t, d in zip(ts, dims)), group

    return {
        "tile_plan": {lvl: fit(p, lvl) for lvl, p in TILE_PLAN.items()},
        "stem_plan": fit(STEM_TILE_PLAN, 0),
        "conv_plan": {lvl: fit(p, lvl) for lvl, p in CONV_TILE_PLAN.items()},
        "trans_plan": {k: fit(p, TRANS_LEVEL[k])
                       for k, p in TRANS_TILE_PLAN.items()},
    }


def tile_plan_for_key(key: int, tile_plan=None, stem_plan=None,
                      conv_plan=None, trans_plan=None) -> Plan:
    """(tile_shape, group) of any tiles-dict key."""
    if key == STEM_KEY:
        return STEM_TILE_PLAN if stem_plan is None else stem_plan
    if key in TRANS_LEVEL:
        return (TRANS_TILE_PLAN if trans_plan is None else trans_plan)[key]
    if key >= CONV_KEY_OFF:
        return (CONV_TILE_PLAN if conv_plan is None
                else conv_plan)[key - CONV_KEY_OFF]
    return (TILE_PLAN if tile_plan is None else tile_plan)[key]


def host_occ_levels(coords: np.ndarray, base: np.ndarray,
                    dims: Tuple[int, int, int], levels: int = 5):
    """Margined {0, 1} float32 occupancy grid per stride level.

    Level-l occupancy at cell c is 1 iff some input voxel maps to c by
    floor-division by 2**l: the model's own pyramid (scatter + 2x2x2
    max-pool), built on the host.
    """
    c0 = _interior_coords(coords, base, dims)
    out = []
    for lvl in range(levels):
        d = tuple(int(x) >> lvl for x in dims)
        g = np.zeros((d[0] + 2 * MX, d[1] + 2 * MY, d[2] + 2 * MZ),
                     np.float32)
        cl = c0 >> lvl
        g[cl[:, 0] + MX, cl[:, 1] + MY, cl[:, 2] + MZ] = 1.0
        out.append(g)
    return out
