"""The occupied-pair operation and byte count against a brute-force count
on a tiny scene."""

import itertools

import numpy as np
import pytest
import torch

from harness import work
from harness.device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S
from reference import minkunet


def _brute_pairs(coords0, site):
    """Occupied (output, tap) pairs by looping over every voxel and tap."""
    levels = [{tuple(c) for c in coords0}]
    for lvl in range(1, 5):
        s = 1 << lvl
        levels.append({tuple((np.array(c) // s) * s) for c in levels[0]})
    lvl = site.level
    if site.kind in ("one", "head"):
        return len(levels[lvl])
    if site.kind == "stem":
        taps = list(itertools.product(range(-2, 3), repeat=3))
        out, inp, lat = levels[0], levels[0], 1
    elif site.kind == "sub":
        taps = list(itertools.product(range(-1, 2), repeat=3))
        out, inp, lat = levels[lvl], levels[lvl], 1 << lvl
    elif site.kind == "down":
        taps = list(itertools.product(range(2), repeat=3))
        out, inp, lat = levels[lvl], levels[lvl - 1], 1 << (lvl - 1)
    else:  # up: each fine voxel reads its one coarse parent
        taps = [(0, 0, 0)]
        out, inp, lat = levels[lvl], levels[lvl + 1], 0
        return sum(tuple((np.array(c) // (2 << lvl)) * (2 << lvl)) in inp
                   for c in out)
    return sum(tuple(np.array(c) + lat * np.array(t)) in inp
               for c in out for t in taps)


def test_pairs_flops_and_bytes_match_a_brute_force_count():
    rng = np.random.RandomState(0)
    coords = np.unique(rng.randint(0, 12, size=(150, 3)), axis=0)
    sites = minkunet.conv_sites(3, 8, (1,) * 8, (8, 16, 16, 16, 16, 16, 8, 8),
                                init_dim=8)
    geo = minkunet.geometry(torch.nn.functional.pad(
        torch.from_numpy(coords).long(), (1, 0)))
    flops = nbytes = least = spatial = 0.0
    for s in sites:
        pairs = _brute_pairs(coords, s)
        assert minkunet.occupied_pairs(geo, s) == pairs, s.name
        n_out = len(geo.coords[s.level])
        n_in = {"down": lambda: len(geo.coords[s.level - 1]),
                "up": lambda: len(geo.coords[s.level + 1])}.get(
                    s.kind, lambda: n_out)()
        f = 2.0 * pairs * s.cin * s.cout
        b = (2 * n_in * s.cin + (4 if s.kind == "head" else 2) * n_out * s.cout
             + 2 * s.k ** 3 * s.cin * s.cout)
        flops, nbytes = flops + f, nbytes + b
        t = max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES_PER_S)
        least += t
        spatial += t if s.kind in ("stem", "sub", "down", "up") else 0.0
    got = work.backbone_work(geo, sites)
    assert got.flops == pytest.approx(flops)
    assert got.bytes == pytest.approx(nbytes)
    assert got.least_s == pytest.approx(least)
    assert got.conv_least_s == pytest.approx(spatial)
    assert 0 < got.conv_least_s < least


def test_level_coordinates_are_the_floor_lattice():
    c = torch.tensor([[0, 3, 5, 7], [0, 2, 4, 6], [0, -1, 0, 0], [1, 3, 5, 7]])
    geo = minkunet.geometry(c)
    assert sorted(map(tuple, geo.coords[1].tolist())) == [
        (0, -2, 0, 0), (0, 2, 4, 6), (1, 2, 4, 6)]
