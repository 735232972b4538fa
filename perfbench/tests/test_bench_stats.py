"""Rates and tails over a whole window, against a window with a planted
stall."""

import pytest

from harness.stats import percentile, rate
from drivers import separate_eval


class _Window:
    """A stand-in for the driver after a window: its scans' times."""

    def __init__(self, seconds):
        self.scans = [{"s": s} for s in seconds]


def test_tail_is_of_every_scan_and_sees_a_stall():
    steady = [0.4] * 100
    stalled = steady[:88] + [2.0] * 12     # 12% of the scans stall
    e2e = separate_eval.Driver.end_to_end
    assert e2e(_Window(steady), 40.0)["scene_ms_p90"] == pytest.approx(400.0)
    assert e2e(_Window(stalled), 59.2)["scene_ms_p90"] == pytest.approx(2000.0)
    # a stall of fewer than a tenth of the scans stays below the 90th
    few = steady[:95] + [2.0] * 5
    assert e2e(_Window(few), 48.0)["scene_ms_p90"] == pytest.approx(400.0)


def test_rate_takes_the_whole_window():
    stalled = [0.4] * 88 + [2.0] * 12
    window = sum(stalled)
    got = separate_eval.Driver.end_to_end(_Window(stalled), window)
    assert got["scenes_per_s"] == pytest.approx(100 / window)
    assert got["scenes_per_s"] < 100 / sum([0.4] * 100)


def test_percentile_by_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 90) == 90
    assert percentile(v, 100) == 100
    assert percentile([5.0], 90) == 5.0
    with pytest.raises(ValueError):
        percentile([], 90)
    with pytest.raises(ValueError):
        rate(3, 0.0)
