"""The benchmark's arithmetic: rate over the window, the union of busy
intervals, the quartile spread."""

import statistics

import pytest

from vio_bench import stats


def test_rate_is_count_over_the_window():
    assert stats.rate(120, 30.0) == 4.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),  # overlap counted once
    ([(1, 3), (0, 2), (5, 6), (2.5, 2.7)], 4.0),  # unsorted, nested
    ([(0, 1), (1, 2)], 2.0),  # touching
    ([(3, 3), (4, 2)], 0.0),  # empty and reversed intervals
])
def test_union_of_busy_intervals(intervals, length):
    assert stats.union_length(intervals) == pytest.approx(length)


def test_idle_gaps_are_the_complement_of_the_union():
    iv = [(1, 2), (1.5, 3), (5, 6)]
    g = stats.gaps(iv, 0.0, 8.0)
    assert g == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    assert stats.union_length(iv) + sum(b - a for a, b in g) == pytest.approx(8.0)


def test_quartile_spread_uses_pythons_quartiles():
    v = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / med)
