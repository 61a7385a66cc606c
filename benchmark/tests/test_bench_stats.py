"""Percentiles, TTFT and inter-token latencies, failed requests counting
as missing."""

import pytest

from benchmark.harness import stats


def test_nearest_rank_percentile():
    v = list(range(1, 101))  # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5  # ceil(4.75) = 5th
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_ttft_counts_missing_as_the_whole_wait():
    due = [0.0, 1.0, 2.0]
    first = [0.5, None, 2.25]
    assert stats.ttfts(due, first, give_up=70.0) == [0.5, 69.0, 0.25]
    # one missing request in 20 is the 95th percentile: it is above any limit
    due, first = [0.0] * 20, [0.1] * 19 + [None]
    assert stats.percentile(stats.ttfts(due, first, 60.0), 95) == pytest.approx(0.1)
    due, first = [0.0] * 19, [0.1] * 18 + [None]
    assert stats.percentile(stats.ttfts(due, first, 60.0), 95) == 60.0


def test_gaps_of_every_request_until_the_close():
    stamps = [[1.0, 1.1, 1.3], [2.0], [0.5, 0.6, 5.0]]
    assert stats.gaps(stamps) == pytest.approx([0.1, 0.2, 0.1, 4.4])
    assert stats.gaps(stamps, until=4.0) == pytest.approx([0.1, 0.2, 0.1])

