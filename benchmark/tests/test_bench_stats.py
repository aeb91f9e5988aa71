"""The metric arithmetic: rates over the whole window, tails over every step."""

import statistics

import numpy as np
import pytest

from benchmark import stats


def test_per_item_is_wall_over_items_with_a_stall():
    # 9 solves of 1 s and one stall of 11 s: 20 s over 10 solves, not a median
    walls = [1.0] * 9 + [11.0]
    assert stats.per_item(sum(walls), len(walls)) == pytest.approx(2.0)
    assert stats.per_item(5.0, 0) is None


def test_rate_is_all_work_over_the_whole_window():
    assert stats.rate(300, 30.0) == pytest.approx(10.0)
    assert stats.rate(0, 30.0) is None


def test_p95_of_every_step_sees_a_stall():
    # 6 stalls of 500 ms among 100 steps of 10 ms, one in each of six
    # chunks of ten: every chunk's median is 10 ms, the p95 of all steps not
    steps = [10.0] * 100
    for i in (3, 21, 45, 58, 72, 99):
        steps[i] = 500.0
    chunks = [statistics.median(steps[i:i + 10]) for i in range(0, 100, 10)]
    assert max(chunks) == 10.0
    assert stats.percentile(steps, 95) == pytest.approx(np.percentile(steps, 95))
    assert stats.percentile(steps, 95) == 500.0
    rs = np.random.default_rng(0).exponential(size=333)
    for q in (50, 95, 99):
        assert stats.percentile(rs, q) == pytest.approx(np.percentile(rs, q))

