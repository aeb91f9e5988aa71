"""The reduction of a profiled window: nodes timed by events replace the
kernels the profiler ties to their graph launches; a plain graph's kernels
count as seen; busy time is clipped to the window; idle gaps are named by
the innermost host range."""

import pytest

from benchmark import trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_events():
    events = [
        _x("user_annotation", "bench.window", 0.0, 1000.0),
        _x("user_annotation", "bench.item", 0.0, 1000.0),
        _x("user_annotation", "bench.prepare", 0.0, 200.0),
        _x("kernel", "eager_k", 100.0, 50.0, corr=1),  # [100, 150]
        _x("cuda_runtime", "cudaLaunchKernel", 90.0, 5.0, corr=1),
        _x("user_annotation", trace.NODE_RANGE, 300.0, 10.0),
        _x("cuda_runtime", "cudaGraphLaunch", 302.0, 5.0, corr=2),
        _x("kernel", "first_pass_k", 310.0, 20.0, corr=2),  # node: [310, 310 + 400]
        _x("cuda_runtime", "cudaGraphLaunch", 800.0, 5.0, corr=3),  # a plain replay
        _x("kernel", "replayed_k", 810.0, 40.0, corr=3),  # [810, 850]
        _x("kernel", "late_k", 990.0, 50.0, corr=4),  # clipped at 1000: 10
    ]
    busy, ops, gaps = trace.reduce_events(events, [400e-6])
    assert busy == pytest.approx((50 + 400 + 40 + 10) * 1e-6)
    assert ops[trace.NODE] == pytest.approx(400e-6)
    assert "first_pass_k" not in ops and ops["replayed_k"] == pytest.approx(40e-6)
    # idle: [0, 100] in prepare; [150, 310] (its middle past prepare's end),
    # [710, 810] and [850, 990] in the item
    assert gaps["bench.prepare"] == pytest.approx(100e-6)
    assert gaps["bench.item"] == pytest.approx((160 + 100 + 140) * 1e-6)
