"""The readers of the program's spans (``benchmark/spans.py`` and the metrics
that use it) on a synthetic traced run: only the spans that start inside the
window count, and a program that keeps no spans gives no number."""

import pytest

from benchmark import registry
from benchmark.run import Run
from ceres_slam_tpu_torch.utils import telemetry

MS = 1e-3


def _span(i, name, t0, t1, parent=None, request=None, **attrs):
    return {"id": i, "parent": parent, "request": request or i, "name": name, "t0": t0,
            "t1": t1, "attrs": attrs}


def _run(records):
    return Run(cell={}, config={}, mix={}, driver=None, records=records, window_s=0.0,
               setup_s=0.0)


def _read(name, run):
    return registry.load_module("metrics", name).read(run)


# a window of two items, [10, 30] s on the host clock, 2 solves each
RECORDS = [{"solves": 2, "iterations": 0, "t0": 10.0, "t1": 20.0},
           {"solves": 2, "iterations": 0, "t0": 20.0, "t1": 30.0}]


def _fullba_spans():
    """One warm-up solve before the window, two solves inside it, one
    starting after it: each ``pcg.solve`` > ``pcg.prepare``, ``lm.node``."""
    out, i = [], 0
    for t, its, ns, h2d in ((5.0, 99, [9e9, 9e9], 9e9), (11.0, 10, [70e6, 40e6], 2e6),
                            (21.0, 30, [210e6, 120e6], 4e6), (31.0, 99, [9e9, 9e9], 9e9)):
        root = i + 1
        out += [_span(root + 1, "pcg.prepare", t, t + 0.1, root, root),
                _span(root + 2, "lm.node", t + 0.1, t + 0.5, root, root, iterations=its,
                      inner_iterations=[4 * its], device_ns=ns),
                _span(root, "pcg.solve", t, t + 0.6, h2d_bytes=h2d)]
        i += 3
    return out


@pytest.fixture
def fullba(monkeypatch):
    monkeypatch.setattr(telemetry, "spans", _fullba_spans)
    return _run(RECORDS)


def test_node_split_reads_the_window_only(fullba):
    # CG: (40 + 120) ms over 40 iterations; the body: (30 + 90) ms over 40
    assert _read("cg_ms_per_lm_iter", fullba) == pytest.approx(160 / 40)
    assert _read("lm_body_ms", fullba) == pytest.approx(120 / 40)


def test_prepare_and_uploads_over_the_solves(fullba):
    assert _read("prepare_ms", fullba) == pytest.approx(2 * 100 / 4)
    assert _read("h2d_mb.solve", fullba) == pytest.approx((2 + 4) / 4)


def test_host_time_less_the_nodes_over_the_runs(monkeypatch):
    """Two runs' top-level spans in the window (a stage holding a node,
    and a build beside it), one warm-up run's before it."""
    spans = [_span(1, "phong.stage", 1.0, 2.0), _span(2, "lm.node", 1.2, 1.9, 1, 1),
             _span(3, "phong.build_problem", 10.0, 10.05, h2d_bytes=3e6),
             _span(4, "phong.stage", 10.1, 10.4, h2d_bytes=1e6),
             _span(5, "lm.readout", 10.35, 10.4, 4, 4),
             _span(6, "lm.node", 10.15, 10.35, 4, 4),
             _span(7, "phong.stage", 25.0, 25.5), _span(8, "lm.node", 25.1, 25.4, 7, 7)]
    monkeypatch.setattr(telemetry, "spans", lambda: spans)
    run = _run(RECORDS)
    host = (0.05 + 0.3 - 0.2) + (0.5 - 0.3)
    assert _read("wall_outside_nodes_ms", run) == pytest.approx(1e3 * host / 4)
    assert _read("h2d_mb.run", run) == pytest.approx(4 / 4)


@pytest.mark.parametrize("name", ["cg_ms_per_lm_iter", "lm_body_ms", "prepare_ms",
                                  "h2d_mb.solve", "h2d_mb.run", "wall_outside_nodes_ms"])
def test_no_spans_no_number(monkeypatch, name):
    """Without the program's spans (none in the window, or a program
    without ``telemetry.spans``), every reader gives None."""
    monkeypatch.setattr(telemetry, "spans", lambda: [_span(1, "pcg.solve", 0.0, 1.0)])
    assert _read(name, _run(RECORDS)) is None
    monkeypatch.delattr(telemetry, "spans")
    assert _read(name, _run(RECORDS)) is None


def test_a_node_without_an_inner_loop_gives_no_split(monkeypatch):
    spans = [_span(1, "lm.node", 11.0, 12.0, iterations=5, device_ns=[5e6])]
    monkeypatch.setattr(telemetry, "spans", lambda: spans)
    assert _read("cg_ms_per_lm_iter", _run(RECORDS)) is None


def test_a_store_that_dropped_spans_gives_no_number(fullba, monkeypatch):
    """Spans lost to the bounded store would make every reader count short."""
    assert _read("prepare_ms", fullba) is not None
    monkeypatch.setattr(telemetry, "dropped", lambda: 1)
    for name in ("cg_ms_per_lm_iter", "lm_body_ms", "prepare_ms", "h2d_mb.solve"):
        assert _read(name, fullba) is None
