"""The port's spans and counters (``ceres_slam_tpu_torch/utils/telemetry.py``):
nesting, recording only under ``record()`` or a profiler, the bounded store,
counts on the innermost span and up its tree, uploads counted, the apps'
``--trace``, and the span trees the full-batch solve, the Phong staged solve
and a window step record on the CPU. The WHILE nodes' device timers are checked on the card
(tests/test_torch_cuda.py)."""

import collections
import json
import os

import numpy as np
import pytest
import torch

from ceres_slam_tpu_torch.problems import batch_scan
from ceres_slam_tpu_torch.problems.dataset import DatasetProblem, DatasetProblemSun
from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
from ceres_slam_tpu_torch.solver import lm, pcg, phong
from ceres_slam_tpu_torch.utils import sim, telemetry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    """An empty store, recording off, before and after."""
    assert not telemetry.recording()
    telemetry.reset()
    yield
    assert not telemetry.recording()
    telemetry.reset()


def _tree(records) -> list:
    """``(name, parent's name)`` of each record, in the order they closed."""
    names = {r["id"]: r["name"] for r in records}
    return [(r["name"], names.get(r["parent"])) for r in records]


def test_spans_nest_with_parents_and_requests():
    with telemetry.record():
        with telemetry.span("a", k=1) as a:
            with telemetry.span("b"):
                with telemetry.span("c"):
                    pass
            with telemetry.span("d") as d:
                d.set(n=2)
        with telemetry.span("e"):
            pass
    got = {r["name"]: r for r in telemetry.spans()}
    assert [r["name"] for r in telemetry.spans()] == ["c", "b", "d", "a", "e"]
    assert got["a"]["parent"] is None and got["e"]["parent"] is None
    assert got["b"]["parent"] == got["d"]["parent"] == got["a"]["id"]
    assert got["c"]["parent"] == got["b"]["id"]
    assert {got[n]["request"] for n in "abcd"} == {got["a"]["id"]}
    assert got["e"]["request"] == got["e"]["id"] != got["a"]["id"]
    assert got["a"]["attrs"] == {"k": 1} and got["d"]["attrs"] == {"n": 2}
    for r in got.values():
        assert r["t0"] <= r["t1"]
    assert got["a"]["t0"] <= got["b"]["t0"] <= got["c"]["t1"] <= got["a"]["t1"]
    assert a.seconds == pytest.approx(got["a"]["t1"] - got["a"]["t0"])


def test_nothing_recorded_with_recording_off():
    assert not telemetry.recording()
    with telemetry.span("off") as s:
        telemetry.count("h2d_bytes", 7)
    telemetry.count("h2d_bytes", 7)  # no span open: nothing to count on
    assert telemetry.spans() == [] and telemetry.dropped() == 0
    assert s.seconds >= 0.0  # the span still times itself
    assert not hasattr(s, "counts")


def test_recording_under_a_profiler_places_spans_in_its_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.recording()
        with telemetry.span("outer"):
            with telemetry.span("inner"):
                torch.ones(8) * 2
    assert not telemetry.recording()
    assert _tree(telemetry.spans()) == [("inner", "outer"), ("outer", None)]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= ranges


def test_trace_writes_the_blocks_spans(tmp_path):
    with telemetry.span("before"):
        pass
    with telemetry.trace(str(tmp_path / "tr")) as d:
        with telemetry.span("inside", x=1):
            pass
    with telemetry.span("after"):
        pass
    with open(os.path.join(d, "spans.json")) as f:
        saved = json.load(f)
    assert [(r["name"], r["attrs"]) for r in saved] == [("inside", {"x": 1})]
    assert os.path.isfile(os.path.join(d, "trace.json"))
    assert [r["name"] for r in telemetry.spans()] == ["inside"]  # recording ended with it


def test_record_writes_the_blocks_spans_without_a_profiler(tmp_path):
    path = str(tmp_path / "spans.json")
    with telemetry.span("before"):
        pass
    with telemetry.record(path):
        assert telemetry.recording()
        assert not torch.autograd.profiler._is_profiler_enabled
        with telemetry.span("inside", x=1):
            with telemetry.span("leaf"):
                pass
    with telemetry.span("after"):
        pass
    with open(path) as f:
        saved = json.load(f)
    assert _tree(saved) == [("leaf", "inside"), ("inside", None)]
    assert saved[1]["attrs"] == {"x": 1}
    assert [r["name"] for r in telemetry.spans()] == ["leaf", "inside"]


def test_app_trace_option_writes_the_runs_spans(triangle_csv, tmp_path):
    """``--trace DIR`` of an app: the run's spans in ``DIR/spans.json``, with
    no profiler; recording ends with the run."""
    from ceres_slam_tpu_torch.apps import dataset_vo

    out = str(tmp_path / "tr")
    dataset_vo.main([triangle_csv + "_vo.csv", "--window", "0", "--linear-solver", "pcg", "--max-iters", "5",
                     "--device", "cpu", "--lm-loop", "host", "--trace", out])
    assert os.listdir(out) == ["spans.json"]
    with open(os.path.join(out, "spans.json")) as f:
        saved = json.load(f)
    assert ("pcg.prepare", "pcg.solve") in _tree(saved)
    assert not telemetry.recording()


def test_store_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(telemetry, "_store", collections.deque(maxlen=3))
    with pytest.warns(UserWarning, match="dropped 2 spans"):
        with telemetry.record():
            for i in range(5):
                with telemetry.span(f"s{i}"):
                    pass
    assert [r["name"] for r in telemetry.spans()] == ["s2", "s3", "s4"]
    assert telemetry.dropped() == 2


def test_counts_land_on_the_innermost_span_and_sum_up_its_tree(monkeypatch):
    uploads = []
    # no card here: the upload is recorded, not made
    monkeypatch.setattr(torch.Tensor, "to", lambda t, *a, **k: uploads.append(a) or t)
    with telemetry.record():
        with telemetry.span("top"):
            with telemetry.span("mid"):
                with telemetry.span("leaf"):
                    telemetry.to_device(np.zeros(10), "cuda")  # 80 bytes
                    telemetry.to_device(np.zeros((2, 3), np.int32), "cuda:0")  # 24 bytes
                    telemetry.to_device(np.zeros(4), "cpu")  # no upload
                telemetry.count("h2d_bytes", 6)
            t = telemetry.to_device(np.ones(2), "cuda", torch.float32)  # converted: 8 bytes
    got = {r["name"]: r["attrs"] for r in telemetry.spans()}
    assert got == {"leaf": {"h2d_bytes": 104}, "mid": {"h2d_bytes": 110},
                   "top": {"h2d_bytes": 118}}
    assert t.dtype == torch.float32 and len(uploads) == 4


def test_stopwatch_sections_are_spans():
    sw = telemetry.Stopwatch()
    with telemetry.record():
        with sw.section("a", sync_value=torch.ones(2)):
            pass
        with sw.section("a"):
            pass
    (a0, a1) = telemetry.spans()
    assert a0["name"] == a1["name"] == "a"
    assert sw.sections["a"] == pytest.approx(a0["t1"] - a0["t0"] + a1["t1"] - a1["t0"])
    assert "a" in sw.report()


@pytest.fixture(scope="module")
def triangle_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans_sim")
    ds = sim.generate(kind="triangle", num_states=10, num_points=80, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    base = str(d / "tri")
    sim.write_track_csv(ds, base + ".csv", with_covar=True)
    sim.write_track_csv(ds, base + "_vo.csv")  # dataset_vo's track: shared variances
    sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
    sim.write_obs_sun_csv(ds, base + "_sun_dir.csv")
    return base


def test_full_batch_solve_records_its_tree(triangle_csv):
    """On the CPU the tables and the plan are used only if given (none
    here), so ``prepare`` builds the banded preconditioner's tracks alone;
    the LM loop runs on the host (no node span)."""
    ds = DatasetProblem.read_csv(triangle_csv + "_vo.csv")
    ds.device = "cpu"
    ds.precompute_pair_alignments()
    ds.compute_initial_guess(0, ds.num_states)
    n_obs, n_pts, _ = ds._window_budget(ds.num_states)
    problem, state0, _ = ds.build_window_problem(0, ds.num_states, n_obs, n_pts)
    with telemetry.record():
        _, summary = pcg.solve_ba_pcg(problem, state0, lm.SolveConfig(max_iters=5))
    assert summary.iterations > 0
    assert _tree(telemetry.spans()) == [("pcg.tracks", "pcg.prepare"),
                                        ("pcg.prepare", "pcg.solve"), ("pcg.solve", None)]


def test_phong_staged_solve_records_its_tree(tmp_path):
    ds_sim = sim.generate_phong(num_states=6, num_points=60, seed=1)
    sim.write_phong_track_csv(ds_sim, str(tmp_path / "ph.csv"))
    ds = DatasetProblemPhong.read_csv(str(tmp_path / "ph.csv"))
    ds.device = "cpu"
    with telemetry.record():
        ds.compute_initial_guess()
        K = ds.num_states
        problem, state, slots = ds.build_window_problem(0, K, *ds._window_budget(K))
        sol, summaries = phong.solve_phong_staged(problem, state, lm.SolveConfig(max_iters=3),
                                                  multistage=True, lm_loop="host")
        ds.absorb_window_solution(0, K, sol, slots)
    assert len(summaries) == 3
    records = telemetry.spans()
    assert _tree(records) == [
        ("phong.ransac", "phong.initial_guess"), ("phong.initial_guess", None),
        ("phong.build_problem", None), ("phong.tables", "phong.stage"), ("phong.stage", None),
        ("phong.stage", None), ("phong.stage", None), ("phong.absorb", None)]
    stages = [r["attrs"] for r in records if r["name"] == "phong.stage"]
    assert stages == [dict(stage=0, use_light=False, freeze_geometry=False),
                      dict(stage=1, use_light=True, freeze_geometry=True),
                      dict(stage=2, use_light=True, freeze_geometry=False)]


def test_window_step_records_its_phases(triangle_csv):
    """A step of the batched window pass on the CPU (the host loop: no node
    span): the initial guess, the layout with its upload, the read, the
    absorb, under ``window.step``."""
    ds = DatasetProblemSun.read_csv(triangle_csv + ".csv", triangle_csv + "_sun_ref.csv",
                                    triangle_csv + "_sun_dir.csv")
    ds.device = "cpu"
    solver = batch_scan.BatchSolve([batch_scan.RunSpec(ds, use_sun=True)], window=2,
                                   config=lm.SolveConfig(max_iters=5))
    with telemetry.record():
        assert solver.step(0) == 1
    records = telemetry.spans()
    assert _tree(records) == [
        ("window.initial_guess", "window.step"), ("window.layout", "window.step"),
        ("window.read", "window.step"), ("window.absorb", "window.step"), ("window.step", None)]
    assert records[-1]["attrs"] == {"k1": 0}
