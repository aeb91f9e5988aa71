"""The harness drives a tiny cell on the CPU with the timed path broken
underneath and sees ``correct`` come out false, once for each fault the cell
can have: a solve that returns its state unchanged (every solve, or one
Phong stage with the light alone), half of a batch of
windows left out, and an answer altered where it is produced (the poses,
the landmarks or vertices, the reported cost, the covariance that feeds the
next window). A sound run of the same cell is correct."""

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import tiny_spec
from ceres_slam_tpu_torch.solver import pcg, phong

FAULTS = ["unchanged", "poses", "points", "cost"]


def _stage(kw) -> str:
    """The Phong stage a ``solve_phong_ba`` call solves."""
    if not kw.get("use_light", True):
        return "geometry"
    return "lighting" if kw.get("freeze_geometry", False) else "joint"


def _broken(orig, kind):
    def solve(problem, state0, config, **kw):
        sol, summary = orig(problem, state0, config, **kw)
        if kind == "unchanged" or kind == f"unchanged_{_stage(kw)}":
            return state0, summary._replace(final_cost=summary.initial_cost)
        if kind.startswith("unchanged_"):
            return sol, summary
        if kind == "poses":
            poses = sol.poses.clone()
            poses[-1, 0] += 1e-3
            return sol._replace(poses=poses), summary
        if kind == "points":
            return sol._replace(points=sol.points + 1e-3), summary
        if kind == "cost":
            return sol, summary._replace(final_cost=summary.final_cost * (1 + 1e-6))
        raise ValueError(kind)
    return solve


CELLS = {"fullba": ("kitti1100", "fullba", pcg, "solve_ba_pcg"),
         "multistage": ("phong200", "multistage", phong, "solve_phong_ba")}


@pytest.mark.parametrize("kind", FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(search, monkeypatch, cell, kind):
    config, mix, module, fn = CELLS[cell]
    spec, name = tiny_spec(search, config, mix)
    monkeypatch.setattr(module, fn, _broken(getattr(module, fn), kind))
    result, compared = run.run_cell(spec, name, 11, 0.5, False, device="cpu")
    assert not result["correct"], compared


@pytest.mark.parametrize("stage", ["lighting", "joint"])
def test_one_phong_stage_unchanged_is_not_correct(search, monkeypatch, stage):
    """One stage with the light returns its start, the others are sound:
    the geometry stage's gradient cannot see it, the stage's drop does."""
    spec, name = tiny_spec(search, "phong200", "multistage")
    monkeypatch.setattr(phong, "solve_phong_ba", _broken(phong.solve_phong_ba, f"unchanged_{stage}"))
    result, compared = run.run_cell(spec, name, 11, 0.5, False, device="cpu")
    assert not result["correct"], compared
    assert [c for c in compared if c[1] > c[2]] == [["stage_drop_inv", float("inf"),
                                                     compared[3][2]]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(search, cell):
    config, mix, _, _ = CELLS[cell]
    spec, name = tiny_spec(search, config, mix)
    result, compared = run.run_cell(spec, name, 11, 0.5, False, device="cpu")
    assert result["correct"], compared


def _broken_window(orig, kind):
    def solve(layout, state0, *a, **k):
        state, stats, cov = orig(layout, state0, *a, **k)
        B = state.poses.shape[0]
        if kind == "unchanged":
            return state0, stats, cov
        if kind == "half":  # half of the batch left out: its windows keep their start
            keep = torch.arange(B) < B // 2
            poses = torch.where(keep[:, None, None], state.poses, state0.poses)
            points = torch.where(keep[:, None, None], state.points, state0.points)
            return state._replace(poses=poses, points=points), stats, cov
        if kind == "poses":
            poses = state.poses.clone()
            poses[:, -1, 0] += 1e-3
            return state._replace(poses=poses), stats, cov
        if kind == "covariance":
            return state, stats, cov * (1 + 1e-3)
        raise ValueError(kind)
    return solve


@pytest.mark.parametrize("kind", ["unchanged", "half", "poses", "covariance"])
def test_window_fault_is_not_correct(search, monkeypatch, kind):
    from ceres_slam_tpu_torch.solver import window

    spec, name = tiny_spec(search, "kitti1100", "window", scene=dict(num_states=30))
    monkeypatch.setattr(window, "solve_batch_with_covariance",
                        _broken_window(window.solve_batch_with_covariance, kind))
    result, compared = run.run_cell(spec, name, 11, 1.0, False, device="cpu")
    assert not result["correct"], compared


def test_window_sound_run_is_correct(search):
    spec, name = tiny_spec(search, "kitti1100", "window", scene=dict(num_states=30))
    result, compared = run.run_cell(spec, name, 11, 1.0, False, device="cpu")
    assert result["correct"], compared
