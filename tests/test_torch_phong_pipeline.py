"""Port parity: the Phong solves, the dataset pipeline, the CLI and the reports.

Held against tests/test_phong.py, tests/test_telemetry.py and
tests/test_apps.py::test_make_sim_phong_and_ba_phong_cli, at their sizes:
the K=3, J=40, M=2 problem of tests/test_torch_phong.py (numpy-seeded) and
``generate_phong(num_states=12, num_points=200)``. Both packages take the
same RANSAC hypotheses (the port draws JAX's threefry bits), so their
trajectories are the same up to rounding: each stage must take the same
number of LM iterations, its final cost within 1e-8 relative, and the
poses, map and lights within 1e-8 absolute (float64).
"""

import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps.dataset_ba_phong import main as jax_ba_phong
from ceres_slam_tpu.apps.make_sim import main as jax_make_sim
from ceres_slam_tpu.problems.dataset_phong import DatasetProblemPhong as JDatasetPhong
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import phong as jphong
from ceres_slam_tpu.solver import window as jwindow
from ceres_slam_tpu.utils import telemetry as jtelemetry
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import dataset_ba_phong, make_sim
from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
from ceres_slam_tpu_torch.solver import lm, phong, window
from ceres_slam_tpu_torch.utils import csvio, metrics, telemetry
from tests.test_torch_phong import _np, make_problem

import __graft_entry__ as ge

torch.set_num_threads(1)

COST_RTOL, POSE_ATOL = 1e-8, 1e-8


def _same_stages(got, ref):
    assert len(got) == len(ref)
    for s, r in zip(got, ref):
        assert s.iterations == int(r.iterations)
        np.testing.assert_allclose(s.final_cost, float(r.final_cost), rtol=COST_RTOL)


def test_staged_solve_matches_jax():
    """The 3-stage schedule on the dense solver (test_phong.py's
    test_multistage_schedule_runs problem shape)."""
    pj, sj = make_problem(4, False, noise=0.3)
    sol_j, sums_j = jphong.solve_phong_staged(pj, sj, jlm.SolveConfig(max_iters=40),
                                              multistage=True)
    sol_t, sums_t = phong.solve_phong_staged(convert.phong_problem_from_numpy(_np(pj)),
                                             convert.phong_state_from_numpy(_np(sj)),
                                             lm.SolveConfig(max_iters=40), multistage=True)
    _same_stages(sums_t, sums_j)
    for a, b in zip(sol_t, sol_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=POSE_ATOL)


@pytest.fixture(scope="module")
def phong12(tmp_path_factory):
    d = tmp_path_factory.mktemp("phong12")
    make_sim.main([str(d), "--kind", "phong", "--num-states", "12", "--num-points", "200"])
    return d


def test_make_sim_phong_matches_jax(phong12, tmp_path):
    """The copied generator writes the JAX CLI's files byte for byte."""
    jax_make_sim([str(tmp_path), "--kind", "phong", "--num-states", "12", "--num-points", "200"])
    for name in ("phong12.csv", "phong12_gt_poses.csv"):
        assert (tmp_path / name).read_bytes() == (phong12 / name).read_bytes(), name


def _read_rows(path):
    with open(path) as f:
        header = f.readline()
        return header, np.asarray([[float(x) for x in ln.split(",")] for ln in f if ln.strip()])


def test_cli_matches_jax(phong12, tmp_path, capsys):
    """make_sim --kind phong -> dataset_ba_phong --multistage, both apps:
    the same stages and the same poses, map and lights CSVs (full batch:
    auto picks the vertex-Schur solver)."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port_dir, jax_dir):
        d.mkdir()
        (d / "phong12.csv").write_bytes((phong12 / "phong12.csv").read_bytes())
    stats = dataset_ba_phong.main([str(port_dir / "phong12.csv"), "--multistage",
                                   "--device", "cpu"])
    jax_ba_phong([str(jax_dir / "phong12.csv"), "--multistage"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("stage")]
    assert len(lines) == 6 and lines[:3] == lines[3:]  # port's, then JAX's
    for suffix in ("_poses.csv", "_map.csv", "_lights.csv", "_initial_poses.csv",
                   "_initial_map.csv", "_initial_lights.csv"):
        h_t, a = _read_rows(port_dir / f"phong12{suffix}")
        h_j, b = _read_rows(jax_dir / f"phong12{suffix}")
        assert h_t == h_j and a.shape == b.shape, suffix
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL, err_msg=suffix)
    gt = csvio.read_poses_csv(str(phong12 / "phong12_gt_poses.csv"))
    assert metrics.ate_translation(csvio.read_poses_csv(stats["poses"]), gt) < 0.3
    assert stats["lm_iterations"] == sum(s["iterations"] for s in stats["stages"])


def test_windowed_pass_matches_jax(tmp_path):
    """The sliding-window pass (--window 5) over 8 states (4 windows; the
    dense solver): every window's solve, on padded per-window problems,
    against the JAX pass."""
    make_sim.main([str(tmp_path), "--kind", "phong", "--num-states", "8", "--num-points", "100",
                   "--seed", "7"])
    track = str(tmp_path / "phong8.csv")
    jd = JDatasetPhong.read_csv(track)
    sums_j = jd.solve_full(window=5, use_light=True)
    td = DatasetProblemPhong.read_csv(track)
    td.device = "cpu"
    assert td._window_budget(5) == jd._window_budget(5)
    sums_t = td.solve_full(window=5, use_light=True)
    _same_stages(sums_t, sums_j)
    np.testing.assert_allclose(td.poses, jd.poses, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(td.textures, jd.textures, rtol=0, atol=POSE_ATOL)
    np.testing.assert_array_equal(td.initialized_vertex, jd.initialized_vertex)


def test_dataset_phong_defaults_to_cuda(phong12):
    """Without a card the dataset's device raises, and the CLI exits:
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    td = DatasetProblemPhong.read_csv(str(phong12 / "phong12.csv"))
    assert td.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.precompute_pair_alignments()
    with pytest.raises(SystemExit, match="--device cuda"):
        dataset_ba_phong.main([str(phong12 / "phong12.csv")])


# -- the LM history and the reports (tests/test_telemetry.py) -------------------

def test_history_matches_jax():
    """record_history through the LM core (a dense Phong solve): the same
    per-iteration cost, lambda, gradient norm and accept decisions, NaN
    past the last iteration, and the reports' lines."""
    pj, sj = make_problem(6, False, noise=0.3)
    cfg = dict(max_iters=20, record_history=True)
    _, ref = jphong.solve_phong_ba(pj, sj, jlm.SolveConfig(**cfg))
    _, got = phong.solve_phong_ba(convert.phong_problem_from_numpy(_np(pj)),
                                  convert.phong_state_from_numpy(_np(sj)), lm.SolveConfig(**cfg))
    n = got.iterations
    assert n == int(ref.iterations) > 0
    for f in ("cost_history", "lambda_history", "grad_norm_history"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.shape == b.shape == (20,) and np.isnan(a[n:]).all(), f
        np.testing.assert_allclose(a[:n], b[:n], rtol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.step_accepted, np.asarray(ref.step_accepted))
    full = telemetry.full_report(got)
    assert full.count("\n") == jtelemetry.full_report(ref).count("\n") == n + 1
    assert "final cost" in telemetry.brief_report(got)


def test_stopwatch():
    sw = telemetry.Stopwatch()
    with sw.section("a", sync_value=torch.ones(2)):
        sum(range(1000))
    assert "a" in sw.report() and "total" in sw.report()


@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_window_loop_history_matches_jax(strategy):
    """record_history through the window solver's block-carrying loops
    (tests/test_telemetry.py::test_window_loop_history), against JAX's."""
    import jax.numpy as jnp

    problem, state = ge._build_example(K=4, J=32, n_obs=128, dtype=jnp.float64, seed=5)
    cfg = dict(max_iters=15, record_history=True, nonmonotonic=True)
    _, ref = jwindow.solve_ba_window(problem, state, jlm.SolveConfig(**cfg), strategy=strategy)
    _, got, _ = window.solve_ba_window_with_covariance(
        convert.problem_from_numpy(_np(problem)), convert.state_from_numpy(_np(state)), 1,
        lm.SolveConfig(**cfg), strategy=strategy)
    n = got.iterations
    assert n == int(ref.iterations) > 0
    for f, atol in (("cost_history", 0.0), ("lambda_history", 0.0),
                    ("grad_norm_history", 1e-10 * float(ref.grad_norm_history[0]))):
        # the gradient norm falls by orders of magnitude while its rounding
        # stays at the scale of the first one
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert np.isnan(a[n:]).all() and np.isfinite(a[:n]).all(), f
        np.testing.assert_allclose(a[:n], b[:n], rtol=1e-8, atol=atol, err_msg=f)
    np.testing.assert_array_equal(got.step_accepted[:n], np.asarray(ref.step_accepted)[:n])
    assert telemetry.full_report(got).count("\n") >= n


def test_report_full_cli(phong12, capsys):
    """--report full prints every stage's per-iteration table."""
    track = phong12 / "report" / "phong12.csv"
    track.parent.mkdir(exist_ok=True)
    track.write_bytes((phong12 / "phong12.csv").read_bytes())
    stats = dataset_ba_phong.main([str(track), "--report", "full", "--device", "cpu",
                                   "--nolight"])
    err = capsys.readouterr().err
    assert err.count(" it |        cost |") == len(stats["stages"]) == 1
    assert err.count("| yes") + err.count("| no") == stats["lm_iterations"]
