"""Port parity: the LM core, the dense solve, full-batch Schur-PCG BA, the
masked-row trap and the ``dataset_vo`` CLI.

Problems come from ``__graft_entry__._build_example`` (seeded numpy) and
reach both packages as the same numpy arrays; the CLI runs both apps on
one 24-state triangle sim.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.apps import dataset_vo as jdataset_vo
from ceres_slam_tpu.problems.dataset import DatasetProblem as JDataset
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import pcg as jpcg
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import dataset_vo
from ceres_slam_tpu_torch.ops import full_batch_plan
from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
from ceres_slam_tpu_torch.solver import dense, lm, pcg
from ceres_slam_tpu_torch.utils import csvio, sim

torch.set_num_threads(1)

K, J, N_OBS = 8, 64, 320
# the dataset_vo CLI's float64 configuration
CFG = dict(max_iters=50, nonmonotonic=True, ftol=1e-6, xtol=1e-6)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _perturbed(K=K, J=J, n_obs=N_OBS, seed=3):
    """A problem with sun, prior and Huber loss, started off its optimum."""
    problem, state = ge._build_example(K=K, J=J, n_obs=n_obs, dtype=jnp.float64, seed=seed)
    rng = np.random.default_rng(11)
    dx = np.concatenate([rng.normal(0, 0.01, 6 * K), rng.normal(0, 0.05, 3 * J)])
    return problem, jdense._retract_state(problem, state, jnp.asarray(dx))


def _poisoned():
    """Half the landmarks invalid and at the origin, pose 0 at the origin
    and held fixed: the rows from pose 0 to those landmarks have z = 0."""
    problem, state = _perturbed()
    bad = np.zeros(J, bool)
    bad[::2] = True
    pts, poses = np.array(state.points), np.array(state.poses)
    pts[bad] = 0.0
    poses[0, :3] = 0.0
    problem = problem._replace(point_valid=jnp.asarray(~bad),
                               fixed_pose_mask=jnp.zeros(K, bool).at[0].set(True))
    return problem, state._replace(points=jnp.asarray(pts), poses=jnp.asarray(poses))


def _ported(problem, state):
    return convert.problem_from_numpy(_np(problem)), convert.state_from_numpy(_np(state))


def _same_solve(got, ref, cost_rtol=1e-9, pose_atol=1e-8):
    (s_t, sum_t), (s_j, sum_j) = got, ref
    assert sum_t.iterations == int(sum_j.iterations)
    np.testing.assert_allclose(sum_t.initial_cost, float(sum_j.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=cost_rtol)
    np.testing.assert_allclose(s_t.poses.numpy(), np.asarray(s_j.poses), rtol=0, atol=pose_atol)
    assert sum_t.final_cost < sum_t.initial_cost


# -- the LM core ---------------------------------------------------------------


@pytest.mark.parametrize("nan_steps", [0, 2], ids=["uphill", "nan_step"])
def test_lm_solve_scripted_matches_jax(nan_steps):
    """Scripted 1-D descents through ``lm_solve`` in both packages: costs
    100 -> 10 -> 50 -> 1e-8 (tests/test_solver.py's regression: the uphill
    step is accepted against max(recent) and must not fire ftol), with the
    first ``nan_steps`` steps non-finite (a failed solve is a rejected
    step, lambda x4, not convergence). Iterations, final cost and final
    lambda equal."""
    costs = [100.0, 10.0, 50.0, 1e-8]
    # the steps from the start are non-finite until lambda has grown x4 nan_steps times
    lam_ok = 1e-4 * 4.0 ** nan_steps * 0.999
    cfg = dict(max_iters=10, nonmonotonic=True, ftol=1e-9, gtol=0.0)

    def jcost(x):
        return jnp.asarray(costs)[jnp.clip(jnp.round(x[0]).astype(jnp.int32), 0, 3)]

    def jstep(x, lam):
        dx = jnp.where((lam < lam_ok) & (x[0] == 0), jnp.nan, 1.0) * jnp.ones(1)
        return dx, jnp.asarray(1.0), jnp.asarray(1.0)

    _, s_j = jlm.lm_solve(jnp.zeros(1), jlm.SolveConfig(**cfg), jcost, jstep, lambda x, dx: x + dx)

    f64 = torch.float64
    table = torch.tensor(costs, dtype=f64)

    def cost(x):
        return table[min(max(round(float(x[0])), 0), 3)]

    def step(x, lam):
        dx = torch.full((1,), float("nan") if lam < lam_ok and x[0] == 0 else 1.0, dtype=f64)
        return dx, torch.tensor(1.0, dtype=f64), torch.tensor(1.0, dtype=f64)

    _, s_t = lm.lm_solve(torch.zeros(1, dtype=f64), lm.SolveConfig(**cfg), cost, step,
                         lambda x, dx: x + dx)
    assert s_t.iterations == int(s_j.iterations)
    assert s_t.final_cost == float(s_j.final_cost) <= 1e-6
    np.testing.assert_allclose(s_t.final_lambda, float(s_j.final_lambda), rtol=1e-12)


# -- the dense solve -----------------------------------------------------------


def test_normal_equations_match_jax():
    """The dense tangent normal equations: atol 1e-12 x the largest entry."""
    problem, state = _perturbed()
    H_r, g_r = jax.jit(jdense.ba_normal_equations)(problem, state)
    H, g = dense.ba_normal_equations(*_ported(problem, state))
    for a, r in ((H, H_r), (g, g_r)):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("nonmonotonic", [False, True])
def test_dense_solve_ba_matches_jax(nonmonotonic):
    """``dense.solve_ba`` against JAX's: the same iteration count, final
    cost rtol 1e-9, poses atol 1e-8 (both take the same accept decisions,
    so only rounding separates the iterates)."""
    problem, state = _perturbed(K=4, J=32, n_obs=128)
    cfg = dict(CFG, nonmonotonic=nonmonotonic)
    ref = jdense.solve_ba(problem, state, jlm.SolveConfig(**cfg))
    _same_solve(dense.solve_ba(*_ported(problem, state), lm.SolveConfig(**cfg)), ref)


# -- full-batch Schur-PCG ------------------------------------------------------


@pytest.mark.parametrize("precond,path", [("jacobi", "segment"), ("banded", "tables"),
                                          ("jacobi", "plan")],
                         ids=["jacobi-segment", "banded-tables", "jacobi-plan"])
def test_solve_ba_pcg_matches_jax(precond, path):
    """``solve_ba_pcg`` against JAX's on the CPU (the gather-table path, and
    the plan path that runs K2's and K3's plain versions, against JAX's
    gather-table solve): the same LM iteration count, final cost rtol
    1e-9, poses atol 1e-8."""
    problem, state = _perturbed()
    st = problem.stereo
    tables = jpcg.build_obs_tables(st.pose_idx, st.point_idx, K, J) if path != "segment" else None
    ref = jpcg.solve_ba_pcg(problem, state, jlm.SolveConfig(**CFG), tables=tables,
                            precond=precond)
    p, s = _ported(problem, state)
    tt = convert.obs_tables_from_numpy(_np(tables), st.pose_idx, st.point_idx) \
        if tables is not None else None
    plan = full_batch_plan.plan_for_problem(p) if path == "plan" else None
    got = pcg.solve_ba_pcg(p, s, lm.SolveConfig(**CFG), tables=tt, precond=precond, plan=plan)
    _same_solve(got, ref)
    assert got[1].linear_iterations >= got[1].iterations


# -- masked rows at depth 0 (ROADMAP F9) ---------------------------------------


def test_poisoned_rows_stay_finite():
    """Uninitialized landmarks at the origin seen from a pose at the origin
    (z = 0) are masked rows with non-finite residuals. Eagerly, ``r * 0``
    of such a row is NaN, so the port masks with ``torch.where``: its cost
    equals JAX's (finite there too) and its dense normal equations stay
    finite, where JAX's are not (its product with the mask keeps the NaN);
    the full-batch PCG solve matches JAX's."""
    problem, state = _poisoned()
    p, s = _ported(problem, state)
    st = p.stereo
    p_c = s.poses[st.pose_idx][:, 3:].reshape(-1, 3, 3) @ s.points[st.point_idx][..., None]
    z = p_c[:, 2, 0] + s.poses[st.pose_idx][:, 2]
    assert torch.any((z == 0) & ~dense.stereo_valid(p))
    cost = dense.ba_cost(p, s)
    assert torch.isfinite(cost)
    np.testing.assert_allclose(cost.item(), float(jax.jit(jdense.ba_cost)(problem, state)),
                               rtol=1e-12)
    r = torch.stack([s.points[st.point_idx][:, 0] / z] * 3, dim=-1)  # the trap itself
    assert torch.isnan(torch.sum(r * r * dense.stereo_valid(p).to(r.dtype)[:, None]))
    H, g = dense.ba_normal_equations(p, s)
    assert torch.isfinite(H).all() and torch.isfinite(g).all()
    assert not np.all(np.isfinite(np.asarray(jax.jit(jdense.ba_normal_equations)(problem, state)[0])))
    ref = jpcg.solve_ba_pcg(problem, state, jlm.SolveConfig(**CFG), precond="jacobi")
    _same_solve(pcg.solve_ba_pcg(p, s, lm.SolveConfig(**CFG), precond="jacobi"), ref)


# -- the dataset layer and the CLI ---------------------------------------------


@pytest.fixture(scope="module")
def vo_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("vo")
    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3))
    path = str(d / "tri_vo.csv")
    sim.write_track_csv(ds, path, with_covar=False)
    return path


def test_read_csv_matches_jax(vo_file):
    jd, td = JDataset.read_csv(vo_file), DatasetProblem.read_csv(vo_file)
    assert (td.num_states, td.num_points, td._match_pad) == (jd.num_states, jd.num_points,
                                                           jd._match_pad)
    assert td.camera == type(td.camera).create(*jd.camera)
    for f in ("_T0", "state_ids", "point_ids", "obs_list", "obs_covars", "_pts_c",
              "_stiffness_all"):
        np.testing.assert_allclose(getattr(td, f), getattr(jd, f), rtol=1e-14, err_msg=f)


@pytest.mark.parametrize("Kw,n_pts", [(2, 100), (24, 448), (128, 2000), (200, 448)])
def test_auto_linear_solver_matches_jax(Kw, n_pts):
    assert DatasetProblem.auto_linear_solver(Kw, n_pts) == JDataset.auto_linear_solver(Kw, n_pts)


def _map_rows(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("argv", [["--window", "0", "--linear-solver", "pcg"], ["--window", "2"]],
                         ids=["full_batch_pcg", "window2"])
def test_cli_matches_jax(vo_file, tmp_path, argv):
    """Both ``dataset_vo`` apps, float64: the same ``_poses.csv`` to atol
    1e-6 and the same ``_map.csv`` rows (ids equal, coordinates atol 1e-6).
    Both draw the same RANSAC hypotheses; in float64 the tolerance is 1e-6
    whichever count the float32 rule would read."""
    paths = {}
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        paths[name] = str(tmp_path / name / "tri_vo.csv")
        with open(vo_file) as src, open(paths[name], "w") as dst:
            dst.write(src.read())
    jdataset_vo.main([paths["jax"], *argv])
    stats = dataset_vo.main([paths["port"], *argv, "--device", "cpu"])
    base = {k: v[:-4] for k, v in paths.items()}
    assert stats["poses"] == base["port"] + "_poses.csv"
    poses = csvio.read_poses_csv(stats["poses"])
    assert poses.shape == (24, 12) and np.all(np.isfinite(poses))
    np.testing.assert_allclose(poses, csvio.read_poses_csv(base["jax"] + "_poses.csv"),
                               rtol=0, atol=1e-6)
    # both pipelines reset the landmarks after every window, before the map
    # is written, so both maps hold the header only (ROADMAP F10)
    m_t, m_j = _map_rows(stats["map"]), _map_rows(base["jax"] + "_map.csv")
    assert m_t.shape == m_j.shape
    np.testing.assert_array_equal(m_t[:, :1], m_j[:, :1])
    np.testing.assert_allclose(m_t[:, 1:], m_j[:, 1:], rtol=0, atol=1e-6)
    if "pcg" in argv:
        assert stats["windows"] == 1 and stats["cg_iterations"] >= stats["lm_iterations"] > 0
    else:
        assert stats["windows"] == 23 and stats["cg_iterations"] == 0


def test_dataset_defaults_to_cuda(vo_file):
    """``DatasetProblem`` runs on ``cuda`` unless told otherwise, and raises
    at its first device step without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ds = DatasetProblem.read_csv(vo_file)
    assert ds.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.compute_initial_guess()


def test_cli_cuda_without_card_fails(vo_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        dataset_vo.main([vo_file])
