"""Port parity: the Lie-group completions, the Schur and dogleg solvers, the
covariance helpers and the ``FactorGraph`` API.

Inputs are seeded numpy arrays handed to both packages: the BA problems of
``__graft_entry__._build_example`` (sun, prior, Huber loss, started off
the optimum) and small stereo graphs built through both ``FactorGraph``s.
Tolerances are stated per test; every comparison is float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.models.stereo_camera import StereoCamera as JCamera
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import schur as jschur
from ceres_slam_tpu.solver.graph import FactorGraph as JFactorGraph
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import full_batch_plan, lie
from ceres_slam_tpu_torch.solver import dense, lm, pcg, schur
from ceres_slam_tpu_torch.solver.graph import FactorGraph

torch.set_num_threads(1)

CAM = (500.0, 500.0, 320.0, 240.0, 0.5)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _rel(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def ba():
    """A problem with sun, prior and Huber loss, off its optimum, in both packages."""
    problem, state = ge._build_example(K=6, J=48, n_obs=240, dtype=jnp.float64, seed=5)
    rng = np.random.default_rng(2)
    dx = np.concatenate([rng.normal(0, 0.01, 36), rng.normal(0, 0.05, 144)])
    state = jdense._retract_state(problem, state, jnp.asarray(dx))
    return (problem, state), (convert.problem_from_numpy(_np(problem)),
                              convert.state_from_numpy(_np(state)))


# -- the Lie-group completions -------------------------------------------------


def test_lie_completions_match_jax():
    """se3_identity, so3_left_jacobian (small angles too), so3_adjoint,
    so3_retract, se3_matrix / se3_from_matrix: 1e-14 relative."""
    rng = np.random.default_rng(0)
    phi = np.concatenate([rng.normal(0, 1.0, (8, 3)), rng.normal(0, 1e-9, (3, 3)), np.zeros((1, 3))])
    pairs = [
        (lie.se3_identity((2, 3)), jlie.se3_identity((2, 3))),
        (lie.so3_left_jacobian(torch.as_tensor(phi)), jlie.so3_left_jacobian(jnp.asarray(phi))),
    ]
    C = lie.so3_exp(torch.as_tensor(phi))
    pairs.append((lie.so3_adjoint(C), jlie.so3_adjoint(jnp.asarray(C.numpy()))))
    psi = rng.normal(0, 0.1, phi.shape)
    pairs.append((lie.so3_retract(C, torch.as_tensor(psi)),
                  jlie.so3_retract(jnp.asarray(C.numpy()), jnp.asarray(psi))))
    T = lie.se3_exp(torch.as_tensor(rng.normal(0, 1.0, (5, 6))))
    M = lie.se3_matrix(T)
    pairs.append((M, jlie.se3_matrix(jnp.asarray(T.numpy()))))
    pairs.append((lie.se3_from_matrix(M), T))
    for got, ref in pairs:
        assert got.shape == tuple(np.shape(ref))
        assert _rel(got.numpy(), ref) <= 1e-14


def test_quat_to_rot_matches_jax():
    """1e-14 relative on random quaternions (not unit); a zero quaternion
    gives a finite float32 matrix, as JAX's finfo.tiny guard does."""
    q = np.random.default_rng(1).normal(size=(16, 4))
    assert _rel(lie.quat_to_rot(torch.as_tensor(q)).numpy(), jlie.quat_to_rot(jnp.asarray(q))) <= 1e-14
    R = lie.quat_to_rot(torch.zeros((2, 4), dtype=torch.float32))
    assert R.dtype == torch.float32 and torch.isfinite(R).all()
    np.testing.assert_allclose(lie.quat_to_rot(torch.tensor([[0.0, 1.0, 0.0, 0.0]]))[0].numpy(),
                               np.diag([1.0, -1.0, -1.0]), atol=1e-15)


@pytest.mark.parametrize("case", ["drift", "random", "reflection"])
def test_normalize_matches_jax(case):
    """so3_normalize (SVD with the determinant's sign fixed) against JAX's
    closed-form nearest rotation: 1e-10 absolute (the bound of
    tests/test_lie.py's SVD comparison); a proper rotation; se3_normalize
    keeps the translation."""
    rng = np.random.default_rng(3)
    if case == "drift":
        W = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 1, (8, 3))))) + rng.normal(0, 1e-3, (8, 3, 3))
    elif case == "random":
        W = rng.normal(size=(30, 3, 3))
    else:
        W = np.diag([1.0, 1.0, -1.0])[None] + rng.normal(0, 1e-2, (4, 3, 3))
    R = lie.so3_normalize(torch.as_tensor(W)).numpy()
    np.testing.assert_allclose(R, np.asarray(jlie.so3_normalize(jnp.asarray(W))), atol=1e-10)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    T = np.concatenate([rng.normal(size=(W.shape[0], 3)), W.reshape(-1, 9)], axis=1)
    Tn = lie.se3_normalize(torch.as_tensor(T)).numpy()
    np.testing.assert_array_equal(Tn[:, :3], T[:, :3])
    np.testing.assert_allclose(Tn[:, 3:], np.asarray(jlie.se3_normalize(jnp.asarray(T)))[:, 3:],
                               atol=1e-10)


# -- Schur, dogleg, covariance --------------------------------------------------


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_schur_step_matches_jax_and_dense(ba, lam):
    """dx, grad_norm and the predicted decrease against JAX's schur_step
    (1e-9 relative), and dx against the port's dense damped step (1e-9
    relative): the elimination is exact."""
    (jp, js), (p, s) = ba
    dx, gn, pred = schur.schur_step(p, dense.ba_block_normal_equations(p, s), lam)
    jdx, jgn, jpred = jax.jit(jschur.schur_step)(jp, jax.jit(jdense.ba_block_normal_equations)(jp, js),
                                                 jnp.asarray(lam))
    assert _rel(dx.numpy(), jdx) <= 1e-9
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-12)
    np.testing.assert_allclose(float(pred), float(jpred), rtol=1e-9)
    ddx, dgn, dpred = lm.dense_cholesky_step(lambda st: dense.ba_normal_equations(p, st))(s, lam)
    assert _rel(dx.numpy(), ddx.numpy()) <= 1e-9
    np.testing.assert_allclose(float(pred), float(dpred), rtol=1e-9)


def test_solve_ba_schur_matches_jax(ba):
    """The same LM iterations and final cost to rtol 1e-9 as JAX's
    solve_ba_schur, and the dense solve's cost to rtol 1e-9."""
    (jp, js), (p, s) = ba
    cfg = dict(max_iters=50)
    sol, summ = schur.solve_ba_schur(p, s, lm.SolveConfig(**cfg))
    jsol, jsumm = jschur.solve_ba_schur(jp, js, jlm.SolveConfig(**cfg))
    assert summ.iterations == int(jsumm.iterations)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    np.testing.assert_allclose(sol.poses.numpy(), np.asarray(jsol.poses), atol=1e-8)
    _, dsumm = dense.solve_ba(p, s, lm.SolveConfig(**cfg))
    np.testing.assert_allclose(summ.final_cost, dsumm.final_cost, rtol=1e-9)


def test_dogleg_solve_matches_jax(ba):
    """solve_ba(strategy='dogleg'): the same iterations, final cost to rtol
    1e-9, final radius to rtol 1e-6 and poses to 1e-8 against JAX's
    dogleg_solve; it reaches LM's minimum (rtol 1e-6)."""
    (jp, js), (p, s) = ba
    sol, summ = dense.solve_ba(p, s, lm.SolveConfig(max_iters=100), strategy="dogleg")
    jsol, jsumm = jdense.solve_ba(jp, js, jlm.SolveConfig(max_iters=100), strategy="dogleg")
    assert summ.iterations == int(jsumm.iterations) > 1
    np.testing.assert_allclose(summ.initial_cost, float(jsumm.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    np.testing.assert_allclose(summ.final_lambda, float(jsumm.final_lambda), rtol=1e-6)
    np.testing.assert_allclose(sol.poses.numpy(), np.asarray(jsol.poses), atol=1e-8)
    _, lsumm = dense.solve_ba(p, s, lm.SolveConfig(max_iters=100))
    np.testing.assert_allclose(summ.final_cost, lsumm.final_cost, rtol=1e-6)
    with pytest.raises(ValueError, match="strategy"):
        dense.solve_ba(p, s, strategy="levenberg")


def test_dogleg_falls_back_to_the_gradient():
    """A normal matrix that is not positive definite: the Gauss-Newton step
    is not finite and the loop steps along -g, as JAX's does (same
    iterations, cost to rtol 1e-12)."""
    def cost(x):
        return 0.5 * torch.sum((x - 1.0) ** 2) if isinstance(x, torch.Tensor) else 0.5 * jnp.sum((x - 1.0) ** 2)

    def ne_t(x):
        return -torch.eye(3, dtype=x.dtype), x - 1.0

    def ne_j(x):
        return -jnp.eye(3), x - 1.0

    x0 = np.array([3.0, -2.0, 0.5])
    cfg = dict(max_iters=6)
    x, summ = lm.dogleg_solve(torch.as_tensor(x0), lm.SolveConfig(**cfg), cost, ne_t,
                              lambda x, d: x + d)
    jx, jsumm = jlm.dogleg_solve(jnp.asarray(x0), jlm.SolveConfig(**cfg), cost, ne_j,
                                 lambda x, d: x + d)
    assert summ.iterations == int(jsumm.iterations)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12)


def test_covariance_helpers_match_jax(ba):
    """_marginal_block at every pose, pose_tangent_covariance and
    solve_ba_with_covariance (solution and covariance) against JAX's:
    1e-9 relative."""
    (jp, js), (p, s) = ba
    H, _ = dense.ba_normal_equations(p, s)
    jH, _ = jax.jit(jdense.ba_normal_equations)(jp, js)
    for k in range(0, 6):
        assert _rel(dense._marginal_block(H, 6 * k).numpy(),
                    jdense._marginal_block(jH, jnp.asarray(6 * k))) <= 1e-9
    assert _rel(dense.pose_tangent_covariance(p, s, 3).numpy(),
                jdense.pose_tangent_covariance(jp, js, jnp.asarray(3))) <= 1e-9
    sol, summ, cov = dense.solve_ba_with_covariance(p, s, 2, lm.SolveConfig(max_iters=50))
    jsol, jsumm, jcov = jdense.solve_ba_with_covariance(jp, js, jnp.asarray(2),
                                                        jlm.SolveConfig(max_iters=50))
    assert summ.iterations == int(jsumm.iterations)
    assert _rel(cov.numpy(), jcov) <= 1e-9
    np.testing.assert_allclose(sol.poses.numpy(), np.asarray(jsol.poses), atol=1e-8)
    bad = dense._marginal_block(-torch.eye(12, dtype=torch.float64), 0)
    assert torch.isnan(bad).all()  # not positive definite: NaN, as the JAX Cholesky gives


# -- FactorGraph ---------------------------------------------------------------


def _graph_data(n_points=30, noise=0.2, seed=0, K=2, repeats=1, shuffle=False):
    """A stereo graph as numpy: poses (pose 0 the identity, held fixed),
    noisy landmarks and observations; landmark 0 is seen ``repeats`` times
    from every pose. Rows optionally shuffled."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((K, 6))
    xi[1:] = rng.normal(0, 0.1, (K - 1, 6)) + np.array([0.1, 0.0, -0.4, 0.0, 0.0, 0.0])
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    pts = rng.uniform([-4, -3, 5], [4, 3, 14], (n_points, 3))
    cam = JCamera.create(*CAM)
    obs = []
    for k in range(K):
        p_c = np.asarray(jlie.se3_transform_point(jnp.asarray(T_true[k]), jnp.asarray(pts)))
        uvd = np.asarray(cam.project(jnp.asarray(p_c)))
        for j in range(n_points):
            for _ in range(repeats if j == 0 else 1):
                obs.append((k, j, uvd[j] + rng.normal(0, noise, 3)))
    if shuffle:
        obs = [obs[i] for i in rng.permutation(len(obs))]
    T_init = np.asarray(jlie.se3_retract(jnp.asarray(T_true), jnp.asarray(
        np.where(np.arange(K)[:, None] == 0, 0.0, np.full((K, 6), 0.03)))))
    return T_init, T_true, pts + rng.normal(0, 0.2, pts.shape), obs, noise


def _graphs(data, **kw):
    """The same graph in both packages."""
    T_init, _, pts, obs, noise = data
    jg = JFactorGraph(JCamera.create(*CAM), default_stereo_var=(noise ** 2,) * 3)
    tg = FactorGraph(StereoCamera.create(*CAM), default_stereo_var=(noise ** 2,) * 3, device="cpu")
    for g in (jg, tg):
        for k, T in enumerate(T_init):
            g.add_pose(T, fixed=k == 0)
        for p in pts:
            g.add_point(p)
        for k, j, o in obs:
            g.add_stereo_obs(k, j, o, **kw)
    return jg, tg


@pytest.mark.parametrize("linear_solver,strategy",
                         [("dense", "lm"), ("schur", "lm"), ("pcg", "lm"), ("dense", "dogleg")])
def test_factor_graph_matches_jax(linear_solver, strategy):
    """As tests/test_graph.py: the second pose recovered to 0.01 and the
    cost decreased; against JAX's FactorGraph on the same graph: the same
    iterations, final cost rtol 1e-9, absorbed poses and points 1e-8."""
    data = _graph_data()
    jg, tg = _graphs(data)
    _, summ = tg.solve(linear_solver=linear_solver, strategy=strategy)
    _, jsumm = jg.solve(linear_solver=linear_solver, strategy=strategy)
    assert summ.final_cost < summ.initial_cost
    err = lie.se3_log(lie.se3_compose(torch.as_tensor(tg.pose(1)),
                                      lie.se3_inverse(torch.as_tensor(data[1][1]))))
    assert float(err.abs().max()) < 0.01
    assert summ.iterations == int(jsumm.iterations)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    for k in range(2):
        np.testing.assert_allclose(tg.pose(k), jg.pose(k), rtol=0, atol=1e-8)
    for j in range(len(data[2])):
        np.testing.assert_allclose(tg.point(j), jg.point(j), rtol=0, atol=1e-8)


def test_factor_graph_build_matches_jax():
    """build(): the padded problem (N to a multiple of 32, padding rows at
    pose 0 and landmark 0, invalid) and state equal JAX's, stiffness to
    1e-12 relative; per-observation covariances."""
    data = _graph_data(n_points=21)
    cov = np.diag([0.25, 0.3, 0.49])
    jg, tg = _graphs(data, covariance=cov)
    (p, s), (jp, js) = tg.build(), jg.build()
    ref = convert.problem_from_numpy(_np(jp))
    assert p.stereo.uvd.shape == (64, 3) and int(p.stereo.valid.sum()) == 42
    for name in ("uvd", "pose_idx", "point_idx", "valid"):
        np.testing.assert_array_equal(getattr(p.stereo, name).numpy(), getattr(ref.stereo, name).numpy())
    assert _rel(p.stereo.stiffness.numpy(), ref.stereo.stiffness.numpy()) <= 1e-12
    for name in ("fixed_pose_mask", "point_valid"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), getattr(ref, name).numpy())
    assert (p.prior.valid, p.sun_huber) == (ref.prior.valid, ref.sun_huber)
    np.testing.assert_array_equal(s.poses.numpy(), np.asarray(js.poses))
    np.testing.assert_array_equal(s.points.numpy(), np.asarray(js.points))
    with pytest.raises(RuntimeError, match="solve"):
        tg.covariance(1)
    with pytest.raises(ValueError, match="linear solver"):
        tg.solve(linear_solver="cholmod")


def test_factor_graph_covariance_matches_jax():
    """covariance(1) against JAX's to 1e-9 relative; more landmarks shrink
    it (tests/test_graph.py)."""
    traces = []
    for n in (10, 60):
        jg, tg = _graphs(_graph_data(n_points=n, seed=1))
        tg.solve()
        jg.solve()
        cov = tg.covariance(1)
        assert _rel(cov, jg.covariance(1)) <= 1e-9
        traces.append(np.trace(cov))
    assert traces[1] < traces[0]


def test_prior_and_constant_api():
    """tests/test_graph.py's prior/constant case: pose 0 made variable and
    held by a 1e-8 prior stays within 1e-3 of the identity; against JAX's
    on the same graph: final cost rtol 1e-9."""
    jg, tg = _graphs(_graph_data())
    for g in (jg, tg):
        g.set_pose_constant(0, False)
        g.add_pose_prior(0, g.pose(0), covariance=1e-8 * np.eye(6))
    _, summ = tg.solve()
    _, jsumm = jg.solve()
    assert float(lie.se3_log(torch.as_tensor(tg.pose(0))).abs().max()) < 1e-3
    assert summ.iterations == int(jsumm.iterations)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    np.testing.assert_allclose(tg.pose(0), jg.pose(0), rtol=0, atol=1e-8)


def test_pcg_on_shuffled_rows_with_a_long_track():
    """Rows in a shuffled order and landmark 0 seen by 160 observations
    (40 from each of 4 poses), solved by Schur-PCG through a full-batch
    plan on the CPU: the plan makes landmark 0 (164 slots with the
    padding rows) a group alone and the solve equals the planless one (cost rtol 1e-12,
    poses 1e-10) and JAX's pcg on the same graph (same iterations, cost
    rtol 1e-9)."""
    data = _graph_data(n_points=24, K=4, repeats=40, shuffle=True, seed=4)
    jg, tg = _graphs(data)
    problem, state = tg.build()
    plan = full_batch_plan.plan_for_problem(problem)
    starts = plan.pt_start.numpy()
    assert starts[1] - starts[0] == 164  # and the 4 padding rows at landmark 0
    groups = plan.lm_group.numpy()
    assert 0 in groups and 1 in groups  # landmark 0 alone in its group
    cfg = lm.SolveConfig(max_iters=100)
    sol, summ = pcg.solve_ba_pcg(problem, state, cfg, plan=plan)
    ref, rsumm = pcg.solve_ba_pcg(problem, state, cfg)
    assert summ.iterations == rsumm.iterations and summ.linear_iterations > 0
    np.testing.assert_allclose(summ.final_cost, rsumm.final_cost, rtol=1e-12)
    np.testing.assert_allclose(sol.poses.numpy(), ref.poses.numpy(), rtol=0, atol=1e-10)
    _, jsumm = jg.solve(linear_solver="pcg")
    assert summ.iterations == int(jsumm.iterations)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)


def test_factor_graph_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FactorGraph(StereoCamera.create(*CAM))


def _record_jax_figures(data: str):
    """The JAX FactorGraph figures that chip_smoke.py's graph phase holds the
    port to: the port's make_sim sims (triangle200 and kitti1100, seed 0,
    byte-identical to the JAX package's), read by the JAX dataset layer, its
    VO initial guess, the graph of DatasetProblem.factor_graph, and each
    solver's iterations and final cost (float64, on the CPU)."""
    import os
    import time

    from ceres_slam_tpu.problems.dataset import DatasetProblemSun as JDatasetSun
    from ceres_slam_tpu_torch.apps import make_sim
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem

    runs = (("triangle", 200, [("dense", "lm"), ("schur", "lm"), ("pcg", "lm"),
                               ("dense", "dogleg")]),
            ("kitti", 1100, [("pcg", "lm")]))
    for kind, n, solvers in runs:
        seq = f"{kind}{n}"
        base = os.path.join(data, seq)
        if not os.path.exists(base + ".csv"):
            make_sim.main([data, "--kind", kind, "--num-states", str(n), "--sun-noise", "10"])
        jds = JDatasetSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                   base + "_sun_dir_gtsun10.csv")
        jds.compute_initial_guess()
        for linear_solver, strategy in solvers:
            pg = DatasetProblem.factor_graph(jds, device="cpu")
            jg = JFactorGraph(jds.camera)
            for T, fixed in zip(pg._poses, pg._fixed):
                jg.add_pose(T, fixed)
            for p in pg._points:
                jg.add_point(p)
            for k, j, o, c in pg._stereo:
                jg.add_stereo_obs(k, j, o, covariance=c)
            t0 = time.perf_counter()
            _, summ = jg.solve(linear_solver=linear_solver, strategy=strategy)
            print(f"{seq} {linear_solver} {strategy}: {len(pg._stereo)} observations, "
                  f"{int(summ.iterations)} iterations, cost {float(summ.initial_cost)!r} -> "
                  f"{float(summ.final_cost)!r} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_graph.py DIR
    import sys

    jax.config.update("jax_enable_x64", True)
    _record_jax_figures(sys.argv[1])
