"""Port parity: the relative-pose factor, the pose-graph solver and the
covariance blow-up experiment.

Poses and measurements are seeded numpy arrays handed to both packages
(``convert.pose_graph_problem_from_numpy``); every comparison is float64
with its tolerance stated in the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import blowup as jblowup
from ceres_slam_tpu.ops import factors as jfactors
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import pose_graph as jpg
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import blowup
from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import lm, pose_graph

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _poses(xi):
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


@pytest.mark.parametrize("angle", ["random", "near_pi"])
def test_relative_pose_matches_jax(angle):
    """Residual and both tangent Jacobians, whitened, against JAX's
    relative_pose: 1e-12 x max|ref| (float64 rounding), with residual
    rotations near pi too."""
    rng = np.random.default_rng(7)
    n = 16
    T1 = _poses(rng.normal(0, 1.0, (n, 6)))
    T2 = _poses(rng.normal(0, 1.0, (n, 6)))
    if angle == "random":
        T_ref = _poses(rng.normal(0, 0.5, (n, 6)))
    else:  # T_ref = exp(psi) T_2_1^-1 with |psi| just below pi: the residual's rotation is ~pi
        T_21 = np.asarray(jlie.se3_compose(jnp.asarray(T1), jlie.se3_inverse(jnp.asarray(T2))))
        axis = rng.normal(size=(n, 3))
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        psi = np.concatenate([rng.normal(0, 0.1, (n, 3)), (np.pi - 1e-3) * axis], axis=1)
        T_ref = np.asarray(jlie.se3_compose(jlie.se3_exp(jnp.asarray(psi)),
                                            jlie.se3_inverse(jnp.asarray(T_21))))
    A = rng.normal(0, 0.3, (n, 6, 6))
    S = 3.0 * np.eye(6) + A + A.transpose(0, 2, 1)
    got = factors.relative_pose(*(torch.as_tensor(x) for x in (T1, T2, T_ref, S)))
    ref = jfactors.relative_pose(*(jnp.asarray(x) for x in (T1, T2, T_ref, S)))
    if angle == "near_pi":
        assert np.abs(np.asarray(ref[0])[:, 3:]).max() > 2.0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g.numpy(), r) <= 1e-12


def _graph(K=6, seed=0, extra=()):
    """A chain with noisy odometry, two priors (one invalid), an invalid
    edge, pose 2 fixed, plus ``extra`` edges (i, j); numpy, as the JAX
    containers take them."""
    rng = np.random.default_rng(seed)
    T = _poses(rng.normal(0, 0.3, (K, 6)))
    edges = [(k, k + 1) for k in range(K - 1)] + list(extra)
    i1, i2 = np.array([e[0] for e in edges]), np.array([e[1] for e in edges])
    meas = np.asarray(jlie.se3_retract(jlie.se3_compose(jnp.asarray(T[i2]),
                                                        jlie.se3_inverse(jnp.asarray(T[i1]))),
                                       jnp.asarray(rng.normal(0, 0.02, (len(edges), 6)))))
    A = rng.normal(0, 0.2, (len(edges), 6, 6))
    valid = np.ones(len(edges), bool)
    valid[1] = False
    rel = jpg.RelPoseFactors(idx1=jnp.asarray(i1, jnp.int32), idx2=jnp.asarray(i2, jnp.int32),
                             T_ref=jnp.asarray(meas),
                             stiffness=jnp.asarray(5.0 * np.eye(6) + A + A.transpose(0, 2, 1)),
                             valid=jnp.asarray(valid))
    priors = jpg.PriorFactors(idx=jnp.asarray([0, 3], jnp.int32), T_ref=jnp.asarray(T[[0, 3]]),
                              stiffness=jnp.asarray(np.stack([100.0 * np.eye(6)] * 2)),
                              valid=jnp.asarray([True, False]))
    fixed = np.zeros(K, bool)
    fixed[2] = True
    problem = jpg.PoseGraphProblem(rel=rel, priors=priors, fixed_pose_mask=jnp.asarray(fixed))
    init = np.asarray(jlie.se3_retract(jnp.asarray(T), jnp.asarray(rng.normal(0, 0.05, (K, 6)))))
    return problem, init


def _ported(problem):
    return convert.pose_graph_problem_from_numpy(jax.tree.map(np.asarray, problem))


@pytest.mark.parametrize("extra", [(), ((1, 2), (2, 1), (3, 5), (3, 5), (4, 4))],
                         ids=["chain", "repeated_and_reversed_edges"])
def test_normal_equations_match_jax(extra):
    """H and g against JAX's segment-sum and scatter assembly (1e-12 x
    max|ref|) on a graph with a repeated edge (3, 5) twice, a reversed pair
    (1, 2) / (2, 1), a self-edge, an invalid edge and prior, and a fixed
    pose; the cost to rtol 1e-12; two builds give the same bits."""
    problem, poses = _graph(extra=extra)
    p, x = _ported(problem), torch.as_tensor(poses)
    tables = pose_graph.pose_graph_tables(p)
    H, g = pose_graph.pose_graph_normal_equations(p, x, tables)
    jH, jg = jax.jit(jpg.pose_graph_normal_equations)(problem, jnp.asarray(poses))
    assert _rel(H.numpy(), jH) <= 1e-12 and _rel(g.numpy(), jg) <= 1e-12
    H2, g2 = pose_graph.pose_graph_normal_equations(p, x)
    assert torch.equal(H, H2) and torch.equal(g, g2)
    np.testing.assert_allclose(float(pose_graph.pose_graph_cost(p, x)),
                               float(jpg.pose_graph_cost(problem, jnp.asarray(poses))), rtol=1e-12)


def test_solve_and_covariance_match_jax():
    """solve_pose_graph and pose_graph_covariance on the repeated-edge
    graph: the same LM iterations, final cost rtol 1e-9, poses 1e-9, every
    pose's covariance 1e-9 relative."""
    problem, poses = _graph(extra=((1, 2), (2, 1), (3, 5), (3, 5)))
    p = _ported(problem)
    cfg = dict(max_iters=50)
    sol, summ = pose_graph.solve_pose_graph(p, torch.as_tensor(poses), lm.SolveConfig(**cfg))
    jsol, jsumm = jpg.solve_pose_graph(problem, jnp.asarray(poses), jlm.SolveConfig(**cfg))
    assert summ.iterations == int(jsumm.iterations) > 1
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    np.testing.assert_allclose(sol.numpy(), np.asarray(jsol), rtol=0, atol=1e-9)
    for k in range(6):
        assert _rel(pose_graph.pose_graph_covariance(p, sol, k).numpy(),
                    jpg.pose_graph_covariance(problem, jsol, jnp.asarray(k))) <= 1e-9


def test_relative_pose_chain_recovers_trajectory():
    """tests/test_pose_graph.py's 5-pose chain: exact odometry and a prior
    on pose 0 recover the trajectory (cost < 1e-12, pose error < 1e-5),
    from the same seeded start as JAX's run, which it equals to 1e-9."""
    K = 5
    step = jnp.array([0.1, 0.02, -0.3, 0.02, 0.05, 0.01])
    gt = [jlie.se3_identity()]
    for _ in range(K - 1):
        gt.append(jlie.se3_compose(jlie.se3_exp(step), gt[-1]))
    gt = jnp.stack(gt)
    problem = jpg.PoseGraphProblem(
        rel=jpg.RelPoseFactors(idx1=jnp.arange(K - 1, dtype=jnp.int32),
                               idx2=jnp.arange(1, K, dtype=jnp.int32),
                               T_ref=jnp.tile(jlie.se3_exp(step), (K - 1, 1)),
                               stiffness=jnp.broadcast_to(10.0 * jnp.eye(6), (K - 1, 6, 6)),
                               valid=jnp.ones(K - 1, bool)),
        priors=jpg.PriorFactors(idx=jnp.zeros(1, jnp.int32), T_ref=gt[:1],
                                stiffness=1e3 * jnp.eye(6)[None], valid=jnp.ones(1, bool)),
        fixed_pose_mask=jnp.zeros(K, bool))
    init = jlie.se3_retract(gt, 0.05 * jax.random.normal(jax.random.PRNGKey(0), (K, 6),
                                                         dtype=jnp.float64))
    sol, summ = pose_graph.solve_pose_graph(_ported(problem), torch.as_tensor(np.asarray(init)),
                                            lm.SolveConfig(max_iters=50))
    assert summ.final_cost < 1e-12
    err = lie.se3_log(lie.se3_compose(sol, lie.se3_inverse(torch.as_tensor(np.asarray(gt)))))
    assert float(err.abs().max()) < 1e-5
    jsol, _ = jpg.solve_pose_graph(problem, init, jlm.SolveConfig(max_iters=50))
    np.testing.assert_allclose(sol.numpy(), np.asarray(jsol), rtol=0, atol=1e-9)


def test_blowup_matches_jax():
    """blowup.run(60) against the JAX app's: every step's solver and
    closed-form covariance to 1e-9 relative; the deviation from the closed
    form below 1e-6 (tests/test_pose_graph.py) and the covariance growing
    50x along the chain."""
    covs, manuals, rel_err = blowup.run(60, verbose=False, device="cpu")
    jcovs, jmanuals, _ = jblowup.run(60, verbose=False)
    assert covs.shape == (59, 6, 6)
    assert _rel(covs, jcovs) <= 1e-9 and _rel(manuals, jmanuals) <= 1e-9
    assert rel_err.max() < 1e-6
    assert np.trace(covs[-1]) > np.trace(covs[0]) * 50


def test_blowup_cli(capsys):
    blowup.main(["--num-poses", "10", "--device", "cpu"])
    assert "max relative deviation" in capsys.readouterr().out


def test_blowup_cli_cuda_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        blowup.main(["--num-poses", "3"])


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_pose_graph.py
    # the JAX app's max relative deviation from the closed form over
    # chip_smoke.py's 1000-pose chain (float64, on the CPU)
    jax.config.update("jax_enable_x64", True)
    print(f"blowup 1000: {float(jblowup.run(1000, verbose=False)[2].max())!r}")
