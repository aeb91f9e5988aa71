"""The dense-system LM loops that the card runs in conditional WHILE nodes, on the CPU.

On CUDA, ``solver/dense.solve_ba`` and ``solver/schur.solve_ba_schur`` run
their LM loops as one WHILE node each (``lm.device_loop`` through
``dense.minimize``), and ``apps/blowup.py`` runs its 999-step chain as one
WHILE node with each step's 2-pose LM loop nested in it (``lm.inner_lm``);
the host forms iterate the same bodies on the host. Here:

- the chain body iterated on the host (``chain_loop="host"``, the node's
  body) against the JAX app: every covariance and closed form to 1e-9
  relative;
- ``factors.chol_whiten`` (the capture-safe whitening of the chain's
  prior): ``S^T S`` against ``inv_sqrt_psd(C)^2`` (the port's and JAX's)
  and ``inv(C)`` to 1e-12 relative, NaN for a matrix that is not positive
  definite; ``dense._marginal_block`` by ``lm.cholesky_apply`` against
  JAX's to 1e-12; ``blocks_to_dense``'s strided writes against
  ``torch.block_diag``, bit for bit;
- the dense and Schur LM loops' body iterated as the node runs it against
  ``host_loop`` bit for bit (float64, float32), restarted on another
  problem's ``dense_loop_inputs`` (a missing input reads the first
  problem's data), and the host solves against JAX's ``solve_ba`` /
  ``solve_ba_schur`` at tests/test_torch_graph.py's tolerances;
- the switches: the device loops off the card, the dogleg with the device
  loop, ``cg_loop`` with the dense solver and a table build under a
  capture raise; ``dataset_vo --window 2 --linear-solver dense --lm-loop
  host`` on a 24-state sim within tests/test_torch_fullbatch.py's
  tolerance of the JAX app, every window's tables at the pass's widths.

The card's side (the captures, the restarts, no host work per step) is in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.apps import blowup as jblowup
from ceres_slam_tpu.apps import dataset_vo as jdataset_vo
from ceres_slam_tpu.ops import factors as jfactors
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import schur as jschur
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import blowup, dataset_vo
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors
from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
from ceres_slam_tpu_torch.solver import dense, lm, pose_graph, schur
from ceres_slam_tpu_torch.solver.graph import FactorGraph
from ceres_slam_tpu_torch.utils import csvio, sim

torch.set_num_threads(1)

LOOP_CFG = dict(max_iters=30, nonmonotonic=True, ftol=1e-10, xtol=1e-12, record_history=True)
SOLVERS = {"dense": dense.lm_functions, "schur": schur.lm_functions}


def _np(x):
    return jax.tree.map(np.asarray, x)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _example(seed=11):
    """A problem with sun, prior and Huber loss (``__graft_entry__.
    _build_example``, K 8, J 64, 320 observations), started off its
    optimum: the JAX one and the port's."""
    problem, state = ge._build_example(K=8, J=64, n_obs=320, dtype=jnp.float64, seed=3)
    rng = np.random.default_rng(seed)
    dx = np.concatenate([rng.normal(0, 0.01, 48), rng.normal(0, 0.05, 192)])
    state = jdense._retract_state(problem, state, jnp.asarray(dx))
    return (problem, state), (convert.problem_from_numpy(_np(problem)),
                              convert.state_from_numpy(_np(state)))


def _cast(x, dtype):
    return lm.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, x)


def _other(problem, state, seed=5):
    """Another problem of the same shape: the observations in another row
    order (other tables), other measurements and masks, other sun and
    prior data and settings (the prior off), another gauge-fixed pose,
    another initial state."""
    rng = np.random.default_rng(seed)
    st = problem.stereo
    N = st.uvd.shape[0]
    perm = torch.as_tensor(rng.permutation(N))
    valid = st.valid[perm].clone()
    valid[::7] = False
    st = st._replace(uvd=st.uvd[perm] + torch.as_tensor(rng.normal(0, 0.3, (N, 3))),
                     stiffness=st.stiffness[perm] * 1.1, pose_idx=st.pose_idx[perm],
                     point_idx=st.point_idx[perm], valid=valid)
    sun = problem.sun._replace(dir_c=problem.sun.dir_c * 0.999, stiffness=problem.sun.stiffness * 1.2,
                               valid=problem.sun.valid & (torch.arange(8) != 3))
    prior = problem.prior._replace(T_ref=problem.prior.T_ref + 1e-3, valid=False)
    fixed = problem.fixed_pose_mask.clone()
    fixed[2] = True
    point_valid = problem.point_valid.clone()
    point_valid[5] = False
    problem = problem._replace(stereo=st, sun=sun, prior=prior, fixed_pose_mask=fixed,
                               point_valid=point_valid, sun_huber=0.5 * problem.sun_huber,
                               az_err_thresh=0.9 * problem.az_err_thresh)
    state = dense.BAState(state.poses + torch.as_tensor(rng.normal(0, 1e-3, state.poses.shape)),
                          state.points + torch.as_tensor(rng.normal(0, 0.02, state.points.shape)))
    return problem, state


def _parts(problem, state, solver, widths=None):
    """``(inputs, cost, step, retract)`` of one solve's LM loop, its tables
    and terms made before the loop, as ``dense.minimize`` makes them."""
    tables = dense.block_tables(problem, widths)
    terms = dense.aux_terms(problem)
    return (dense.dense_loop_inputs(problem, state, terms, tables),
            *SOLVERS[solver](problem, tables, terms))


def _iterate_on_host(lp):
    """The WHILE node's semantics on the host: test ``pred``, run the body."""
    n = 0
    while int(lp.pred[0]):
        lp.body()
        n += 1
    return n


def _equal(a, b):
    for x, y in zip(lm.leaves(a), lm.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        assert torch.equal(torch.isnan(x), torch.isnan(y)) if x.is_floating_point() else True


# -- blowup's chain ------------------------------------------------------------------


def test_blowup_chain_matches_jax():
    """The chain's body iterated on the host (what the node runs, its LM
    loop on the host too) against the JAX app's ``lax.scan``: every step's
    solver and closed-form covariance to 1e-9 relative, the deviation from
    the closed form below 1e-6, each step's LM iterations within the
    budget; the stats count the steps and no capture."""
    covs, manuals, iters, stats = blowup.run_chain(30, device="cpu", chain_loop="host")
    jcovs, jmanuals, _ = jblowup.run(30, verbose=False)
    assert covs.shape == manuals.shape == (29, 6, 6)
    assert _rel(covs, jcovs) <= 1e-9 and _rel(manuals, jmanuals) <= 1e-9
    rel_err = np.abs(covs - manuals).max(axis=(1, 2)) / np.abs(manuals).max(axis=(1, 2))
    assert rel_err.max() < 1e-6
    assert iters.shape == (29,) and 0 < iters.min() and iters.max() <= 20
    assert stats["steps"] == 29 and stats["lm_iterations"] == iters.sum()
    assert stats["chain_loop"] == "host" and stats["captures"] == 0
    again, _, _ = blowup.run(30, verbose=False, device="cpu")  # the CPU's default: the host
    np.testing.assert_array_equal(again, covs)


@pytest.mark.parametrize("seed", [0, 1])
def test_chol_whiten_matches_inv_sqrt_psd(seed):
    """``chol_whiten(C)^T chol_whiten(C)`` against ``inv_sqrt_psd(C)^2`` (the
    port's and JAX's) and ``inv(C)``, 1e-12 relative, for seeded SPD
    covariances (f64) at the chain's scales; a matrix that is not positive
    definite gives NaN, not an exception."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(4, 6, 6))
    C = A @ A.transpose(0, 2, 1) + np.eye(6)
    C = np.concatenate([C, 1e-3 * C, 1e-12 * np.eye(6)[None]])
    S = factors.chol_whiten(torch.as_tensor(C))
    StS = (S.mT @ S).numpy()
    for ref in (factors.inv_sqrt_psd(torch.as_tensor(C)).numpy(),
                np.asarray(jfactors.inv_sqrt_psd(jnp.asarray(C)))):
        for a, r in zip(StS, ref @ ref):
            assert _rel(a, r) <= 1e-12
    for a, r in zip(StS, np.linalg.inv(C)):
        assert _rel(a, r) <= 1e-12
    assert np.all(np.triu(S.numpy(), 1) == 0.0)
    bad = factors.chol_whiten(torch.as_tensor(np.stack([-np.eye(6), C[0]])))
    assert torch.isnan(bad[0]).all() and torch.isfinite(bad[1]).all()


def test_marginal_block_and_block_writes():
    """``_marginal_block`` by ``cholesky_apply`` against JAX's on a seeded
    SPD H (f64, 1e-12 relative) at every pose; ``blocks_to_dense``'s
    strided writes of the diagonal blocks equal ``torch.block_diag``'s."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(30, 30))
    H = A @ A.T + 30 * np.eye(30)
    for base in range(0, 30, 6):
        assert _rel(dense._marginal_block(torch.as_tensor(H), base).numpy(),
                    jdense._marginal_block(jnp.asarray(H), jnp.asarray(base))) <= 1e-12
    K, J = 3, 5
    blocks = dense.BlockNormalEq(*(torch.as_tensor(rng.normal(size=s)) for s in (
        (K, 6, 6), (J, 3, 3), (K, J, 6, 3), (K, 6), (J, 3))))
    H, _ = dense.blocks_to_dense(blocks)
    assert torch.equal(H[:6 * K, :6 * K], torch.block_diag(*blocks.Hpp))
    assert torch.equal(H[6 * K:, 6 * K:], torch.block_diag(*blocks.Hll))


# -- the dense and Schur LM loops -------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_captured_body_equals_host_loop(solver, dtype):
    """``lm.lm_loop``'s body with the dense or Schur functions, iterated
    while its predicate holds, gives ``host_loop``'s bits: every carry
    entry (the history, the best iterate) and ``finish``'s summary."""
    _, (problem, state) = _example()
    problem, state = _cast(problem, dtype), _cast(state, dtype)
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem, state, solver)
    ref = lm.host_loop(state, cfg, *host)
    _, *node = _parts(problem, state, solver)
    lp = lm.lm_loop(state, cfg, *node)
    n = _iterate_on_host(lp)
    assert n == int(ref.it) >= 3
    _equal(lp.carry, ref)
    (sa, ma), (sb, mb) = lm.finish(lp.carry, cfg), lm.finish(ref, cfg)
    _equal(sa, sb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)
    assert ma.final_cost < ma.initial_cost


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_restarted_loop_equals_host_loop(solver):
    """A loop built on one problem, restarted on another problem's
    ``dense_loop_inputs`` copied into its own (what an ``lm.LMGraph`` does
    for a later window of a pass: both tables at common widths), gives
    ``host_loop``'s bits on the second problem: the inputs miss no tensor
    the body reads. Leaving the observations out of the copy gives other
    bits."""
    _, (problem_a, state_a) = _example()
    problem_b, state_b = _other(problem_a, state_a)
    widths = tuple(max(a.shape[1], b.shape[1]) for a, b in zip(
        dense.block_tables(problem_a), dense.block_tables(problem_b)))
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem_b, state_b, solver, widths)
    ref = lm.host_loop(state_b, cfg, *host)
    inputs_b, *_ = _parts(problem_b, state_b, solver, widths)
    for left_out in (None, problem_b.stereo.uvd):
        _, (problem_a, state_a) = _example()
        inputs_a, *node = _parts(problem_a, state_a, solver, widths)
        lp = lm.lm_loop(state_a, cfg, *node)
        _iterate_on_host(lp)
        assert [(t.shape, t.dtype) for t in inputs_a] == [(t.shape, t.dtype) for t in inputs_b]
        same = [i for i, (a, b) in enumerate(zip(inputs_a, inputs_b)) if torch.equal(a, b)]
        assert len(same) <= 4, same
        lm._copy_inputs(*zip(*[(a, b) for a, b in zip(inputs_a, inputs_b) if b is not left_out]))
        lp.restart()
        _iterate_on_host(lp)
        if left_out is None:
            _equal(lp.carry, ref)
        else:
            assert not torch.equal(lp.carry.state.poses, ref.state.poses)


def test_host_solves_match_jax():
    """``dense.solve_ba`` and ``schur.solve_ba_schur`` (the host loop, the
    CPU's default, through the tables and terms) against JAX's: the same
    iterations, final cost rtol 1e-9, poses atol 1e-8
    (tests/test_torch_graph.py's tolerances); both reach one minimum."""
    (jp, js), (p, s) = _example()
    cfg = dict(max_iters=50)
    out = {"dense": dense.solve_ba(p, s, lm.SolveConfig(**cfg)),
           "schur": schur.solve_ba_schur(p, s, lm.SolveConfig(**cfg), lm_loop="host")}
    ref = {"dense": jdense.solve_ba(jp, js, jlm.SolveConfig(**cfg)),
           "schur": jschur.solve_ba_schur(jp, js, jlm.SolveConfig(**cfg))}
    for name, (sol, summ) in out.items():
        jsol, jsumm = ref[name]
        assert summ.iterations == int(jsumm.iterations) > 1
        np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
        np.testing.assert_allclose(sol.poses.numpy(), np.asarray(jsol.poses), atol=1e-8)
    np.testing.assert_allclose(out["dense"][1].final_cost, out["schur"][1].final_cost, rtol=1e-9)


# -- the switches -----------------------------------------------------------------


def test_loop_switches(monkeypatch):
    """On the CPU every loop runs on the host by default (the dense and
    Schur solves, the pose graph, blowup's chain); the device loops raise
    there (no fallback), as do the dogleg with the device loop, an
    LMGraph for the host loop, ``cg_loop`` with the dense and Schur
    solvers, an unknown loop and a table build under a capture."""
    _, (p, s) = _example()
    cfg = lm.SolveConfig(max_iters=3)
    a = dense.solve_ba(p, s, cfg)
    b = dense.solve_ba(p, s, cfg, lm_loop="host")
    _equal(a[0], b[0])
    assert a[1] == b[1]
    for solve in (dense.solve_ba, schur.solve_ba_schur):
        with pytest.raises(ValueError, match="runs on the card"):
            solve(p, s, cfg, lm_loop="device")
        with pytest.raises(ValueError, match="takes none"):
            solve(p, s, cfg, lm_loop="host", graph=lm.LMGraph())
        with pytest.raises(ValueError, match="unknown LM loop"):
            solve(p, s, cfg, lm_loop="scan")
    with pytest.raises(ValueError, match="dogleg"):
        dense.solve_ba(p, s, cfg, strategy="dogleg", lm_loop="device")
    with pytest.raises(ValueError, match="runs on the card"):
        blowup.run(3, verbose=False, device="cpu", chain_loop="device")
    with pytest.raises(ValueError, match="runs on the card"):
        blowup.main(["--num-poses", "3", "--device", "cpu", "--chain-loop", "device"])
    with pytest.raises(ValueError, match="unknown chain loop"):
        blowup.run_chain(3, device="cpu", chain_loop="scan")
    eye = torch.eye(6, dtype=torch.float64)[None]
    T = torch.cat([torch.zeros(3), torch.eye(3).reshape(9)]).to(torch.float64)[None]
    one, yes = torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.bool)
    pg = pose_graph.PoseGraphProblem(pose_graph.RelPoseFactors(one, one + 1, T, eye, yes),
                                     pose_graph.PriorFactors(one, T, eye, yes),
                                     torch.zeros(2, dtype=torch.bool))
    sol, summ = pose_graph.solve_pose_graph(pg, T.expand(2, 12), cfg)
    assert torch.equal(sol, pose_graph.solve_pose_graph(pg, T.expand(2, 12), cfg, lm_loop="host")[0])
    with pytest.raises(ValueError, match="runs on the card"):
        pose_graph.solve_pose_graph(pg, T.expand(2, 12), cfg, lm_loop="device")
    g = FactorGraph(StereoCamera.create(400.0, 400.0, 320.0, 240.0, 0.5), device="cpu")
    g.add_pose(np.concatenate([np.zeros(3), np.eye(3).reshape(9)]), fixed=True)
    with pytest.raises(ValueError, match="dogleg"):
        g.solve(linear_solver="dense", strategy="dogleg", lm_loop="device")
    for solver in ("dense", "schur"):
        with pytest.raises(ValueError, match="runs on the card"):
            g.solve(linear_solver=solver, lm_loop="device")
        with pytest.raises(ValueError, match="cg_loop"):
            g.solve(linear_solver=solver, cg_loop="host")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for build in (lambda: dense.block_tables(p), lambda: dense.solve_ba(p, s, cfg)):
        with pytest.raises(RuntimeError, match="captured loop cannot"):
            build()


def test_cli_dense_window_pass_matches_jax(tmp_path):
    """``dataset_vo --window 2 --linear-solver dense --lm-loop host`` on a
    24-state triangle sim (tests/test_torch_fullbatch.py's) against the
    JAX app: ``_poses.csv`` to atol 1e-6 (tests/test_torch_fullbatch.py's
    tolerance); ``--lm-loop device`` and ``--cg-loop`` raise here. Every
    window's tables at the pass's widths (``_dense_widths``) have those
    widths: one shape, one capture a pass on the card."""
    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3))
    paths = {}
    for name in ("jax", "host"):
        os.makedirs(tmp_path / name)
        paths[name] = str(tmp_path / name / "tri_vo.csv")
        sim.write_track_csv(ds, paths[name], with_covar=False)
    argv = ["--window", "2", "--linear-solver", "dense"]
    jdataset_vo.main([paths["jax"], *argv])
    stats = dataset_vo.main([paths["host"], *argv, "--device", "cpu", "--lm-loop", "host"])
    poses = csvio.read_poses_csv(stats["poses"])
    assert stats["windows"] == 23 and poses.shape == (24, 12)
    np.testing.assert_allclose(poses, csvio.read_poses_csv(paths["jax"][:-4] + "_poses.csv"),
                               rtol=0, atol=1e-6)
    assert stats["lm_graph_captures"] == stats["lm_graph_restarts"] == 0
    for extra, match in ((["--lm-loop", "device"], "runs on the card"),
                         (["--cg-loop", "host"], "takes none")):
        with pytest.raises(ValueError, match=match):
            dataset_vo.main([paths["host"], *argv, "--device", "cpu", *extra])
    td = DatasetProblem.read_csv(paths["host"])
    td.device = "cpu"
    td.precompute_pair_alignments()
    widths = td._dense_widths(2)
    budget = td._window_budget(2)[:2]
    for k1 in range(0, 23, 4):
        td.compute_initial_guess(k1, k1 + 2)
        problem, _, _ = td.build_window_problem(k1, k1 + 2, *budget, gauge_fix_first=True)
        assert int(dense.stereo_valid(problem).sum()) > 0
        assert tuple(t.shape[1] for t in dense.block_tables(problem, widths)) == widths
