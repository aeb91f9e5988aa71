"""The full-batch LM loop that the card runs in a conditional WHILE node, on the CPU.

On CUDA, ``solver/pcg.solve_ba_pcg`` runs its LM loop as one WHILE node
(``lm.device_loop``): one LM iteration of ``lm.lm_body`` on the ``lm.Carry``
buffers, with the CG loop as a WHILE node nested in it (``pcg.inner_cg``
through ``graph_loop.while_loop``); ``lm.host_loop`` is its plain version,
the same body iterated on the host. Here:

- ``host_loop`` under ``solve_ba_pcg`` against the JAX package's
  ``solve_ba_pcg`` (``lax.while_loop`` around ``pcg_solve``'s) on the full
  batch of a 24-state triangle sim from its VO initial guess, as
  ``dataset_vo --window 0`` builds it: float64 and float32, nonmonotonic
  steps on and off, the history, ``run_full_budget``, ``max_iters=0``;
- the body as the node runs it (the CG loop on its fixed buffers, the
  predicates read on the host) against ``host_loop`` bit for bit, the CG
  iterations included, and restarted on another problem's
  ``lm_loop_inputs`` (a missing input would read the first problem's data);
- the switches: the device loop refuses the CPU, a combination of loops
  that cannot run raises, ``dataset_vo --lm-loop/--cg-loop``.

The card's side (the capture, the nested node, K2's and K3's counts, no
host work per iteration) is in tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.problems.dataset import DatasetProblem as JDataset
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import pcg as jpcg
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import dataset_vo
from ceres_slam_tpu_torch.ops import full_batch_plan, graph_loop
from ceres_slam_tpu_torch.solver import dense, lm, pcg
from ceres_slam_tpu_torch.utils import sim

torch.set_num_threads(1)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _f32(x):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, x)


@pytest.fixture(scope="module")
def vo_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm24") / "tri_vo.csv")
    sim.write_track_csv(sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                                     stereo_noise=(0.3, 0.3, 0.3)), path, with_covar=False)
    return path


@pytest.fixture(scope="module")
def sim24(vo_file):
    """The JAX package's full-batch problem of the sim from its VO initial
    guess, with the gather tables, as numpy."""
    jds = JDataset.read_csv(vo_file)
    jds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = jds._window_budget(jds.num_states)
    problem, state, _ = jds.build_window_problem(0, jds.num_states, n_obs_pad, n_pts_pad)
    st = problem.stereo
    tables = jpcg.build_obs_tables(st.pose_idx, st.point_idx, state.poses.shape[0],
                                   state.points.shape[0])
    return _np(problem), _np(state), _np(tables)


# the dataset_vo CLI's float64 configuration
CFG = dict(max_iters=50, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
CASES = {
    "f64": ("f64", CFG),
    "f64_monotonic_history": ("f64", dict(CFG, nonmonotonic=False, record_history=True)),
    "f64_full_budget": ("f64", dict(max_iters=6, run_full_budget=True, record_history=True)),
    "f64_no_iteration": ("f64", dict(CFG, max_iters=0)),
    "f32": ("f32", dict(CFG, record_history=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_loop_matches_jax(sim24, case):
    """``solve_ba_pcg`` with the LM loop on the host (the CPU's form; the
    plan path, K2's and K3's plain versions) against JAX's (block-Jacobi,
    its gather tables). float64: the same LM iterations and accept
    decisions, the initial and final costs rtol 1e-9, poses and points atol
    1e-8; the costs and damping per iteration rtol 1e-7 (CG stops at tol
    1e-6, where the two packages' steps agree only to ~1e-7 relative,
    tests/test_torch_graph_loop.py; the iterates meet again at the
    minimum), the damping but for the last iteration's (its rho divides two
    decreases at rounding level, so its update may take another branch of
    the rule). JAX's summary has no CG count: the port's is at least one a
    LM iteration. float32: costs rtol 1e-4, poses atol 1e-4 (meter-scale
    poses; float32 steps), points atol 1e-3; the iteration counts are not
    compared (near the minimum the accept test compares costs equal to
    float32 rounding)."""
    dtype, cfg = CASES[case]
    problem, state, tables = sim24
    if dtype == "f32":
        problem, state = _f32(problem), _f32(state)
    sol_j, sum_j = jpcg.solve_ba_pcg(problem, state, jlm.SolveConfig(**cfg), tables=tables,
                                     precond="jacobi")
    p, s = convert.problem_from_numpy(problem), convert.state_from_numpy(state)
    st = problem.stereo
    tt = convert.obs_tables_from_numpy(tables, st.pose_idx, st.point_idx)
    sol_t, sum_t = pcg.solve_ba_pcg(p, s, lm.SolveConfig(**cfg), tables=tt, precond="jacobi",
                                    plan=full_batch_plan.plan_for_problem(p))
    assert sol_t.poses.dtype == s.poses.dtype
    n = int(sum_j.iterations)
    rtol, pose_atol, point_atol = (1e-9, 1e-8, 1e-8) if dtype == "f64" else (1e-4, 1e-4, 1e-3)
    if dtype == "f64":
        assert sum_t.iterations == n
        assert case != "f64_full_budget" or n == 6
        assert case != "f64_no_iteration" or (n == 0 and sum_t.linear_iterations == 0)
    assert sum_t.linear_iterations >= sum_t.iterations
    np.testing.assert_allclose(sum_t.initial_cost, float(sum_j.initial_cost), rtol=rtol)
    np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=rtol)
    np.testing.assert_allclose(sol_t.poses.numpy(), np.asarray(sol_j.poses), rtol=0,
                               atol=pose_atol)
    np.testing.assert_allclose(sol_t.points.numpy(), np.asarray(sol_j.points), rtol=0,
                               atol=point_atol)
    if cfg.get("record_history"):
        m = sum_t.iterations
        for f in ("cost_history", "lambda_history", "grad_norm_history"):
            got = getattr(sum_t, f)
            assert got.shape == (cfg["max_iters"],) and np.isnan(got[m:]).all(), f
        if dtype == "f64":
            np.testing.assert_array_equal(sum_t.step_accepted, np.asarray(sum_j.step_accepted))
            np.testing.assert_allclose(sum_t.cost_history[:n],
                                       np.asarray(sum_j.cost_history)[:n], rtol=1e-7)
            np.testing.assert_allclose(sum_t.lambda_history[:n - 1],
                                       np.asarray(sum_j.lambda_history)[:n - 1], rtol=1e-7)


# -- the body as the node runs it ------------------------------------------------

def _example(seed):
    """A full-batch problem with sun, prior and Huber loss
    (``__graft_entry__._build_example``), started off its optimum, on the
    host; the port's tensors and the plan and gather tables."""
    problem, state = ge._build_example(K=8, J=64, n_obs=320, dtype=jnp.float64, seed=3)
    rng = np.random.default_rng(seed)
    dx = np.concatenate([rng.normal(0, 0.01, 48), rng.normal(0, 0.05, 192)])
    state = jdense._retract_state(problem, state, jnp.asarray(dx))
    return convert.problem_from_numpy(_np(problem)), convert.state_from_numpy(_np(state))


def _other(problem, state, seed=5):
    """Another problem of the same shape: the observations in another row
    order (so every table and the plan hold other indices), other
    measurements and masks, other sun and prior data and settings (the
    prior off), another gauge-fixed pose, another initial state."""
    rng = np.random.default_rng(seed)
    st = problem.stereo
    N = st.uvd.shape[0]
    perm = torch.as_tensor(rng.permutation(N))
    valid = st.valid[perm].clone()
    valid[::7] = False
    st = st._replace(uvd=st.uvd[perm] + torch.as_tensor(rng.normal(0, 0.3, (N, 3))),
                     stiffness=st.stiffness[perm] * 1.1, pose_idx=st.pose_idx[perm],
                     point_idx=st.point_idx[perm], valid=valid)
    sun = problem.sun
    sun = sun._replace(dir_c=sun.dir_c * 0.999, dir_g=sun.dir_g * 0.998,
                       stiffness=sun.stiffness * 1.2, valid=sun.valid & (torch.arange(8) != 3))
    prior = problem.prior._replace(T_ref=problem.prior.T_ref + 1e-3,
                                   stiffness=problem.prior.stiffness * 0.5, valid=False)
    fixed = problem.fixed_pose_mask.clone()
    fixed[2] = True
    point_valid = problem.point_valid.clone()
    point_valid[5] = False
    problem = problem._replace(stereo=st, sun=sun, prior=prior, fixed_pose_mask=fixed,
                               point_valid=point_valid, sun_huber=0.5 * problem.sun_huber,
                               az_err_thresh=0.9 * problem.az_err_thresh,
                               zen_err_thresh=0.8 * problem.zen_err_thresh)
    state = dense.BAState(state.poses + torch.as_tensor(rng.normal(0, 1e-3, state.poses.shape)),
                          state.points + torch.as_tensor(rng.normal(0, 0.02,
                                                                    state.points.shape)))
    return problem, state


def _parts(problem, state, precond, form):
    """``(inputs, cost, step, retract)`` of a full-batch LM loop on the CPU
    through the plan: ``form`` ``"node"`` (the CG loop on fixed buffers, the
    device loop's body) or ``"host"`` (``cg``)."""
    st = problem.stereo
    K, J = state.poses.shape[0], state.points.shape[0]
    tables = pcg.build_obs_tables(st.pose_idx, st.point_idx, K, J)
    plan = full_batch_plan.plan_for_problem(problem)
    tables, plan, tracks, terms = pcg.prepare(problem, state, tables, plan, precond)
    buffers = pcg.cg_buffers(state.poses.new_zeros((K, 6))) if form == "node" else None
    fns = pcg.lm_functions(problem, tables, plan, tracks, terms, 100, 1e-6, loop="host",
                           buffers=buffers)
    return (pcg.lm_loop_inputs(problem, state, terms, tables, plan, tracks), *fns)


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


LOOP_CFG = dict(max_iters=30, nonmonotonic=True, ftol=1e-10, xtol=1e-12, record_history=True)


@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_captured_body_equals_host_loop(precond):
    """``lm.lm_loop``'s body with the CG loop on its fixed buffers
    (``pcg.inner_cg``), iterated while its predicate holds, gives
    ``host_loop``'s bits with the host CG loop (``cg``): the state, every
    carry entry (the history, the best iterate, the CG iterations)."""
    problem, state = _example(11)
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem, state, precond, "host")
    ref = lm.host_loop(state, cfg, *host)
    _, *node = _parts(problem, state, precond, "node")
    lp = lm.lm_loop(state, cfg, *node)
    n = _iterate_on_host(lp)
    assert n == int(ref.it) > 2 and int(ref.linear_iterations) > n
    _equal(lp.carry, ref)
    (sa, ma), (sb, mb) = lm.finish(lp.carry, cfg), lm.finish(ref, cfg)
    _equal(sa, sb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)


def test_restarted_loop_equals_host_loop():
    """A loop built on one problem, restarted on another problem's
    ``lm_loop_inputs`` copied into its own (what an ``lm.LMGraph`` does for
    a later solve of a shape), gives ``host_loop``'s bits on the second
    problem: ``lm_loop_inputs`` misses no tensor the body reads. All but
    the structural inputs differ between the two problems (the tables'
    slot weights, the plan's segment offsets and groups, the tracks' bins:
    the counts by pose and by landmark, which a row order keeps); leaving
    the observations out of the copy gives other bits."""
    problem_a, state_a = _example(11)
    problem_b, state_b = _other(problem_a, state_a)
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem_b, state_b, "banded", "host")
    ref = lm.host_loop(state_b, cfg, *host)
    inputs_b, *_ = _parts(problem_b, state_b, "banded", "node")
    for left_out in (None, problem_b.stereo.uvd):
        problem_a, state_a = _example(11)
        inputs_a, *node = _parts(problem_a, state_a, "banded", "node")
        lp = lm.lm_loop(state_a, cfg, *node)
        _iterate_on_host(lp)
        assert [(t.shape, t.dtype) for t in inputs_a] == [(t.shape, t.dtype) for t in inputs_b]
        same = [i for i, (a, b) in enumerate(zip(inputs_a, inputs_b)) if torch.equal(a, b)]
        assert len(same) <= 14, same
        lm._copy_inputs(*zip(*[(a, b) for a, b in zip(inputs_a, inputs_b) if b is not left_out]))
        lp.restart()
        _iterate_on_host(lp)
        if left_out is None:
            _equal(lp.carry, ref)
        else:
            assert not torch.equal(lp.carry.state.poses, ref.state.poses)


# -- the switches ------------------------------------------------------------------

def test_loop_switches_on_the_cpu():
    """On the CPU both loops run on the host by default, and asking for
    either on the card raises (no fallback); the device LM loop with the
    host CG loop, an unknown loop, and an LMGraph for the host loop raise."""
    problem, state = _example(11)
    cfg = lm.SolveConfig(max_iters=4)
    a = pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi")
    b = pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", loop="host", lm_loop="host")
    _equal(a[0], b[0])
    assert a[1] == b[1]
    assert pcg.resolve_loops("cpu", None, None) == ("host", "host")
    assert pcg.resolve_loops("cuda", None, None) == ("device", "device")
    assert pcg.resolve_loops("cuda", "host", None) == ("host", "host")
    assert pcg.resolve_loops("cuda", None, "host") == ("device", "host")
    assert pcg.resolve_loops("cpu", None, "device") == ("device", "device")
    with pytest.raises(ValueError, match="runs on the card"):
        pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", lm_loop="device")
    with pytest.raises(ValueError, match="runs on the card"):
        pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", loop="device")
    with pytest.raises(ValueError, match="needs loop='device'"):
        pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", loop="host", lm_loop="device")
    with pytest.raises(ValueError, match="unknown LM loop"):
        pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", lm_loop="scan")
    with pytest.raises(ValueError, match="takes none"):
        pcg.solve_ba_pcg(problem, state, cfg, precond="jacobi", graph=lm.LMGraph())
    with pytest.raises(ValueError, match="unknown LM loop"):
        lm.lm_solve(state, cfg, *pcg.lm_functions(problem, *pcg.prepare(problem, state)),
                    loop="scan")


def test_while_loop_on_the_host_and_the_nesting_check(monkeypatch):
    """``graph_loop.while_loop`` outside a capture iterates its body on the
    host while ``pred`` holds; a nested loop needs CUDA 12.4 or newer in
    the toolkit, the driver and PyTorch's runtime, and says so."""
    pred, n = torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)

    def body():
        n.add_(1)
        pred.copy_(n < 7)

    graph_loop.while_loop(body, pred)
    assert int(n) == 7 and int(pred) == 0
    graph_loop.while_loop(body, pred)  # pred 0: no iteration
    assert int(n) == 7
    monkeypatch.setattr(graph_loop, "versions",
                        lambda: {"toolkit": (12, 3), "driver": (13, 0), "torch": (12, 8)})
    with pytest.raises(RuntimeError, match=r"12\.4 or newer \(nested conditional"):
        graph_loop.require(graph_loop.MIN_CUDA_NESTED, "a nested loop",
                           "nested conditional graph nodes")
    graph_loop.require(graph_loop.MIN_CUDA, "a loop", "conditional graph nodes")


def test_cli_loop_switches(vo_file, tmp_path):
    """``dataset_vo --window 0 --linear-solver pcg`` on the CPU: ``--lm-loop
    host --cg-loop host`` writes the default run's bytes (the host loops
    are the CPU's form); the device loops raise there, as does ``--lm-loop
    device --cg-loop host`` anywhere and either switch with the window
    solver; argparse refuses other values."""
    path = str(tmp_path / "tri_vo.csv")
    with open(vo_file) as src, open(path, "w") as dst:
        dst.write(src.read())
    argv = [path, "--window", "0", "--linear-solver", "pcg", "--device", "cpu",
            "--max-iters", "8"]
    stats = dataset_vo.main(argv)
    first = open(stats["poses"], "rb").read()
    again = dataset_vo.main(argv + ["--lm-loop", "host", "--cg-loop", "host"])
    assert open(again["poses"], "rb").read() == first
    assert (again["lm_iterations"], again["cg_iterations"]) == (stats["lm_iterations"],
                                                               stats["cg_iterations"])
    assert stats["lm_graph_captures"] == stats["lm_graph_restarts"] == 0
    for extra, match in ((["--lm-loop", "device"], "runs on the card"),
                         (["--cg-loop", "device"], "runs on the card"),
                         (["--lm-loop", "device", "--cg-loop", "host"], "needs loop='device'")):
        with pytest.raises(ValueError, match=match):
            dataset_vo.main(argv + extra)
    with pytest.raises(ValueError, match="takes neither"):
        dataset_vo.main([path, "--window", "0", "--linear-solver", "window", "--device", "cpu",
                         "--lm-loop", "host"])
    with pytest.raises(SystemExit):
        dataset_vo.main(argv + ["--lm-loop", "scan"])
    assert os.path.exists(stats["poses"])
