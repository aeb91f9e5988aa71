"""The CG loop that the card runs in a conditional WHILE node, on the CPU.

On CUDA, ``solver/pcg.pcg_solve`` captures ``pcg.cg_loop``'s body (one CG
iteration and the stop test, on state buffers) and runs it in a WHILE node
(``ops/graph_loop.DeviceWhile``); ``pcg.cg`` is its plain version, the
loop on the host. Here the body is iterated on the host while its
predicate holds, as the node does: it must give ``cg``'s bits and
iteration count, and JAX's ``pcg_solve`` (``lax.while_loop``) its count
and ``x`` to 1e-12 relative in float64 near the solution, with the block-Jacobi and the
banded preconditioners. The problems are the full batch of a 24-state
triangle sim from the VO initial guess, as ``dataset_vo --window 0``
builds it. The card's side (the capture, the node, K3's launch counts) is
in tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.problems.dataset import DatasetProblem as JDataset
from ceres_slam_tpu.solver import banded as jbanded
from ceres_slam_tpu.solver import pcg as jpcg
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.ops import full_batch_plan, graph_loop
from ceres_slam_tpu_torch.solver import banded, lm, pcg
from ceres_slam_tpu_torch.utils import sim

torch.set_num_threads(1)

LAM = 1e-3
# JAX's pcg_solve runs to this tolerance. CG amplifies rounding along the
# way (85 block-Jacobi iterations here): two packages' iterates agree only
# to ~1e-7 relative at tol 1e-6, and to ~1e-12 near the solution.
TOL = 1e-11
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sim24(tmp_path_factory):
    """The JAX package's full-batch problem of a 24-state triangle sim
    (``tests/test_torch_fullbatch.py``'s), from its VO initial guess."""
    path = str(tmp_path_factory.mktemp("sim24") / "tri_vo.csv")
    sim.write_track_csv(sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                                     stereo_noise=(0.3, 0.3, 0.3)), path, with_covar=False)
    jds = JDataset.read_csv(path)
    jds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = jds._window_budget(jds.num_states)
    problem, state, _ = jds.build_window_problem(0, jds.num_states, n_obs_pad, n_pts_pad)
    return problem, state


def _jax_system(problem, state, precond):
    """JAX's blocks (with the exact block-Jacobi diagonal ``S_diag``),
    right-hand side and ``pcg_solve`` at ``TOL`` (block-Jacobi, or the
    banded preconditioner with the tracks it builds)."""
    st = problem.stereo
    K, J = state.poses.shape[0], state.points.shape[0]
    tracks = None
    if precond == "banded":
        valid = np.asarray(st.valid & problem.point_valid[st.point_idx])
        tracks = jbanded.build_track_info(st.pose_idx, st.point_idx, K, J, valid=valid)

    @jax.jit
    def run(problem, state):
        b = jpcg.build_obs_blocks(problem, state, jnp.asarray(LAM), fused=False)
        y = jnp.einsum("jab,jb->ja", b.Cinv, b.gl)
        Uy = jax.ops.segment_sum(jpcg.u18_vec(b.U18, y[b.point_idx]), b.pose_idx,
                                 num_segments=K)
        rhs = -(b.gp - Uy)
        S_diag = jpcg.schur_diag_blocks(b)
        pre = (jpcg._block_precond(S_diag) if tracks is None
               else jbanded.make_banded_precond(b, tracks, K))
        x, iters = jpcg.pcg_solve(b, rhs, 200, TOL, precond=pre, kernel_ok=False)
        return b, rhs, x, S_diag, iters

    b, rhs, x, S_diag, iters = run(problem, state)
    return jax.tree.map(np.asarray, (b, rhs, x, S_diag)), int(iters), tracks


def _port_system(problem, state, jb, precond, tracks, dtype=torch.float64, path="segment",
                 S_diag=None, lam=LAM):
    """The port's matvec and preconditioner: on JAX's blocks (``segment``:
    the segment-sum matvec), or on the port's own blocks through the
    full-batch plan (``plan``: K3's plain version, the path the card runs).
    The block-Jacobi factors JAX's ``S_diag`` where one is given."""
    if path == "plan":
        p = convert.problem_from_numpy(jax.tree.map(np.asarray, problem))
        s = convert.state_from_numpy(jax.tree.map(np.asarray, state))
        p, s = _cast(p, dtype), _cast(s, dtype)
        b = pcg.build_obs_blocks(p, s, lam, plan=full_batch_plan.plan_for_problem(p))

        def matvec(v):
            return pcg.schur_matvec_plan(b, v)
    else:
        b = _cast(convert.obs_blocks_from_numpy(jb), dtype)

        def matvec(v):
            return pcg.schur_matvec(b, v)
    if precond == "banded":
        t = convert.track_info_from_numpy(jax.tree.map(np.asarray, tracks))
        pre = banded.make_banded_precond(b, t, b.Hpp.shape[0])
    else:
        pre = pcg._block_precond(pcg.schur_diag_blocks(b) if S_diag is None
                                 else torch.as_tensor(S_diag))
    return b, matvec, pre


def _cast(x, dtype):
    """A NamedTuple of tensors (nested) with its floating tensors in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_replace"):
        return x._replace(**{f: _cast(getattr(x, f), dtype) for f in x._fields})
    return x


def _iterate_on_host(lp):
    """The WHILE node's semantics on the host: test ``pred``, run the body."""
    while int(lp.pred[0]):
        lp.body()
    return lp.s.x, int(lp.i[0])


@pytest.mark.parametrize("path", ["segment", "plan"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_captured_body_equals_cg(sim24, precond, dtype, path):
    """``cg_loop``'s body, iterated while its predicate holds, gives ``cg``'s
    bits and iteration count, whatever the tolerance stops first."""
    problem, state = sim24
    (jb, jrhs, _, _), _, tracks = _jax_system(problem, state, precond)
    b, matvec, pre = _port_system(problem, state, jb, precond, tracks, dtype, path)
    rhs = torch.as_tensor(jrhs).to(dtype)
    for max_iters, tol in ((200, 1e-10), (3, 1e-10), (200, 1e-2)):
        x_ref, n_ref = pcg.cg(matvec, pre, rhs, max_iters, tol)
        x, n = _iterate_on_host(pcg.cg_loop(matvec, pre, rhs, max_iters, tol))
        assert n == n_ref > 0
        assert torch.equal(x, x_ref)


@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_restarted_loop_equals_cg(sim24, precond):
    """A solve's second LM iteration reuses the loop captured in its first
    (``pcg.CGGraph``): ``loop_inputs`` of the new blocks and factors are
    copied into the first's, ``restart`` takes the new right-hand side, and
    the body must give ``cg``'s bits on the new system (a tensor missing
    from ``loop_inputs`` would be read stale)."""
    problem, state = sim24
    (jb, jrhs, _, _), _, tracks = _jax_system(problem, state, precond)
    moved = state._replace(points=state.points + 1e-3 * jnp.asarray(
        np.random.default_rng(6).normal(size=state.points.shape)))
    systems = [_port_system(problem, s, jb, precond, tracks, path="plan", lam=lam)
               for s, lam in ((state, LAM), (moved, 10 * LAM))]
    rhs = [torch.as_tensor(jrhs), -systems[1][0].gp]
    (b1, matvec1, pre1), (b2, matvec2, pre2) = systems
    lp = pcg.cg_loop(matvec1, pre1, rhs[0], 200, 1e-10)
    _iterate_on_host(lp)
    pairs = list(zip(pcg.loop_inputs(b1, pre1), pcg.loop_inputs(b2, pre2)))
    assert all(dst.shape == src.shape for dst, src in pairs)
    assert sum(not torch.equal(dst, src) for dst, src in pairs) >= 4  # blocks and factors moved
    for dst, src in pairs:
        dst.copy_(src)
    lp.restart(rhs[1])
    x, n = _iterate_on_host(lp)
    x_ref, n_ref = pcg.cg(matvec2, pre2, rhs[1], 200, 1e-10)
    assert n == n_ref > 0 and torch.equal(x, x_ref)


@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_cg_loop_matches_jax(sim24, precond):
    """JAX's ``pcg_solve`` (its ``lax.while_loop``) on the same blocks,
    right-hand side and block-Jacobi diagonal: the same iteration count,
    ``x`` within 1e-12 relative (``|x - x_jax| <= 1e-12 |x_jax|``, float64;
    the banded factors are computed in each package)."""
    problem, state = sim24
    (jb, jrhs, jx, S_diag), jiters, tracks = _jax_system(problem, state, precond)
    _, matvec, pre = _port_system(problem, state, jb, precond, tracks, S_diag=S_diag)
    x, n = _iterate_on_host(pcg.cg_loop(matvec, pre, torch.as_tensor(jrhs), 200, TOL))
    assert n == jiters > 1
    assert np.linalg.norm(x.numpy() - jx) <= 1e-12 * np.linalg.norm(jx)


def test_loop_that_never_starts(sim24):
    """A start that already meets the test (or ``max_iters`` 0) runs the
    body zero times, as ``lax.while_loop`` and ``cg`` do: x stays 0."""
    problem, state = sim24
    (jb, jrhs, _, _), _, tracks = _jax_system(problem, state, "jacobi")
    _, matvec, pre = _port_system(problem, state, jb, "jacobi", tracks)
    rhs = torch.as_tensor(jrhs)
    for max_iters, tol in ((0, 1e-10), (200, 2.0)):
        lp = pcg.cg_loop(matvec, pre, rhs, max_iters, tol)
        assert int(lp.pred[0]) == 0
        x, n = _iterate_on_host(lp)
        assert n == pcg.cg(matvec, pre, rhs, max_iters, tol)[1] == 0
        assert not x.any()


def test_pcg_solve_loop_choice(sim24):
    """On the CPU ``pcg_solve`` runs ``cg`` (``loop="host"``, the default);
    the device loop raises there instead of falling back, as does an
    unknown loop."""
    problem, state = sim24
    (jb, jrhs, _, _), _, _ = _jax_system(problem, state, "jacobi")
    b = convert.obs_blocks_from_numpy(jb)
    rhs = torch.as_tensor(jrhs)
    x, n = pcg.pcg_solve(b, rhs, 200, 1e-10)
    x_host, n_host = pcg.pcg_solve(b, rhs, 200, 1e-10, loop="host")
    assert n == n_host and torch.equal(x, x_host)
    with pytest.raises(ValueError, match="device_cg runs on the card"):
        pcg.pcg_solve(b, rhs, 200, 1e-10, loop="device")
    with pytest.raises(ValueError, match="unknown CG loop"):
        pcg.pcg_solve(b, rhs, 200, 1e-10, loop="scan")


def test_device_while_refuses_the_cpu():
    """``DeviceWhile`` takes a predicate on the card only (no host
    fallback), one int32; building it never runs the body here."""
    ran = []
    with pytest.raises(ValueError, match="runs on the card"):
        graph_loop.DeviceWhile(lambda: ran.append(1), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="runs on the card"):
        pcg.device_cg(lambda v: v, lambda r: r, torch.ones(4, 6), 10, 1e-6)
    assert not ran
    assert graph_loop.MIN_CUDA == (12, 3)


def test_cholesky_apply_matches_cholesky_solve():
    """The preconditioners' two triangular solves (no host sync on CUDA)
    equal ``torch.cholesky_solve`` to rounding, with NaN factors passing
    NaN through (a rejected step)."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(9, 6, 6))
    S = torch.as_tensor(A @ A.transpose(0, 2, 1) + 6 * np.eye(6))
    b = torch.as_tensor(rng.normal(size=(9, 6)))
    L = lm._cholesky_or_nan(S)
    got = lm.cholesky_apply(L, b)
    ref = torch.cholesky_solve(b[..., None], L)[..., 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-13)
    bad = lm._cholesky_or_nan(-S)
    assert torch.isnan(lm.cholesky_apply(bad, b)).all()


def test_port_imports_no_jax():
    """The loop's modules and the probe import neither JAX nor the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['ceres_slam_tpu'] = None; "
            "import ceres_slam_tpu_torch.ops.graph_loop, ceres_slam_tpu_torch.solver.pcg, "
            "ceres_slam_tpu_torch.solver.loss, ceres_slam_tpu_torch.apps.probe_graph_loop")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
