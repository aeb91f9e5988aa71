"""Port parity: the window layout, the K1 factor pass and the window solver.

Inputs come from ``__graft_entry__._build_example`` (seeded numpy) and
reach both packages as the same numpy arrays (``ceres_slam_tpu_torch.convert``).
On the CPU, K1's wrapper runs its plain PyTorch version; the CUDA kernel
is held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.ops import pallas_kernels
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import window as jwindow
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.ops import window_kernel
from ceres_slam_tpu_torch.solver import dense, dogleg, lm, window

torch.set_num_threads(1)

K, J, N_OBS = 8, 64, 320


def _masked(problem):
    """Gauge-fixed first pose and two invalid landmarks."""
    return problem._replace(
        fixed_pose_mask=jnp.zeros(K, bool).at[0].set(True),
        point_valid=jnp.ones(J, bool).at[5].set(False).at[63].set(False),
    )


@pytest.fixture(scope="module", params=["plain", "masked"])
def case(request):
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
    if request.param == "masked":
        problem = _masked(problem)
    return problem, state


def _np(x):
    return jax.tree.map(np.asarray, x)


def _ported(problem, state, layout=None):
    layout = layout if layout is not None else jwindow.build_window_layout(problem, K, J)
    return convert.layout_from_numpy(_np(layout)), convert.state_from_numpy(_np(state))


def _close(a, ref, scale):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=0, atol=scale * max(np.abs(ref).max(), 1e-300))


def test_layout_matches_jax(case):
    problem, state = case
    lj = jwindow.build_window_layout(problem, K, J)
    lt = window.build_window_layout(convert.problem_from_numpy(_np(problem)), K, J)
    ref = convert.layout_from_numpy(_np(lj))
    assert lt.O == ref.O
    for f in ("slot_pose", "w_idx"):
        assert torch.equal(getattr(lt, f), getattr(ref, f)), f
    for f in ("obs", "pose_idx", "pose_order", "pose_start", "ticket"):
        assert torch.equal(getattr(lt.plan, f), getattr(ref.plan, f)), f
    M = J * lt.O
    for name, cols, jf in (("uvd", slice(0, 3), lj.uvdT), ("stiffness", slice(3, 12), lj.stiffT),
                           ("weight", slice(12, 13), lj.weightT),
                           ("pose_free", slice(13, 14), lj.pose_freeT)):
        np.testing.assert_array_equal(lt.plan.obs[:, cols].numpy(), np.asarray(jf)[:, :M].T,
                                      err_msg=name)
    for f in ("uvd", "stiffness", "pose_idx", "point_idx", "valid"):
        a, b = getattr(lt.problem.stereo, f), np.asarray(getattr(lj.problem.stereo, f))
        np.testing.assert_array_equal(a.numpy(), b)


# K1 cases beyond ``case``: the flagship window shape (K=2, J=192, O=2), a
# small S-scale window and a ragged O = 3, each with padding slots (~6% of
# the observations invalid), a fixed first pose and two invalid landmarks.
K1_SHAPES = {"flagship": (2, 192, 2), "small_S": (16, 256, 4), "ragged": (5, 77, 3)}


@pytest.fixture(scope="module", params=["plain", "masked", *K1_SHAPES])
def k1_case(request):
    """``(problem, state, K, J)`` for the K1 parity tests."""
    if request.param in ("plain", "masked"):
        problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
        return (_masked(problem) if request.param == "masked" else problem), state, K, J
    k, j, o = K1_SHAPES[request.param]
    problem, state = ge._build_example(K=k, J=j, n_obs=j * o, dtype=jnp.float64, seed=5)
    rng = np.random.default_rng(6)
    st = problem.stereo
    problem = problem._replace(
        stereo=st._replace(valid=jnp.asarray(rng.random(j * o) > 0.06)),
        fixed_pose_mask=jnp.zeros(k, bool).at[0].set(True),
        point_valid=jnp.ones(j, bool).at[3].set(False).at[j - 1].set(False))
    return problem, state, k, j


def test_k1_plain_matches_pallas_f32(k1_case):
    """K1's plain version against the Pallas kernel in interpret mode, in
    float32, the Pallas per-slot landmark outputs summed over each
    landmark's O slots and its per-pose costs summed. Tolerances as
    tests/test_window.py holds the Pallas kernel to the XLA assembly: f32
    accumulation-order noise, relative to the largest entry — 1e-5 for the
    Gram blocks, 5e-3 for the gradients (zero-mean residuals cancel in
    them), rtol 1e-4 for the cost."""
    problem, state, k, j = k1_case
    f32 = lambda x: x.astype(jnp.float32) if hasattr(x, "dtype") and x.dtype == jnp.float64 else x
    problem32, state32 = jax.tree.map(f32, problem), jax.tree.map(f32, state)
    lj = jwindow.build_window_layout(problem32, k, j)
    O = lj.O
    M = j * O
    pT = jnp.pad(jnp.repeat(state32.points.T, O, axis=1), ((0, 0), (0, lj.onehotT.shape[1] - M)))
    ref = pallas_kernels.window_factor_blocks(
        problem32.camera, state32.poses.T, lj.onehotT, pT, lj.uvdT, lj.stiffT, lj.weightT,
        lj.pose_freeT, interpret=True)
    lt, st = _ported(problem32, state32, lj)
    out = window_kernel.window_factor_blocks_plain(lt.plan, st.poses, st.points)
    hll, u, gl, hppgp = (np.asarray(x, np.float64) for x in ref)
    assert [tuple(x.shape) for x in out] == [(j, 9), (M, 18), (j, 3), (k, 43), ()]
    _close(out[0], hll[:, :M].T.reshape(j, O, 9).sum(1), 1e-5)
    _close(out[1], u[:, :M].T, 1e-5)
    _close(out[2], gl[:, :M].T.reshape(j, O, 3).sum(1), 5e-3)
    _close(out[3][:, :36], hppgp[:36].T, 1e-5)
    _close(out[3][:, 36:42], hppgp[36:42].T, 5e-3)
    np.testing.assert_allclose(out[3][:, 42].numpy(), hppgp[42], rtol=1e-4, atol=1e-4 * hppgp[42].max())
    np.testing.assert_allclose(out[4].item(), hppgp[42].sum(), rtol=1e-4)


def test_k1_plain_matches_xla_blocks_f64(k1_case):
    """K1's plain version (via the solver's views) against the JAX float64
    block assembly ``_xla_blocks``: atol 1e-10 x the largest entry
    (summation order is the only difference)."""
    problem, state, k, j = k1_case
    lj = jwindow.build_window_layout(problem, k, j)
    ref = jwindow._xla_blocks(lj, state)
    lt, st = _ported(problem, state, lj)
    out = window.factor_blocks(lt, st)
    for f in ("Hpp", "Hll", "U_jo", "gp", "gl", "stereo_cost"):
        _close(getattr(out, f), getattr(ref, f), 1e-10)


def test_pose_order_lists_every_slot_once(k1_case):
    """The plan's pose order: every non-padding slot exactly once, sorted by
    pose (slot order within a pose), no padding slot, ``pose_start``
    delimiting each pose's run, and the records and landmarks the kernel
    reads in that order."""
    problem, _, k, j = k1_case
    plan = window.build_window_layout(convert.problem_from_numpy(_np(problem)), k, j).plan
    pose_idx = plan.pose_idx.numpy()
    order, start = plan.pose_order.numpy(), plan.pose_start.numpy()
    assert (pose_idx < 0).any() == (plan.O * j > int(np.asarray(problem.stereo.valid).sum()))
    np.testing.assert_array_equal(np.sort(order), np.nonzero(pose_idx >= 0)[0])
    assert start[0] == 0 and start[-1] == order.size and start.size == k + 1
    for kk in range(k):
        run = order[start[kk]:start[kk + 1]]
        assert np.all(pose_idx[run] == kk) and np.all(np.diff(run) > 0)
    assert torch.equal(plan.obs_by_pose, plan.obs[plan.pose_order.long()])
    np.testing.assert_array_equal(plan.point_by_pose.numpy(), order // plan.O)
    assert plan.ticket.numpy().tolist() == [0]


def test_k1_depth_guard_on_padding_slots():
    """Padding slots at z = 0 (pose 0 at the origin, an unobserved landmark
    at the origin: window 0 of the kitti sims) contribute nothing, since
    the port guards the depth as the Pallas kernel does. The JAX XLA
    assembly has no guard and returns a NaN cost there (ROADMAP F8)."""
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
    st = problem.stereo
    problem = problem._replace(stereo=st._replace(valid=st.valid & (st.point_idx != 63)))
    poses = state.poses.at[0, :3].set(0.0)
    at_origin = state._replace(poses=poses, points=state.points.at[63].set(0.0))
    moved = state._replace(poses=poses, points=state.points.at[63].set(1.0))
    lj = jwindow.build_window_layout(problem, K, J)
    assert np.isnan(float(jwindow._xla_blocks(lj, at_origin).stereo_cost))  # the JAX divergence
    lt, s0 = _ported(problem, at_origin, lj)
    _, s1 = _ported(problem, moved, lj)
    b0, b1 = window.factor_blocks(lt, s0), window.factor_blocks(lt, s1)
    for f in b0._fields:
        assert torch.equal(getattr(b0, f), getattr(b1, f)), f
    _close(b0.stereo_cost, jwindow._xla_blocks(lj, moved).stereo_cost, 1e-10)


def test_k1_wrapper_checks_and_dispatch(case):
    """CPU plans take the plain version (no launch counted); a call checks
    its poses and points (shape, dtype, device, contiguity) and the plan
    its fixed inputs, once."""
    problem, state = case
    lt, st = _ported(problem, state)
    plan = lt.plan
    launches = window_kernel.window_factor_blocks.launches
    for a, b in zip(window_kernel.window_factor_blocks(plan, st.poses, st.points),
                    window_kernel.window_factor_blocks_plain(plan, st.poses, st.points)):
        assert torch.equal(a, b)
    assert window_kernel.window_factor_blocks.launches == launches
    bad = [
        (st.poses.float(), st.points, "dtype"),
        (st.poses[:-1], st.points, "shape"),
        (st.poses, st.points.T.contiguous().T, "contiguous"),
        (st.poses.to("meta"), st.points, "is on"),
    ]
    for poses, points, what in bad:
        with pytest.raises(ValueError, match=what):
            window_kernel.window_factor_blocks(plan, poses, points)
    M = J * plan.O
    good = dict(camera=plan.camera, K=K, J=J, pose_idx=plan.pose_idx.numpy(),
                uvd=plan.obs[:, :3], stiffness=plan.obs[:, 3:12], weight=plan.obs[:, 12],
                pose_free=plan.obs[:, 13])
    rebuilt = window_kernel.make_plan(**good)
    for f in ("obs", "pose_idx", "pose_order", "pose_start"):
        assert torch.equal(getattr(rebuilt, f), getattr(plan, f)), f
    for change, what in ((dict(K=window_kernel.MAX_POSES + 1), "poses"),
                         (dict(J=J + 1), "multiple"),
                         (dict(pose_idx=np.full(M, K)), "past the last"),
                         (dict(uvd=plan.obs[:, :2]), "uvd"),
                         (dict(dtype=torch.int32), "float32 or float64"),
                         (dict(device="meta"), "cpu or cuda")):
        with pytest.raises(ValueError, match=what):
            window_kernel.make_plan(**{**good, **change})


@pytest.mark.parametrize("lam", [1e-4, 0.0])
def test_schur_step_matches_jax(case, lam):
    """Damped (LM) and undamped (dogleg GN) Schur steps against
    ``window.window_step``: atol 1e-9 x max|dx| on dx (one 48x48 Cholesky
    in float64 on each side), rtol 1e-8 on the predicted decrease."""
    problem, state = case
    lj = jwindow.build_window_layout(problem, K, J)
    dx_ref, gn_ref, pred_ref = jwindow.window_step(lj, state, jnp.asarray(lam))
    lt, st = _ported(problem, state, lj)
    b = window.factor_blocks(lt, st)
    Hpp_aux, gp_aux = window._masked_aux_blocks(lt.problem, st, torch.float64)
    dx, gn, pred = window.schur_solve(b.Hpp + Hpp_aux, b.Hll, b.U_jo, b.gp + gp_aux, b.gl,
                                      lt.w_idx, lam)
    _close(dx, dx_ref, 1e-9)
    np.testing.assert_allclose(gn.item(), float(gn_ref), rtol=1e-10)
    np.testing.assert_allclose(pred.item(), float(pred_ref), rtol=1e-8)


@pytest.mark.parametrize("k", [0, 1, 7])
def test_marginal_covariance_matches_jax(case, k):
    problem, state = case
    lj = jwindow.build_window_layout(problem, K, J)
    ref = jwindow.window_marginal_covariance(lj, state, jnp.asarray(k))
    lt, st = _ported(problem, state, lj)
    b = window.factor_blocks(lt, st)
    Hpp_aux, _ = window._masked_aux_blocks(lt.problem, st, torch.float64)
    cov = window.pose_marginal_covariance(b.Hpp + Hpp_aux, b.Hll, b.U_jo, lt.w_idx, k)
    _close(cov, ref, 1e-9)


@pytest.mark.parametrize("strategy,nonmonotonic", [("dogleg", True), ("lm", False)])
def test_solve_with_covariance_matches_jax(strategy, nonmonotonic):
    """The whole window solve: poses atol 1e-8 (both loops take the same
    accept/reject decisions, so only rounding separates the iterates) and
    the extracted covariance rtol 1e-6 of its largest entry."""
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
    cfg = dict(max_iters=50, nonmonotonic=nonmonotonic, ftol=1e-9, xtol=1e-12)
    sol_j, sum_j, cov_j = jwindow.solve_ba_window_with_covariance(
        problem, state, 1, jlm.SolveConfig(**cfg), strategy=strategy)
    sol_t, sum_t, cov_t = window.solve_ba_window_with_covariance(
        convert.problem_from_numpy(_np(problem)), convert.state_from_numpy(_np(state)), 1,
        lm.SolveConfig(**cfg), strategy=strategy)
    assert sum_t.iterations == int(sum_j.iterations)
    np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=1e-10)
    np.testing.assert_allclose(sol_t.poses.numpy(), np.asarray(sol_j.poses), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol_t.points.numpy(), np.asarray(sol_j.points), rtol=0, atol=1e-7)
    _close(cov_t, cov_j, 1e-6)
    assert sum_t.final_cost < sum_t.initial_cost


# -- ROADMAP F14 and F15 ------------------------------------------------------

def _poison_aux(problem):
    """Non-finite sun and prior terms on the gauge-fixed pose 0."""
    sun = problem.sun
    dir_c = sun.dir_c.clone()
    dir_c[0] = float("nan")
    prior = problem.prior._replace(pose_idx=0, valid=True,
                                   T_ref=torch.full_like(problem.prior.T_ref, float("inf")))
    return problem._replace(sun=sun._replace(dir_c=dir_c, valid=sun.valid.clone().fill_(True)),
                            prior=prior)


def test_masked_aux_blocks_of_a_fixed_pose_are_zero(case):
    """F15: a gauge-fixed pose whose sun and prior blocks are not finite
    gets exact zeros (the masks are ``torch.where``, not products: 0 * NaN
    is NaN); the free poses keep their blocks."""
    problem, state = case
    p = convert.problem_from_numpy(_np(_masked(problem)))
    st = convert.state_from_numpy(_np(state))
    bad = _poison_aux(p)
    Hpp, gp = window._masked_aux_blocks(bad, st, torch.float64)
    assert torch.isfinite(Hpp).all() and torch.isfinite(gp).all()
    assert not Hpp[0].any() and not gp[0].any()
    ref_H, ref_g = window._masked_aux_blocks(bad._replace(prior=p.prior), st, torch.float64)
    assert torch.equal(Hpp[1:], ref_H[1:]) and torch.equal(gp[1:], ref_g[1:])
    lt = window.build_window_layout(bad, K, J)
    b = window.factor_blocks(lt, st)
    dx, _, pred = window.schur_solve(b.Hpp + Hpp, b.Hll, b.U_jo, b.gp + gp, b.gl, lt.w_idx, 1e-4)
    assert torch.isfinite(dx).all() and torch.isfinite(pred)


def test_fixed_order_sums_match_index_add(case):
    """F14: the layout's gather-table sums (by pose for the dogleg
    Hessian-vector product, by (pose, landmark) pair for W, with repeated
    pairs summed) equal ``index_add_`` sums to rounding (1e-13 x the
    largest entry), and the Hessian-vector product equals the dense
    ``H v``."""
    problem, state = case
    lt, st = _ported(problem, state)
    b = window.factor_blocks(lt, st)
    M = lt.slot_pose.shape[0]
    rows = torch.as_tensor(np.random.default_rng(8).normal(size=(M, 18)))
    by_pose = torch.zeros(K + 1, 18, dtype=rows.dtype).index_add_(0, lt.slot_pose, rows)[:K]
    _close(dense.gather_sum(lt.pose_slots, rows), by_pose.numpy(), 1e-13)
    pair = lt.slot_pose * J + torch.arange(J).repeat_interleave(lt.O)
    by_pair = torch.zeros((K + 1) * J, 18, dtype=rows.dtype).index_add_(0, pair, rows)[:K * J]
    _close(dense.gather_sum(lt.w_idx, rows), by_pair.numpy(), 1e-13)
    Hpp_p, Hll_p = window._pin(b.Hpp), window._pin(b.Hll)
    v = torch.as_tensor(np.random.default_rng(9).normal(size=6 * K + 3 * J))
    Hv = dogleg.block_hvp(Hpp_p, Hll_p, b.U_jo, lt.slot_pose, lt.pose_slots, v)
    Wf = window._contract(b.U_jo.reshape(J, -1, 6, 3), lt.w_idx, K, J)
    H = torch.zeros(6 * K + 3 * J, 6 * K + 3 * J, dtype=v.dtype)
    H[:6 * K, :6 * K] = torch.block_diag(*Hpp_p)
    H[6 * K:, 6 * K:] = torch.block_diag(*Hll_p)
    H[:6 * K, 6 * K:], H[6 * K:, :6 * K] = Wf, Wf.T
    _close(Hv, (H @ v).numpy(), 1e-13)


def test_segment_sum_is_fixed_order():
    """F14: ``dense.segment_sum`` (a gather table built on the tensor's
    device, then a sum over a fixed axis) equals ``index_add_`` to rounding,
    gives the same bits on every call, and its table lists each bin's rows
    in increasing order."""
    rng = np.random.default_rng(10)
    idx = torch.as_tensor(rng.integers(0, 17, 500))
    x = torch.as_tensor(rng.normal(size=(500, 4, 3)))
    ref = torch.zeros(20, 4, 3, dtype=x.dtype).index_add_(0, idx, x)
    got = dense.segment_sum(x, idx, 20)
    _close(got, ref.numpy(), 1e-14)
    assert torch.equal(got, dense.segment_sum(x, idx, 20)) and not got[17:].any()
    t = dense.segment_table(idx, 20)
    assert t.shape == (20, int(torch.bincount(idx).max()))
    for k, row in enumerate(t.tolist()):
        row = [i for i in row if i < 500]
        assert row == sorted(row) and all(int(idx[i]) == k for i in row)
