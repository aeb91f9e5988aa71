"""The window trust-region loops that the card runs in a conditional WHILE node, on the CPU.

On CUDA, ``solver/window.py`` captures one iteration of every window
(``lm_body``, ``dogleg.dogleg_body``, updating the ``Carry`` buffers in
place) and runs it in a WHILE node (``window.device_loop``,
``window.WindowGraph``); ``window.host_loop`` is its plain version, the same
body iterated on the host. Here:

- the host loops against JAX's ``solve_ba_window`` /
  ``solve_ba_window_with_covariance`` (``lax.while_loop``), LM and
  SUBSPACE_DOGLEG, float64 and float32, nonmonotonic steps on and off, on a
  6-pose window of a 24-state triangle sim with its sun observations and
  the flagship's 1e-12 pose prior;
- the body iterated on buffers while its predicate holds (as the node runs
  it) against ``host_loop`` bit for bit, for one window and for three, and
  restarted on another window's ``loop_inputs`` (a missing input would read
  the first window's data);
- the plain 2x2 subproblem (``ops/subspace_kernel.subspace_step_plain``)
  against JAX's ``_boundary_min`` and ``subspace_step``;
- the public names ``solve_ba_window``, ``window_step``,
  ``window_marginal_covariance`` and ``dogleg.subspace_step`` against JAX's;
- ``DeviceWhile``'s scaling of the counters a wrapper declares, and the
  device loop refusing the CPU.

The card's side (the capture, the kernel against its plain version, the
syncs per iteration) is in tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.problems.dataset import DatasetProblemSun as JDatasetSun
from ceres_slam_tpu.solver import dogleg as jdogleg
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import window as jwindow
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.ops import graph_loop, subspace_kernel
from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
from ceres_slam_tpu_torch.solver import dogleg, lm, window
from ceres_slam_tpu_torch.utils import sim

torch.set_num_threads(1)

K1, K2 = 0, 6  # the first 6 poses of the 24-state sim (pose 0 off the origin: F8)
CFG = dict(max_iters=50, ftol=1e-10, xtol=1e-12)


@pytest.fixture(scope="module")
def sim24(tmp_path_factory):
    """A 24-state triangle sim with sun observations (the port's sim module,
    byte-identical to the JAX package's), its CSV base path."""
    base = str(tmp_path_factory.mktemp("win24") / "t24")
    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    sim.write_track_csv(ds, base + ".csv", with_covar=True)
    sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
    sim.write_obs_sun_csv(ds, base + "_sun_dir.csv")
    return base


def _np(x):
    return jax.tree.map(np.asarray, x)


def _f32(x):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if hasattr(a, "dtype") and a.dtype == jnp.float64 else a, x)


@pytest.fixture(scope="module")
def jwin(sim24):
    """JAX's window problem [0, 6) from the VO initial guess, with the
    flagship's prior on its first pose and the sun terms."""
    jds = JDatasetSun.read_csv(sim24 + ".csv", sim24 + "_sun_ref.csv", sim24 + "_sun_dir.csv")
    jds.compute_initial_guess(K1, K2)
    n_obs, n_pts, _ = jds._window_budget(K2 - K1)
    problem, state, _ = jds.build_window_problem(
        K1, K2, n_obs, n_pts, prior=jds._window_prior(K1), sun=jds._window_sun(K1, K2),
        gauge_fix_first=False)
    return problem, state


def _ported(problem, state):
    return convert.problem_from_numpy(_np(problem)), convert.state_from_numpy(_np(state))


@pytest.mark.parametrize("nonmonotonic", [True, False], ids=["nonmono", "mono"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_host_loop_matches_jax(jwin, strategy, dtype, nonmonotonic):
    """``loop="host"`` against JAX's ``solve_ba_window_with_covariance``.
    float64: the same iterations, poses atol 1e-8, the final cost rtol
    1e-10, the covariance 1e-6 of its largest entry (as
    tests/test_torch_window.py holds the window solve). float32: the factor
    pass sums in another order than JAX's XLA assembly (K1's plain version,
    ~1e-7 relative per entry), so the iterates part at float32 rounding:
    poses atol 1e-3 (meter-scale poses; the step tolerance stops each at
    ~1e-4 of its minimum), the initial and final costs rtol 1e-4, the
    covariance 1e-3 of its largest entry (its Schur solve is float64 on
    both sides, from float32 blocks). The float32 iteration counts are not
    compared: near the minimum the accept test compares costs equal to
    float32 rounding, so the two packages reject a different number of
    tail steps (31 against 38 here) on the way to the same minimum."""
    problem, state = jwin
    if dtype == "f32":
        problem, state = _f32(problem), _f32(state)
    cfg = dict(CFG, nonmonotonic=nonmonotonic)
    sol_j, sum_j, cov_j = jwindow.solve_ba_window_with_covariance(
        problem, state, 1, jlm.SolveConfig(**cfg), strategy=strategy)
    p, s = _ported(problem, state)
    sol_t, sum_t, cov_t = window.solve_ba_window_with_covariance(
        p, s, 1, lm.SolveConfig(**cfg), strategy=strategy, loop="host")
    assert sol_t.poses.dtype == s.poses.dtype
    f64 = dtype == "f64"
    pose_tol, cost_tol, cov_tol = (1e-8, 1e-10, 1e-6) if f64 else (1e-3, 1e-4, 1e-3)
    if f64:
        assert sum_t.iterations == int(sum_j.iterations)
    np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=cost_tol)
    np.testing.assert_allclose(sum_t.initial_cost, float(sum_j.initial_cost), rtol=cost_tol)
    np.testing.assert_allclose(sol_t.poses.numpy(), np.asarray(sol_j.poses), rtol=0, atol=pose_tol)
    cov_j = np.asarray(cov_j, np.float64)
    np.testing.assert_allclose(cov_t.double().numpy(), cov_j, rtol=0,
                               atol=cov_tol * np.abs(cov_j).max())
    assert sum_t.final_cost < sum_t.initial_cost


@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_solve_ba_window_matches_jax(jwin, strategy):
    """The public ``solve_ba_window`` with the history recorded, float64:
    the same iterations and accept decisions as JAX's, the costs per
    iteration rtol 1e-10, the gradient norms atol 1e-12 x the first (they
    fall by 9 orders; the last are sums that cancel), the damping or
    radius rtol 1e-8 but for the last iteration's: its rho divides two
    decreases at rounding level (1e-12 of the cost), so its update may take
    another branch of the rule."""
    problem, state = jwin
    cfg = dict(CFG, nonmonotonic=True, record_history=True)
    sol_j, sum_j = jwindow.solve_ba_window(problem, state, jlm.SolveConfig(**cfg),
                                           strategy=strategy)
    p, s = _ported(problem, state)
    sol_t, sum_t = window.solve_ba_window(p, s, lm.SolveConfig(**cfg), strategy)
    n = int(sum_j.iterations)
    assert sum_t.iterations == n
    np.testing.assert_array_equal(sum_t.step_accepted, np.asarray(sum_j.step_accepted))
    for f in ("cost_history", "lambda_history", "grad_norm_history"):
        got, ref = getattr(sum_t, f), np.asarray(getattr(sum_j, f))
        assert np.isnan(got[n:]).all() and np.isnan(ref[n:]).all(), f
    h = {f: (getattr(sum_t, f)[:n], np.asarray(getattr(sum_j, f))[:n])
         for f in ("cost_history", "lambda_history", "grad_norm_history")}
    np.testing.assert_allclose(*h["cost_history"], rtol=1e-10)
    np.testing.assert_allclose(*h["grad_norm_history"], rtol=0,
                               atol=1e-12 * h["grad_norm_history"][1][0])
    np.testing.assert_allclose(h["lambda_history"][0][:-1], h["lambda_history"][1][:-1],
                               rtol=1e-8)
    np.testing.assert_allclose(sol_t.poses.numpy(), np.asarray(sol_j.poses), rtol=0, atol=1e-8)


def test_full_budget_runs_every_iteration(jwin):
    """``run_full_budget`` ignores every stopping test, as JAX's loops do:
    exactly ``max_iters`` iterations, the same final cost (rtol 1e-10)."""
    problem, state = jwin
    cfg = dict(max_iters=7, run_full_budget=True)
    for strategy in ("lm", "dogleg"):
        _, sum_j = jwindow.solve_ba_window(problem, state, jlm.SolveConfig(**cfg),
                                           strategy=strategy)
        p, s = _ported(problem, state)
        _, sum_t = window.solve_ba_window(p, s, lm.SolveConfig(**cfg), strategy)
        assert sum_t.iterations == int(sum_j.iterations) == 7
        np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=1e-10)


@pytest.mark.parametrize("lam", [1e-3, 0.0])
def test_window_step_matches_jax(jwin, lam):
    """``window.window_step`` (one damped Schur step of a window) against
    JAX's: dx atol 1e-9 x its largest entry, the gradient norm rtol 1e-10,
    the predicted decrease rtol 1e-8."""
    problem, state = jwin
    lj = jwindow.build_window_layout(problem, K2 - K1, state.points.shape[0])
    dx_j, gn_j, pred_j = jwindow.window_step(lj, state, jnp.asarray(lam))
    p, s = _ported(problem, state)
    lt = window.build_window_layout(p, K2 - K1, s.points.shape[0])
    dx, gn, pred = window.window_step(lt, s, lam)
    scale = np.abs(np.asarray(dx_j)).max()
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(gn.item(), float(gn_j), rtol=1e-10)
    np.testing.assert_allclose(pred.item(), float(pred_j), rtol=1e-8)


@pytest.mark.parametrize("k", [0, 1, 5])
def test_window_marginal_covariance_matches_jax(jwin, k):
    """``window.window_marginal_covariance`` against JAX's: atol 1e-9 x the
    largest entry (one 36x36 Cholesky each side)."""
    problem, state = jwin
    lj = jwindow.build_window_layout(problem, K2 - K1, state.points.shape[0])
    ref = np.asarray(jwindow.window_marginal_covariance(lj, state, jnp.asarray(k)))
    p, s = _ported(problem, state)
    lt = window.build_window_layout(p, K2 - K1, s.points.shape[0])
    cov = window.window_marginal_covariance(lt, s, k)
    np.testing.assert_allclose(cov.numpy(), ref, rtol=0, atol=1e-9 * np.abs(ref).max())


# -- the body on buffers, as the WHILE node runs it ----------------------------

def _port_windows(sim24, starts, dtype="float64"):
    """Port windows [k, k + 2) of the sim with prior and sun, each as
    ``(problem, state)`` on the host, padded to the pass's shape."""
    ds = DatasetProblemSun.read_csv(sim24 + ".csv", sim24 + "_sun_ref.csv",
                                    sim24 + "_sun_dir.csv")
    ds.dtype, ds.device = dtype, "cpu"
    n_obs, n_pts, o_pad = ds._window_budget(2)
    widths = ds._table_widths(2)
    out = []
    for k in starts:
        ds.compute_initial_guess(k, k + 2)
        problem, state, _ = ds.build_window_problem(
            k, k + 2, n_obs, n_pts, prior=ds._window_prior(k), sun=ds._window_sun(k, k + 2),
            gauge_fix_first=False, device="cpu")
        out.append((problem, state))
        ds.reset_points()
    return out, o_pad, widths


def _iterate_on_host(lp):
    """The WHILE node's semantics on the host: test ``pred``, run the body."""
    n = 0
    while int(lp.pred[0]):
        lp.body()
        n += 1
    return n


def _equal(a, b):
    for x, y in zip(window._leaves(a), window._leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        assert torch.equal(torch.isnan(x), torch.isnan(y)) if x.is_floating_point() else True


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_captured_body_equals_host_loop(sim24, strategy, B):
    """``window_loop``'s body, iterated on its buffers while its predicate
    holds, gives ``host_loop``'s bits (state, blocks, summary statistics
    with the history), for one window and for three in lockstep; the loop
    runs as many iterations as the slowest window."""
    windows, o_pad, widths = _port_windows(sim24, [3, 8, 15][:B])
    layout, state0 = window.windows_batch(windows, o_pad, widths)
    cfg = lm.SolveConfig(max_iters=40, nonmonotonic=True, ftol=1e-8, xtol=1e-10,
                         record_history=True)
    ref = window.host_loop(layout, state0, cfg, strategy)
    lp = window.window_loop(layout, state0, cfg, strategy)
    n = _iterate_on_host(lp)
    _equal(lp.carry, ref)
    assert n == int(ref.it.max()) and n > 1
    _equal(window.finish(lp.carry, cfg), window.finish(ref, cfg))


@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_restarted_loop_equals_host_loop(sim24, strategy):
    """A loop built on one window, restarted on another window's
    ``loop_inputs`` copied into its own (what a ``WindowGraph`` does for
    every later solve of a pass), gives ``host_loop``'s bits on the second
    window: ``loop_inputs`` misses no tensor the body reads."""
    windows, o_pad, widths = _port_windows(sim24, [3, 12])
    (la, sa), (lb, sb) = [window.windows_batch([w], o_pad, widths) for w in windows]
    cfg = lm.SolveConfig(max_iters=40, nonmonotonic=True, ftol=1e-8, xtol=1e-10)
    lp = window.window_loop(la, sa, cfg, strategy)
    _iterate_on_host(lp)
    captured, new = window.loop_inputs(la, sa), window.loop_inputs(lb, sb)
    assert [(t.shape, t.dtype) for t in captured] == [(t.shape, t.dtype) for t in new]
    assert sum(not torch.equal(a, b) for a, b in zip(captured, new)) >= 10  # data, not shape
    window._copy_inputs(captured, new)  # one copy: both are views of one upload
    assert all(torch.equal(a, b) for a, b in zip(captured, new))
    lp.restart()
    _iterate_on_host(lp)
    _equal(lp.carry, window.host_loop(lb, sb, cfg, strategy))


def test_lm_chain_in_batch_equals_its_pass_alone(sim24):
    """PR 9's property under the new loop, for LM: the sun pass of a batch
    of the two flagship passes (one dataset, one padding) equals its
    sequential pass bit for bit (``tests/test_torch_batch.py`` holds it for
    the dogleg)."""
    from ceres_slam_tpu_torch.problems import batch_scan

    def load():
        ds = DatasetProblemSun.read_csv(sim24 + ".csv", sim24 + "_sun_ref.csv",
                                        sim24 + "_sun_dir.csv")
        ds.device = "cpu"
        return ds

    cfg = lm.SolveConfig(max_iters=100, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    ds = load()
    res = batch_scan.solve_batch([batch_scan.RunSpec(ds), batch_scan.RunSpec(ds, use_sun=True)],
                                 config=cfg, strategy="lm", loop="host")
    alone = load()
    summaries = alone.solve_sliding_window(window=2, use_sun=True, config=cfg, strategy="lm",
                                           loop="host")
    np.testing.assert_array_equal(res[1].poses, alone.poses)
    np.testing.assert_array_equal(res[1].pose_covars, alone.pose_covars)
    assert [s.iterations for s in res[1].summaries] == [s.iterations for s in summaries]


# -- the 2x2 subproblem ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_subspace_plain_matches_jax(dtype):
    """The plain 2x2 subproblem against JAX's ``_boundary_min`` and its
    interior test (``subspace_step``'s 2x2 part, vmapped), on the interior,
    boundary, indefinite, hard-case, degenerate (1-D), zero-gradient and
    non-finite models and 33 random ones with radii over 8 decades: atol
    1e-10 (float64) / 1e-4 (float32) x max(1, radius) on y; the non-finite
    model gives NaN on both sides. The bisection runs the same 64 steps on
    both sides; only rounding order separates them."""
    model, radius = subspace_kernel.random_models(40, dtype, seed=7)
    got = subspace_kernel.subspace_step(model, radius).double().numpy()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    m, r = jnp.asarray(model.numpy(), jdt), jnp.asarray(radius.numpy(), jdt)

    def jax_2x2(m, r):
        B00, B01, B11, g0, g1 = m
        det = B00 * B11 - B01 * B01
        det_safe = jnp.where(det == 0.0, 1.0, det)
        yi0 = (-g0 * B11 + g1 * B01) / det_safe
        yi1 = (-g1 * B00 + g0 * B01) / det_safe
        ok = (B00 > 0.0) & (det > 0.0) & (yi0 * yi0 + yi1 * yi1 <= r * r)
        yb0, yb1 = jdogleg._boundary_min(B00, B01, B11, g0, g1, r)
        y0, y1 = jnp.where(ok, yi0, yb0), jnp.where(ok, yi1, yb1)
        pred = -(g0 * y0 + g1 * y1 + 0.5 * (B00 * y0 * y0 + 2.0 * B01 * y0 * y1 + B11 * y1 * y1))
        return jnp.stack([y0, y1, pred])

    ref = np.asarray(jax.vmap(jax_2x2)(m, r), np.float64)
    bad = ~np.isfinite(model.numpy()).all(axis=1)
    assert np.isnan(got[bad]).all() and np.isnan(ref[bad]).all()
    atol = (1e-10 if dtype == torch.float64 else 1e-4) * np.maximum(1.0, r.astype(float))[~bad]
    np.testing.assert_array_less(np.abs(got[~bad, :2] - ref[~bad, :2]).max(axis=1), atol + 1e-300)
    scale = np.maximum(1.0, np.abs(ref[~bad, 2]))
    np.testing.assert_array_less(np.abs(got[~bad, 2] - ref[~bad, 2]) / scale, atol)
    # every boundary point on the circle, every interior one inside it
    norm = np.hypot(got[~bad, 0], got[~bad, 1])
    assert (norm <= r.astype(float)[~bad] * (1 + 1e-5)).all()


def _dense_case(case):
    """``(H, g, dx_gn, radius)`` in R^4 for the subspace step's cases."""
    rng = np.random.default_rng(12)
    A = rng.normal(size=(4, 4))
    H = A @ A.T + 4 * np.eye(4)
    g = rng.normal(size=4)
    dx_gn = -np.linalg.solve(H, g)
    if case == "interior":
        return H, g, dx_gn, 1e12
    if case == "boundary":
        return H, g, dx_gn, 0.1 * np.linalg.norm(dx_gn)
    if case == "degenerate":  # dx_gn parallel to g: span{g, dx_gn} is 1-D
        return H, g, -0.3 * g, 0.05
    # the hard case: the projected model [[2, 0], [0, -1]], gradient (1, 0)
    return np.diag([-1.0, 2.0, 3.0, 4.0]), np.array([0.0, 1.0, 0.0, 0.0]), \
        np.array([1.0, 0.0, 0.0, 0.0]), 1.5


@pytest.mark.parametrize("case", ["interior", "boundary", "degenerate", "hard"])
def test_subspace_step_matches_jax(case):
    """``dogleg.subspace_step`` (the basis, two Hessian-vector products and
    the 2x2 subproblem) against JAX's on one window: dx atol 1e-10 x max(1,
    |dx|), pred rtol 1e-9; as tests/test_dogleg.py holds JAX's, the interior
    step is the Gauss-Newton step and every step respects the radius."""
    H, g, dx_gn, radius = _dense_case(case)
    dx_j, pred_j = jdogleg.subspace_step(jnp.asarray(g), jnp.asarray(dx_gn),
                                         lambda v: jnp.asarray(H) @ v, jnp.asarray(radius))
    Ht = torch.as_tensor(H)
    dx, pred = dogleg.subspace_step(torch.as_tensor(g), torch.as_tensor(dx_gn),
                                    lambda v: window._matvec(Ht, v), radius)
    dx_j = np.asarray(dx_j)
    np.testing.assert_allclose(dx.numpy(), dx_j, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(dx_j).max()))
    np.testing.assert_allclose(pred.item(), float(pred_j), rtol=1e-9)
    assert np.linalg.norm(dx.numpy()) <= radius * (1 + 1e-9)
    if case == "interior":
        np.testing.assert_allclose(dx.numpy(), dx_gn, rtol=0, atol=1e-8 * np.abs(dx_gn).max())
        np.testing.assert_allclose(pred.item(), -0.5 * g @ dx_gn, rtol=1e-6)
    else:
        assert pred.item() > 0.0
        np.testing.assert_allclose(np.linalg.norm(dx.numpy()), radius, rtol=1e-6)


def test_subspace_wrapper_checks_and_dispatch():
    """CPU tensors take the plain version (no launch counted); the wrapper
    refuses other devices, shapes and mixed dtypes: no host path for a
    tensor it cannot launch on."""
    model, radius = subspace_kernel.random_models(5, seed=1)
    before = subspace_kernel.subspace_step.launches
    assert torch.equal(torch.nan_to_num(subspace_kernel.subspace_step(model, radius)),
                       torch.nan_to_num(subspace_kernel.subspace_step_plain(model, radius)))
    assert subspace_kernel.subspace_step.launches == before
    for m, r, what in ((model.to("meta"), radius.to("meta"), "cpu or cuda"),
                       (model[:, :4], radius, r"\[B, 5\]"),
                       (model, radius.float(), "one dtype"),
                       (model.int(), radius.int(), "float32 or float64")):
        with pytest.raises(ValueError, match=what):
            subspace_kernel.subspace_step(m, r)


# -- the loop's switches and counters --------------------------------------------

def test_device_loop_refuses_the_cpu(sim24):
    """On the CPU ``run_loop`` runs the host loop; the device loop raises
    there instead of falling back, as do an unknown loop and strategy."""
    windows, o_pad, widths = _port_windows(sim24, [3])
    layout, state = window.windows_batch(windows[:1], o_pad, widths)
    cfg = lm.SolveConfig(max_iters=5)
    a = window.run_loop(layout, state, cfg, "dogleg")
    b = window.run_loop(layout, state, cfg, "dogleg", loop="host")
    _equal(a, b)
    with pytest.raises(ValueError, match="runs on the card"):
        window.run_loop(layout, state, cfg, "dogleg", loop="device")
    with pytest.raises(ValueError, match="unknown trust-region loop"):
        window.run_loop(layout, state, cfg, loop="scan")
    with pytest.raises(ValueError, match="unknown trust-region strategy"):
        window.run_loop(layout, state, cfg, "newton", loop="host")


def test_device_while_scales_declared_counters():
    """``graph_loop.CapturedCounts`` (what ``DeviceWhile`` does around a
    capture): every counter a wrapper names in ``counters`` (default
    ``launches``) is taken back after the capture and added per iteration
    the device ran; the batched K1 declares its windows served."""
    from ceres_slam_tpu_torch.ops import window_kernel

    def batched():
        batched.launches += 1
        batched.windows += 15

    def plain():
        plain.launches += 1

    batched.launches, batched.windows, batched.counters = 10, 100, ("launches", "windows")
    plain.launches = 3
    counts = graph_loop.CapturedCounts([batched, plain])
    batched(), plain(), plain()  # the capture: no launch
    counts.end()
    assert (batched.launches, batched.windows, plain.launches) == (10, 100, 3)
    counts.add(7)
    assert (batched.launches, batched.windows, plain.launches) == (17, 205, 17)
    assert window_kernel.window_factor_blocks_batch.counters == ("launches", "windows")
    assert set(window._counted()) >= {window_kernel.window_factor_blocks_batch,
                                      subspace_kernel.subspace_step}


def test_cli_tr_loop_switch(sim24, tmp_path):
    """``dataset_vo_sun --tr-loop host`` on the CPU writes the default run's
    bytes (the host loop is the CPU's form); ``--tr-loop device`` raises
    there (no fallback)."""
    from ceres_slam_tpu_torch.apps import dataset_vo_sun

    base = str(tmp_path / "t24")
    for ext in (".csv", "_sun_ref.csv", "_sun_dir.csv"):
        with open(sim24 + ext, "rb") as f, open(base + ext, "wb") as g:
            g.write(f.read())
    argv = [base + ".csv", base + "_sun_ref.csv", base + "_sun_dir.csv", "--device", "cpu",
            "--max-iters", "30"]
    stats = dataset_vo_sun.main(argv)
    written = {n: open(p["output"], "rb").read() for n, p in stats["passes"].items()}
    again = dataset_vo_sun.main(argv + ["--tr-loop", "host"])
    for n, p in again["passes"].items():
        assert open(p["output"], "rb").read() == written[n], n
    with pytest.raises(ValueError, match="runs on the card"):
        dataset_vo_sun.main(argv + ["--tr-loop", "device"])
    assert os.path.exists(stats["passes"]["sun"]["output"])
