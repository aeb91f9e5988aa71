"""Levenberg-Marquardt trust-region loop, its configuration and report.

Port of ``ceres_slam_tpu/solver/lm.py`` (``SolveConfig``, ``SolveSummary``,
``lm_solve``, ``dogleg_solve``, ``dense_cholesky_step``). The JAX loops are a
``lax.while_loop`` on the device; here it is a Python loop whose
trust-region control (accept test, damping, termination) runs on the host
in float64 on a few scalars read from the device: one read per iteration,
plus one for the initial cost. The window solver's block-carrying loops
(``solver/window.py``, ``solver/dogleg.py``) apply the same rules on the
device, as the JAX loops do: their control is a carry of tensors in the
cost's dtype, and on CUDA the loop runs in a WHILE node.
``record_history`` keeps the per-iteration cost, damping, gradient norm
and accept decision on the host (``utils/telemetry.full_report``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class SolveConfig(NamedTuple):
    max_iters: int = 50
    ftol: float = 1e-9
    gtol: float = 1e-12
    # step-size tolerance: stop when max|dx| of an attempted step falls below it
    xtol: float = 1e-14
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e10
    # Ceres use_nonmonotonic_steps: accept a step that decreases the cost
    # relative to the worst of the last `nonmonotonic_window` accepted costs
    nonmonotonic: bool = False
    nonmonotonic_window: int = 5
    # record the per-iteration cost, lambda (trust radius for dogleg),
    # gradient norm and accept decision in the SolveSummary
    record_history: bool = False
    # benchmarking only: ignore every convergence test and run exactly
    # max_iters iterations, accepted or not, so a measured rate is a pure
    # per-iteration rate
    run_full_budget: bool = False


class SolveSummary(NamedTuple):
    """Per-solve report (Ceres BriefReport equivalent). Host scalars: the
    trust-region control runs on the host, so these need no transfer."""

    iterations: int
    initial_cost: float
    final_cost: float
    final_grad_norm: float
    final_lambda: float  # trust radius for dogleg
    linear_iterations: int = 0  # CG iterations over the whole solve (Schur-PCG only)
    # with record_history: [max_iters] arrays, NaN (False) past `iterations`
    cost_history: np.ndarray | None = None
    lambda_history: np.ndarray | None = None
    grad_norm_history: np.ndarray | None = None
    step_accepted: np.ndarray | None = None


class History:
    """Per-iteration record of a trust-region loop (host values)."""

    def __init__(self, config: SolveConfig):
        self.on = config.record_history
        n = config.max_iters
        if self.on:
            self.arrays = (np.full(n, math.nan), np.full(n, math.nan), np.full(n, math.nan),
                           np.zeros(n, bool))

    def add(self, it: int, cost: float, lam: float, grad_norm: float, accept: bool):
        if self.on:
            for a, x in zip(self.arrays, (cost, lam, grad_norm, accept)):
                a[it] = x

    def summary(self, *fields) -> SolveSummary:
        """``SolveSummary(*fields)`` with the history attached."""
        s = SolveSummary(*fields)
        if not self.on:
            return s
        return s._replace(**dict(zip(("cost_history", "lambda_history", "grad_norm_history",
                                      "step_accepted"), self.arrays)))


def lm_solve(state0, config: SolveConfig, cost_fn: Callable, step_fn: Callable,
             retract_fn: Callable):
    """Run LM. ``cost_fn(state)`` is the scalar cost; ``step_fn(state, lam)``
    solves the damped system and returns the step ``dx``, the max-norm of
    the gradient and the predicted decrease ``-(g.dx + 0.5 dx.H dx)`` of the
    undamped model; ``retract_fn(state, dx)`` applies the step. Returns
    ``(state, SolveSummary)``; under ``nonmonotonic`` the state is the best
    accepted iterate (Ceres returns the best minimizer).

    A non-finite ``dx`` (a failed factorization) is a rejected step, not
    convergence; ``ftol`` fires only on a real decrease, so an accepted
    uphill step under ``nonmonotonic`` does not end the solve.
    ``config.record_history`` attaches the per-iteration history to the
    summary."""
    history = History(config)
    cost0 = cost = float(cost_fn(state0))
    state, lam, grad_norm, it = state0, config.init_lambda, math.inf, 0
    cost_buf = [cost0] * config.nonmonotonic_window
    best_state, best_cost = state0, cost0
    f64 = torch.float64
    while it < config.max_iters:
        dx, grad_norm_t, pred_t = step_fn(state, lam)
        dx_ok_t = torch.all(torch.isfinite(dx))
        dx = torch.where(dx_ok_t, dx, torch.zeros_like(dx))
        new_state = retract_fn(state, dx)
        new_cost_t = cost_fn(new_state)
        grad_norm, pred, new_cost, dx_ok, dx_max = torch.stack(
            [x.to(f64) for x in (grad_norm_t, pred_t, new_cost_t, dx_ok_t, dx.abs().max())]
        ).tolist()

        actual = cost - new_cost
        rho = actual / max(pred, 1e-30)
        accept_ref = max(cost_buf) if config.nonmonotonic else cost
        accept = math.isfinite(new_cost) and new_cost < accept_ref
        small = accept and actual >= 0.0 and actual <= config.ftol * max(cost, 1e-30)
        done = not config.run_full_budget and (
            small or grad_norm <= config.gtol or (dx_ok and dx_max <= config.xtol)
            or lam >= config.max_lambda)
        if accept:
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), config.min_lambda)
            state, cost = new_state, new_cost
            cost_buf[it % config.nonmonotonic_window] = new_cost
            if new_cost < best_cost:
                best_state, best_cost = new_state, new_cost
        else:
            lam = min(lam * 4.0, config.max_lambda)
        history.add(it, cost, lam, grad_norm, accept)
        it += 1
        if done:
            break
    if config.nonmonotonic:
        state, cost = best_state, best_cost
    return state, history.summary(it, cost0, cost, grad_norm, lam)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; a matrix that is not positive definite gets
    an all-NaN factor (as ``jnp.linalg.cholesky`` gives), so a failed
    factorization becomes a rejected step without a host synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def cholesky_apply(L: torch.Tensor, b: torch.Tensor, columns: bool = False) -> torch.Tensor:
    """``(L L^T)^{-1} b`` for vectors ``b [..., n]`` (or, with ``columns``,
    matrices ``b [..., n, m]``) and factors ``L [..., n, n]``: two triangular
    solves, as the JAX package applies its factors. Unlike a batched
    ``torch.cholesky_solve`` it never synchronizes with the host on CUDA, so
    a CUDA graph can capture it (``solver/pcg.py``'s CG loop, the window
    loops of ``solver/window.py``)."""
    y = torch.linalg.solve_triangular(L, b if columns else b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x if columns else x[..., 0]


def dogleg_solve(state0, config: SolveConfig, cost_fn: Callable, normal_eq_fn: Callable,
                 retract_fn: Callable, init_radius: float = 1e4):
    """Powell's dogleg trust-region minimizer over a dense system (Ceres'
    DOGLEG): the Gauss-Newton step of ``(H + 1e-10 I) dx = -g`` (``-g``
    where that step is not finite), the Cauchy step ``-(g.g / g.H g) g``,
    and their blend on the trust radius, which grows past rho 0.75 and
    shrinks below 0.25 or on a rejected step, clipped to [1e-12, 1e12].
    ``normal_eq_fn(state)`` returns the dense ``(H, g)``. Returns ``(state,
    SolveSummary)`` with the final radius in ``final_lambda``; the step is
    chosen on the device and the control reads four scalars per
    iteration."""
    cost0 = cost = float(cost_fn(state0))
    state, radius, grad_norm, it = state0, float(init_radius), math.inf, 0
    f64 = torch.float64
    while it < config.max_iters:
        H, g = normal_eq_fn(state)
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        dx_gn = torch.cholesky_solve(-g[:, None], _cholesky_or_nan(H + 1e-10 * eye))[:, 0]
        dx_gn = torch.where(torch.all(torch.isfinite(dx_gn)), dx_gn, -g)
        alpha = (g @ g) / torch.clamp(g @ (H @ g), min=1e-30)
        dx_sd = -alpha * g
        n_gn, n_sd = torch.linalg.norm(dx_gn), torch.linalg.norm(dx_sd)
        d = dx_gn - dx_sd
        a, b = d @ d, 2.0 * (dx_sd @ d)
        cc = dx_sd @ dx_sd - radius ** 2
        beta = (-b + torch.sqrt(torch.clamp(b * b - 4 * a * cc, min=0.0))) / torch.clamp(
            2 * a, min=1e-30)
        blend = dx_sd + torch.clamp(beta, 0.0, 1.0) * d
        dx = torch.where(n_gn <= radius, dx_gn, torch.where(
            n_sd >= radius, dx_sd * (radius / torch.clamp(n_sd, min=1e-30)), blend))
        new_state = retract_fn(state, dx)
        pred_t = -(g @ dx + 0.5 * dx @ (H @ dx))
        grad_norm, new_cost, pred, n_dx = torch.stack(
            [x.to(f64) for x in (g.abs().max(), cost_fn(new_state), pred_t,
                                 torch.linalg.norm(dx))]).tolist()

        actual = cost - new_cost
        rho = actual / max(pred, 1e-30)
        accept = math.isfinite(new_cost) and actual > 0.0
        if not accept:
            radius *= 0.25
        elif rho > 0.75:
            radius = max(radius, 3.0 * n_dx)
        elif rho < 0.25:
            radius *= 0.5
        radius = min(max(radius, 1e-12), 1e12)
        small = accept and actual <= config.ftol * max(cost, 1e-30)
        if accept:
            state, cost = new_state, new_cost
        it += 1
        if small or grad_norm <= config.gtol or radius <= 1e-11:
            break
    return state, SolveSummary(it, cost0, cost, grad_norm, radius)


def dense_cholesky_step(normal_eq_fn: Callable):
    """Standard damped dense step: ``(H + lam diag(H)) dx = -g``."""

    def step(state, lam):
        H, g = normal_eq_fn(state)
        diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
        L = _cholesky_or_nan(H + lam * torch.diag(diag))
        dx = torch.cholesky_solve(-g[:, None], L)[:, 0]
        pred = -(g @ dx + 0.5 * dx @ (H @ dx))
        return dx, g.abs().max(), pred

    return step
