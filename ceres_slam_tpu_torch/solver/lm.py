"""Levenberg-Marquardt trust-region loop, its configuration and report.

Port of ``ceres_slam_tpu/solver/lm.py`` (``SolveConfig``, ``SolveSummary``,
``lm_solve``, ``dense_cholesky_step``). The JAX loop is a
``lax.while_loop`` on the device; here it is a Python loop whose
trust-region control (accept test, damping, termination) runs on the host
in float64 on a few scalars read from the device: one read per iteration,
plus one for the initial cost. The window solver's block-carrying loops
(``solver/window.py``, ``solver/dogleg.py``) follow the same rules.

Not ported yet: ``dogleg_solve`` and the ``record_history`` /
``run_full_budget`` fields (no path of the port sets them).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

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


class SolveSummary(NamedTuple):
    """Per-solve report (Ceres BriefReport equivalent). Host scalars: the
    trust-region control runs on the host, so these need no transfer."""

    iterations: int
    initial_cost: float
    final_cost: float
    final_grad_norm: float
    final_lambda: float  # trust radius for dogleg
    linear_iterations: int = 0  # CG iterations over the whole solve (Schur-PCG only)


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
    uphill step under ``nonmonotonic`` does not end the solve."""
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
        done = (small or grad_norm <= config.gtol or (dx_ok and dx_max <= config.xtol)
                or lam >= config.max_lambda)
        if accept:
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), config.min_lambda)
            state, cost = new_state, new_cost
            cost_buf[it % config.nonmonotonic_window] = new_cost
            if new_cost < best_cost:
                best_state, best_cost = new_state, new_cost
        else:
            lam = min(lam * 4.0, config.max_lambda)
        it += 1
        if done:
            break
    if config.nonmonotonic:
        state, cost = best_state, best_cost
    return state, SolveSummary(it, cost0, cost, grad_norm, lam)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; a matrix that is not positive definite gets
    an all-NaN factor (as ``jnp.linalg.cholesky`` gives), so a failed
    factorization becomes a rejected step without a host synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


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
