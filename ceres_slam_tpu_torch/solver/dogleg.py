"""Subspace-dogleg trust region over the window solver's block system.

Port of ``ceres_slam_tpu/solver/dogleg.py`` — Ceres's SUBSPACE_DOGLEG with
nonmonotonic steps, the reference flagship's minimizer: the quadratic model
is minimized exactly over span{gradient, Gauss-Newton step} within the
trust radius.

Split between device and host: the Gauss-Newton step, the subspace basis
and the two Hessian-vector products stay on the device; the projected 2x2
model (five scalars) is read to the host, where the interior solution or
the More-Sorensen boundary solution (64 bisection steps) is a few hundred
scalar operations in float64 — on the device each would be a kernel
launch. A second read per iteration brings back the candidate's cost for
the host-side accept test.
"""

from __future__ import annotations

import math

import torch

from ceres_slam_tpu_torch.ops import lie
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver import window as window_mod


def block_hvp(Hpp_p, Hll_p, U_jo, slot_pose, pose_slots, v):
    """``H v`` for ``H = [[Hpp, W], [W^T, Hll]]`` without materializing W:
    the coupling goes through the per-slot U blocks, gathered by slot pose
    (padding slots carry U = 0 and pose K) and summed by pose through the
    layout's by-pose table, in a fixed order."""
    K, J = Hpp_p.shape[0], Hll_p.shape[0]
    vp = v[: 6 * K].reshape(K, 6)
    vl = v[6 * K:].reshape(J, 3)
    U4 = U_jo.reshape(J, -1, 6, 3)
    Wvl = (U4 @ vl[:, None, :, None]).squeeze(-1)  # [J, O, 6]
    Hvp = lie._mv(Hpp_p, vp) + dense.gather_sum(pose_slots, Wvl.reshape(-1, 6))
    vp_obs = torch.cat([vp, torch.zeros_like(vp[:1])])[slot_pose].reshape(J, -1, 6)
    Hvl = lie._mv(Hll_p, vl) + torch.einsum("joab,joa->jb", U4, vp_obs)
    return torch.cat([Hvp.reshape(-1), Hvl.reshape(-1)])


def _boundary_min(B00, B01, B11, g0, g1, r):
    """Minimize ``0.5 y^T B y + g^T y`` on the circle ``|y| = r`` (host
    floats): exact More-Sorensen solve in the 2x2 eigenbasis by bisection
    on the multiplier, then the best of four candidates."""
    tiny = 1e-30
    mean = 0.5 * (B00 + B11)
    half = 0.5 * (B00 - B11)
    d = math.sqrt(half * half + B01 * B01)
    e1, e2 = mean - d, mean + d
    v1 = (B01, e1 - B00) if abs(e1 - B00) > abs(e1 - B11) else (e1 - B11, B01)
    n1 = math.sqrt(v1[0] * v1[0] + v1[1] * v1[1])
    v1 = (v1[0] / max(n1, tiny), v1[1] / max(n1, tiny)) if n1 > tiny else (1.0, 0.0)
    v2 = (-v1[1], v1[0])
    gh1 = v1[0] * g0 + v1[1] * g1
    gh2 = v2[0] * g0 + v2[1] * g1

    def norm2_y(lam):
        y1 = -gh1 / max(e1 + lam, tiny)
        y2 = -gh2 / max(e2 + lam, tiny)
        return y1 * y1 + y2 * y2

    gnorm = math.sqrt(gh1 * gh1 + gh2 * gh2)
    lo = max(0.0, -e1)
    hi = max(lo + tiny, -e1 + gnorm / max(r, tiny))
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if norm2_y(mid) > r * r:
            lo = mid
        else:
            hi = mid
    lam = 0.5 * (lo + hi)
    yh1 = -gh1 / max(e1 + lam, tiny)
    yh2 = -gh2 / max(e2 + lam, tiny)
    # hard case: fill the missing norm along the e1 eigendirection
    tau = math.sqrt(max(r * r - (yh1 * yh1 + yh2 * yh2), 0.0))
    yh1 += tau * (-1.0 if gh1 > 0.0 else 1.0)
    scale = r / max(math.sqrt(yh1 * yh1 + yh2 * yh2), tiny)
    yh1, yh2 = yh1 * scale, yh2 * scale

    gg = max(math.sqrt(g0 * g0 + g1 * g1), tiny)
    cands = [
        (yh1 * v1[0] + yh2 * v2[0], yh1 * v1[1] + yh2 * v2[1]),
        (-r * g0 / gg, -r * g1 / gg),
        (r * v1[0], r * v1[1]),
        (-r * v1[0], -r * v1[1]),
    ]
    vals = [_model(B00, B01, B11, g0, g1, y0, y1) for y0, y1 in cands]
    return cands[vals.index(min(vals))]


def _model(B00, B01, B11, g0, g1, y0, y1):
    return 0.5 * (B00 * y0 * y0 + 2.0 * B01 * y0 * y1 + B11 * y1 * y1) + (g0 * y0 + g1 * y1)


def subspace_solution(B00, B01, B11, g0, g1, radius):
    """Host half of the SUBSPACE_DOGLEG step: the 2x2 model minimizer
    within ``radius``. Returns ``(y0, y1, pred_decrease)``; NaN when the
    model itself is not finite (the step is then rejected)."""
    if not all(math.isfinite(x) for x in (B00, B01, B11, g0, g1)):
        return math.nan, math.nan, math.nan
    det = B00 * B11 - B01 * B01
    det_safe = 1.0 if det == 0.0 else det
    yi0 = (-g0 * B11 + g1 * B01) / det_safe
    yi1 = (-g1 * B00 + g0 * B01) / det_safe
    if B00 > 0.0 and det > 0.0 and yi0 * yi0 + yi1 * yi1 <= radius * radius:
        y0, y1 = yi0, yi1
    else:
        y0, y1 = _boundary_min(B00, B01, B11, g0, g1, radius)
    return y0, y1, -_model(B00, B01, B11, g0, g1, y0, y1)


def _subspace_basis(g, dx_gn, hvp):
    """Device half: orthonormal basis ``b1 ~ g``, ``b2 ~ dx_gn`` (zero when
    the span is 1-D) and the projected model ``[B00, B01, B11, g0, g1]``."""
    eps = 1e-30
    b1 = g / torch.clamp(torch.sqrt(torch.sum(g * g)), min=eps)
    b2_raw = dx_gn - torch.sum(dx_gn * b1) * b1
    n2 = torch.sqrt(torch.sum(b2_raw * b2_raw))
    degenerate = n2 <= 1e-7 * torch.clamp(torch.sqrt(torch.sum(dx_gn * dx_gn)), min=eps)
    b2 = torch.where(degenerate, torch.zeros_like(b2_raw), b2_raw / torch.clamp(n2, min=eps))
    Hb1, Hb2 = hvp(b1), hvp(b2)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    model = torch.stack([
        torch.sum(b1 * Hb1),
        0.5 * (torch.sum(b1 * Hb2) + torch.sum(b2 * Hb1)),
        torch.where(degenerate, one, torch.sum(b2 * Hb2)),
        torch.sum(b1 * g),
        torch.where(degenerate, 0.0 * one, torch.sum(b2 * g)),
    ])
    return b1, b2, model


def blocks_dogleg_loop(layout, state0, config: lm.SolveConfig, init_radius: float = 1e4):
    """Subspace-dogleg loop carrying the candidate's factor blocks (one K1
    pass per iteration). Returns ``(state, summary, blocks_at_state)``."""
    problem = layout.problem
    total_blocks = window_mod.total_blocks_fn(layout)
    history = lm.History(config)
    blocks, cost_t = total_blocks(state0)
    dtype = cost_t.dtype
    cost0 = cost = float(cost_t)
    state, radius, grad_norm, it = state0, init_radius, math.inf, 0
    cost_buf = [cost0] * config.nonmonotonic_window
    best = (state, blocks, cost)
    while it < config.max_iters:
        Hpp_aux, gp_aux = window_mod._masked_aux_blocks(problem, state, dtype)
        Hpp = blocks.Hpp + Hpp_aux
        gp = blocks.gp + gp_aux
        Hpp_p, Hll_p = window_mod._pin(Hpp), window_mod._pin(blocks.Hll)

        # Gauss-Newton step from the undamped Schur solve; a failed
        # (indefinite) solve degrades to steepest descent
        dx_gn, grad_norm_t, _ = window_mod.schur_solve(
            Hpp, blocks.Hll, blocks.U_jo, gp, blocks.gl, layout.w_idx, 0.0)
        g = torch.cat([gp.reshape(-1), blocks.gl.reshape(-1)])
        dx_gn = torch.where(torch.all(torch.isfinite(dx_gn)), dx_gn, -g)

        def hvp(v, Hpp_p=Hpp_p, Hll_p=Hll_p, U_jo=blocks.U_jo):
            return block_hvp(Hpp_p, Hll_p, U_jo, layout.slot_pose, layout.pose_slots, v)

        b1, b2, model = _subspace_basis(g, dx_gn, hvp)
        y0, y1, pred = subspace_solution(*model.tolist(), radius)
        dx = y0 * b1 + y1 * b2
        dx_ok_t = torch.all(torch.isfinite(dx))
        dx = torch.where(dx_ok_t, dx, torch.zeros_like(dx))
        new_state = dense._retract_state(problem, state, dx)
        new_blocks, new_cost_t = total_blocks(new_state)
        grad_norm, new_cost, dx_ok, step_norm, dx_max = torch.stack([
            grad_norm_t, new_cost_t, dx_ok_t.to(dtype), torch.sqrt(torch.sum(dx * dx)),
            dx.abs().max(),
        ]).tolist()

        actual = cost - new_cost
        rho = actual / max(pred, 1e-30)
        accept_ref = max(cost_buf) if config.nonmonotonic else cost
        accept = math.isfinite(new_cost) and new_cost < accept_ref
        if not accept:
            new_radius = radius * 0.25
        elif rho > 0.75:
            new_radius = max(radius, 3.0 * step_norm)
        elif rho < 0.25:
            new_radius = radius * 0.5
        else:
            new_radius = radius
        small = accept and actual >= 0.0 and actual <= config.ftol * max(cost, 1e-30)
        radius = min(max(new_radius, 1e-12), 1e12)
        if accept:
            state, blocks, cost = new_state, new_blocks, new_cost
            cost_buf[it % config.nonmonotonic_window] = new_cost
            if new_cost < best[2]:
                best = (new_state, new_blocks, new_cost)
        history.add(it, cost, radius, grad_norm, accept)  # the radius in the lambda slot
        it += 1
        if (small or grad_norm <= config.gtol or (dx_ok and dx_max <= config.xtol)
                or radius <= 1e-11):
            break
    if config.nonmonotonic:
        state, blocks, cost = best
    return state, history.summary(it, cost0, cost, grad_norm, radius), blocks
