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
the host-side accept test. A batch of windows (``window.BatchLayout``)
runs one loop each in lockstep: the two reads bring back every window's
model and statistics, and the host solves each window's 2x2 model.
"""

from __future__ import annotations

import math

import torch

from ceres_slam_tpu_torch.ops import lie
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver import window as window_mod


def block_hvp(Hpp_p, Hll_p, U_jo, slot_pose, pose_slots, v):
    """``H v`` for ``H = [[Hpp, W], [W^T, Hll]]`` without materializing W
    (one window, or a batch with a leading axis): the coupling goes through
    the per-slot U blocks, gathered by slot pose (padding slots carry U = 0
    and pose K; in a batch ``slot_pose`` indexes window b's poses at
    ``b*(K+1)``) and summed by pose through the layout's by-pose table, in a
    fixed order."""
    lead, K, J = Hpp_p.shape[:-3], Hpp_p.shape[-3], Hll_p.shape[-3]
    vp = v[..., : 6 * K].reshape(*lead, K, 6)
    vl = v[..., 6 * K:].reshape(*lead, J, 3)
    U4 = U_jo.reshape(*lead, J, -1, 6, 3)
    Wvl = (U4 @ vl[..., :, None, :, None]).squeeze(-1)  # [..., J, O, 6]
    Hvp = lie._mv(Hpp_p, vp) + dense.gather_sum(pose_slots, Wvl.reshape(-1, 6)).reshape(
        *lead, K, 6)
    vp_obs = torch.cat([vp, torch.zeros_like(vp[..., :1, :])], dim=-2).reshape(-1, 6)[
        slot_pose].reshape(*lead, J, -1, 6)
    Hvl = lie._mv(Hll_p, vl) + torch.einsum("...joab,...joa->...jb", U4, vp_obs)
    return torch.cat([Hvp.reshape(*lead, -1), Hvl.reshape(*lead, -1)], dim=-1)


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
    the span is 1-D) and the projected model ``[..., 5]``: ``[B00, B01, B11,
    g0, g1]`` (per window of a batch)."""
    eps = 1e-30

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    b1 = g / torch.clamp(torch.sqrt(dot(g, g)), min=eps)[..., None]
    b2_raw = dx_gn - dot(dx_gn, b1)[..., None] * b1
    n2 = torch.sqrt(dot(b2_raw, b2_raw))
    degenerate = n2 <= 1e-7 * torch.clamp(torch.sqrt(dot(dx_gn, dx_gn)), min=eps)
    b2 = torch.where(degenerate[..., None], torch.zeros_like(b2_raw),
                     b2_raw / torch.clamp(n2, min=eps)[..., None])
    Hb1, Hb2 = hvp(b1), hvp(b2)
    one = torch.ones_like(n2)
    model = torch.stack([
        dot(b1, Hb1),
        0.5 * (dot(b1, Hb2) + dot(b2, Hb1)),
        torch.where(degenerate, one, dot(b2, Hb2)),
        dot(b1, g),
        torch.where(degenerate, 0.0 * one, dot(b2, g)),
    ], dim=-1)
    return b1, b2, model


def blocks_dogleg_loop(layout, state0, config: lm.SolveConfig, init_radius: float = 1e4):
    """Subspace-dogleg loops of B windows in lockstep (``window.BatchLayout``;
    one window alone: ``window.as_batch``), carrying the candidates' factor
    blocks (one K1 launch per iteration for all of them), each window with
    its own radius and stopping rule. Returns ``(state, summaries,
    blocks_at_state)``."""
    terms = layout.terms
    blocks, cost_t = window_mod.total_blocks(layout, state0)
    ch = window_mod._Chains(config, state0, blocks, cost_t)
    radius = [init_radius] * ch.B
    while any(ch.active):
        state, blocks = ch.state, ch.blocks
        Hpp_aux, gp_aux = window_mod._masked_aux_blocks(terms, state, ch.dtype)
        Hpp = blocks.Hpp + Hpp_aux
        gp = blocks.gp + gp_aux
        Hpp_p, Hll_p = window_mod._pin(Hpp), window_mod._pin(blocks.Hll)

        # Gauss-Newton step from the undamped Schur solve; a failed
        # (indefinite) solve degrades to steepest descent
        dx_gn, grad_norm_t, _ = window_mod.schur_solve(
            Hpp, blocks.Hll, blocks.U_jo, gp, blocks.gl, layout.w_idx, 0.0)
        g = torch.cat([gp.flatten(-2), blocks.gl.flatten(-2)], dim=-1)
        dx_gn = torch.where(torch.all(torch.isfinite(dx_gn), dim=-1, keepdim=True), dx_gn, -g)

        def hvp(v, Hpp_p=Hpp_p, Hll_p=Hll_p, U_jo=blocks.U_jo):
            return block_hvp(Hpp_p, Hll_p, U_jo, layout.slot_pose, layout.pose_slots, v)

        b1, b2, model = _subspace_basis(g, dx_gn, hvp)
        steps = [subspace_solution(*m, radius[b]) if ch.active[b] else (0.0, 0.0, math.nan)
                 for b, m in enumerate(model.tolist())]
        y = torch.tensor([s[:2] for s in steps], dtype=ch.dtype).to(ch.device)
        dx = y[:, :1] * b1 + y[:, 1:] * b2
        dx_ok_t = torch.all(torch.isfinite(dx), dim=-1)
        dx = torch.where(dx_ok_t[:, None], dx, torch.zeros_like(dx))
        new_state = dense._retract_state(terms, state, dx)
        new_blocks, new_cost_t = window_mod.total_blocks(layout, new_state)
        stats = torch.stack([
            grad_norm_t, new_cost_t, dx_ok_t.to(ch.dtype), torch.sqrt(torch.sum(dx * dx, dim=-1)),
            dx.abs().amax(dim=-1),
        ], dim=-1).tolist()
        for b, (grad_norm, new_cost, dx_ok, step_norm, dx_max) in enumerate(stats):
            if not ch.active[b]:
                continue
            ch.grad_norm[b] = grad_norm
            accept, actual = ch.accept_test(b, new_cost)
            rho = actual / max(steps[b][2], 1e-30)
            if not accept:
                new_radius = radius[b] * 0.25
            elif rho > 0.75:
                new_radius = max(radius[b], 3.0 * step_norm)
            elif rho < 0.25:
                new_radius = radius[b] * 0.5
            else:
                new_radius = radius[b]
            small = accept and actual >= 0.0 and actual <= config.ftol * max(ch.cost[b], 1e-30)
            radius[b] = min(max(new_radius, 1e-12), 1e12)
            done = (small or grad_norm <= config.gtol or (dx_ok and dx_max <= config.xtol)
                    or radius[b] <= 1e-11)
            ch.record(b, accept, new_cost, radius[b], done)  # the radius in the lambda slot
        ch.advance(new_state, new_blocks)
    return ch.finish(radius)
