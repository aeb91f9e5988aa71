"""Subspace-dogleg trust region over the window solver's block system.

Port of ``ceres_slam_tpu/solver/dogleg.py`` — Ceres's SUBSPACE_DOGLEG with
nonmonotonic steps, the reference flagship's minimizer: the quadratic model
is minimized exactly over span{gradient, Gauss-Newton step} within the
trust radius.

As in the JAX package, everything runs on the device: the Gauss-Newton
step (the undamped Schur solve), the subspace basis and the two
Hessian-vector products, and the 2x2 subproblem with its More-Sorensen
boundary solve (``ops/subspace_kernel.subspace_step``: a kernel on the
card, its plain version on the CPU). ``dogleg_body`` is one iteration of B
windows on ``window.Carry``; ``blocks_dogleg_loop`` runs it on the card in
a WHILE node or on the host (``window.run_loop``).
"""

from __future__ import annotations

import torch

from ceres_slam_tpu_torch.ops import lie, subspace_kernel
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


def subspace_step(g, dx_gn, hvp, radius):
    """The SUBSPACE_DOGLEG step (``ceres_slam_tpu/solver/dogleg.py::
    subspace_step``): the model minimized exactly over span{g, dx_gn}
    within ``radius``, for one window or a batch (leading axes; ``radius``
    one per window). ``hvp(v)`` applies the (pinned, masked) model Hessian.
    Returns ``(dx, pred_decrease)``."""
    b1, b2, model = _subspace_basis(g, dx_gn, hvp)
    lead = model.shape[:-1]
    radius = torch.as_tensor(radius, dtype=model.dtype, device=model.device)
    y = subspace_kernel.subspace_step(model.reshape(-1, 5).contiguous(),
                                      radius.expand(lead).reshape(-1).contiguous()).reshape(
        *lead, 3)
    return y[..., :1] * b1 + y[..., 1:2] * b2, y[..., 2]


def dogleg_body(layout, config: lm.SolveConfig, c):
    """One subspace-dogleg iteration of every window still running
    (``ceres_slam_tpu/solver/dogleg.py::blocks_dogleg_loop``'s body) on a
    ``window.Carry`` whose ``lam`` is the trust radius: the Gauss-Newton
    step from the undamped Schur solve (steepest descent where it fails),
    the subspace step, one K1 pass on the candidate, the accept test and
    the radius rules. Pure: ``c`` is left as it was."""
    on = window_mod.active(c, config)
    b = c.blocks
    Hpp_aux, gp_aux = window_mod._masked_aux_blocks(layout.terms, c.state, c.cost.dtype)
    Hpp, gp = b.Hpp + Hpp_aux, b.gp + gp_aux
    Hpp_p, Hll_p = window_mod._pin(Hpp), window_mod._pin(b.Hll)
    dx_gn, grad_norm, _ = window_mod.schur_solve(Hpp, b.Hll, b.U_jo, gp, b.gl, layout.w_idx, 0.0)
    g = torch.cat([gp.flatten(-2), b.gl.flatten(-2)], dim=-1)
    dx_gn = torch.where(torch.all(torch.isfinite(dx_gn), dim=-1, keepdim=True), dx_gn, -g)

    def hvp(v):
        return block_hvp(Hpp_p, Hll_p, b.U_jo, layout.slot_pose, layout.pose_slots, v)

    dx, pred = subspace_step(g, dx_gn, hvp, c.lam)
    dx_ok = torch.all(torch.isfinite(dx), dim=-1)
    dx = torch.where(dx_ok[:, None], dx, 0.0)
    new_state = dense._retract_state(layout.terms, c.state, dx)
    new_blocks, new_cost = window_mod.total_blocks(layout, new_state)
    accept, _, rho, small = window_mod.accept_test(c, config, new_cost, pred)
    step_norm = torch.sqrt(torch.sum(dx * dx, dim=-1))
    radius = torch.where(rho > 0.75, torch.maximum(c.lam, 3.0 * step_norm),
                         torch.where(rho < 0.25, c.lam * 0.5, c.lam))
    radius = torch.clamp(torch.where(accept, radius, c.lam * 0.25), 1e-12, 1e12)
    done = (small | (grad_norm <= config.gtol)
            | (dx_ok & (dx.abs().amax(dim=-1) <= config.xtol)) | (radius <= 1e-11))
    if config.run_full_budget:
        done = torch.zeros_like(done)
    # the radius in the damping's slot, as the JAX history records it
    return window_mod.advance(c, config, on, accept, new_state, new_blocks, new_cost, radius,
                              grad_norm, done)


def blocks_dogleg_loop(layout, state0, config: lm.SolveConfig, init_radius: float = 1e4,
                       loop: str | None = None, graph=None):
    """Subspace-dogleg loops of B windows in lockstep (``window.BatchLayout``),
    carrying the candidates' factor blocks (one K1 launch per iteration for
    all of them), each window with its own radius and stopping rule, on the
    card or on the host (``window.run_loop``'s ``loop`` and ``graph``).
    Returns ``(state, stats, blocks_at_state)``."""
    return window_mod.run_loop(layout, state0, config, "dogleg", loop, graph, init_radius)
