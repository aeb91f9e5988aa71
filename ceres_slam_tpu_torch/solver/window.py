"""Scatter-free explicit-Schur window solver.

Port of ``ceres_slam_tpu/solver/window.py``. Observations are reordered
landmark-grouped and padded to ``[J, O]`` slots (``M = J*O``) on the host,
once per window; every landmark-side reduction is then a contiguous
reshape-sum. The pose side, which the TPU version reduced with one-hot MXU
matmuls, is a gather by each slot's pose, and a sum by pose goes through
the layout's by-pose gather table (``pose_slots``) and a reduction over a
fixed axis, and so does the dense coupling ``W``, through a by-pair table
(``w_idx``): no float sum on the card depends on the order of atomics
(ROADMAP F14). The damped step is

    S = Hpp_d (block diag) - W C^{-1} W^T,   dense Cholesky on S (6K x 6K),
    landmarks back-substituted,

with the Schur reduce, the Cholesky and the covariance in float64 (the
flagship's 1e-12 prior makes S span ~12 orders of magnitude).

Every trust-region iteration runs the K1 factor pass
(``ops/window_kernel.window_factor_blocks``) exactly once: the candidate
state's pass is both its cost evaluation and, on acceptance, the next
iteration's normal equations.

The loops are Python loops whose trust-region control (accept test,
damping or radius, termination) runs on the host in float64 on a few
scalars read from the device: one read per LM iteration, two per dogleg
iteration (``solver/dogleg.py``), plus one for the initial cost.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import lie, window_kernel
from ceres_slam_tpu_torch.solver import dense, lm


class WindowLayout(NamedTuple):
    """Landmark-grouped observation layout of one window problem.

    ``problem`` carries the stereo observations reordered into ``M = J*O``
    slots (padding slots: valid False, pose 0). ``plan`` holds the K1
    kernel's inputs fixed over the window (slot poses, per-slot records
    with weight = valid & point_valid and pose_free = ~fixed_pose[pose],
    the slots sorted by pose), checked once. ``pose_slots`` lists each
    pose's slots in pose order, padded with ``M`` (the index of a zero row
    that a sum appends), for the fixed-order sums by pose."""

    problem: dense.StereoBAProblem
    O: int
    slot_pose: torch.Tensor  # [M] int64, K for padding slots
    w_idx: torch.Tensor  # [K*J, D] int64: row k*J + j lists pair (k, j)'s slots, padded with M
    plan: window_kernel.WindowPlan
    pose_slots: torch.Tensor | None = None  # [K, P] int64: pose k's slots, padded with M


def gather_table(ids: np.ndarray, n: int) -> np.ndarray:
    """``[n, D]`` gather table of ``ids [M]`` for ``dense.gather_sum``, built
    on the host: row b lists the positions m with ``ids[m] == b`` in
    increasing order, padded with ``M`` (ids outside ``[0, n)`` are left
    out); ``D`` is the largest count (at least 1)."""
    M = ids.size
    on = np.nonzero((ids >= 0) & (ids < n))[0]
    order = on[np.argsort(ids[on], kind="stable")]
    counts = np.bincount(ids[on], minlength=n)
    rank = np.arange(order.size) - np.concatenate([[0], np.cumsum(counts)])[ids[order]]
    table = np.full((n, max(1, int(counts.max(initial=0)))), M, np.int64)
    table[ids[order], rank] = order
    return table


def build_window_layout(problem: dense.StereoBAProblem, K: int, J: int,
                        O_pad: int | None = None, device=None) -> WindowLayout:
    """Reorder the valid stereo observations landmark-grouped and pad to
    ``[J, O]`` (``O_pad`` fixes O to a budget), and build K1's plan.
    Host-side numpy; the layout is placed on ``device`` (default: the
    problem's)."""
    st = problem.stereo
    device = device if device is not None else st.uvd.device
    pose_idx = st.pose_idx.cpu().numpy()
    point_idx = st.point_idx.cpu().numpy()
    valid = st.valid.cpu().numpy()

    vrows = np.nonzero(valid)[0]
    order = vrows[np.argsort(point_idx[vrows], kind="stable")]
    counts = np.bincount(point_idx[vrows], minlength=J)
    O = max(1, int(counts.max()))
    if O_pad is not None:
        if O > O_pad:
            raise ValueError(f"O_pad {O_pad} < required slots {O}")
        O = O_pad
    M = J * O
    landmark = point_idx[order]
    rank = np.arange(order.size) - np.concatenate([[0], np.cumsum(counts)])[landmark]
    flat = np.zeros(M, np.int64)
    wf = np.zeros(M, bool)
    flat[landmark * O + rank] = order
    wf[landmark * O + rank] = True

    slot_landmark = np.repeat(np.arange(J), O)
    p_idx = np.where(wf, pose_idx[flat], 0)
    v = wf & valid[flat]
    point_valid = problem.point_valid.cpu().numpy()
    fixed_pose = problem.fixed_pose_mask.cpu().numpy()
    dtype = st.uvd.dtype
    idx = torch.as_tensor(flat)
    uvd = st.uvd.cpu()[idx]
    stiff = st.stiffness.cpu()[idx]
    slot_pose = np.where(wf, pose_idx[flat], K)

    def put(x, dt=None):
        return torch.as_tensor(x, dtype=dt).to(device)

    stereo = dense.StereoObs(
        uvd=uvd.to(device), stiffness=stiff.to(device), pose_idx=put(p_idx, torch.int64),
        point_idx=put(slot_landmark, torch.int64), valid=put(v),
    )
    return WindowLayout(
        problem=dense.to_device(problem._replace(stereo=stereo), device),
        O=O,
        slot_pose=put(slot_pose, torch.int64),
        w_idx=put(gather_table(slot_pose * J + slot_landmark, K * J), torch.int64),
        plan=window_kernel.make_plan(
            problem.camera, K, J, np.where(wf, pose_idx[flat], -1), uvd, stiff,
            v & point_valid[slot_landmark], ~fixed_pose[p_idx], dtype, device),
        pose_slots=put(gather_table(slot_pose, K), torch.int64),
    )


class Blocks(NamedTuple):
    """Reduced block system from one factor pass (stereo only; the sun and
    prior pose blocks are added at solve time)."""

    Hpp: torch.Tensor  # [K, 6, 6]
    Hll: torch.Tensor  # [J, 3, 3]
    U_jo: torch.Tensor  # [J, O, 18]
    gp: torch.Tensor  # [K, 6]
    gl: torch.Tensor  # [J, 3]
    stereo_cost: torch.Tensor  # []


def factor_blocks(layout: WindowLayout, state: dense.BAState) -> Blocks:
    """One K1 factor pass -> reduced block system + stereo cost, all views
    of the kernel's outputs (nothing is launched after it)."""
    K, J, O = state.poses.shape[0], state.points.shape[0], layout.O
    hll, u, gl, hppgp, cost = window_kernel.window_factor_blocks(
        layout.plan, state.poses, state.points)
    return Blocks(
        Hpp=hppgp.narrow(1, 0, 36).view(K, 6, 6),
        Hll=hll.view(J, 3, 3),
        U_jo=u.view(J, O, 18),
        gp=hppgp.narrow(1, 36, 6),
        gl=gl,
        stereo_cost=cost,
    )


def _masked_aux_blocks(problem, state, dtype):
    """Sun + prior pose blocks with gauge masking applied (a fixed pose's
    blocks are exact zeros, whatever its sun or prior terms hold)."""
    Hpp_aux, gp_aux = dense.aux_pose_blocks(problem, state)
    free = ~problem.fixed_pose_mask
    zero = Hpp_aux.new_zeros(())
    return (torch.where(free[:, None, None], Hpp_aux, zero).to(dtype),
            torch.where(free[:, None], gp_aux, zero).to(dtype))


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def _pin(H: torch.Tensor) -> torch.Tensor:
    """Unit diagonal for all-zero diagonal blocks (fixed poses, invalid points)."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + torch.where(torch.all(d == 0.0, dim=-1)[:, None, None], eye, 0.0)


def _damp(H: torch.Tensor, lam: float) -> torch.Tensor:
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-12, 1e32)
    return H + lam * torch.diag_embed(d)


def _contract(X: torch.Tensor, w_idx: torch.Tensor, K: int, J: int) -> torch.Tensor:
    """``[J, O, 6, 3]`` slot blocks -> dense coupling ``[6K, 3J]``: block
    ``(k, j)`` is the sum of pair (k, j)'s slots, through the layout's
    by-pair table (one slot a pair but for repeated observations)."""
    out = dense.gather_sum(w_idx, X.reshape(-1, 18))
    return out.reshape(K, J, 6, 3).permute(0, 2, 1, 3).reshape(6 * K, 3 * J)


def _schur_reduce(Hpp, Hll, U_jo, w_idx, lam: float):
    """Pin empty diagonals, damp, eliminate the landmarks. Returns
    ``(S [6K,6K], Cinv [J,3,3], Wf [6K,3J], WCf [6K,3J], Hpp_pinned, Hll_pinned)``."""
    K, J = Hpp.shape[0], Hll.shape[0]
    Hpp = _pin(Hpp)
    Hll_p = _pin(Hll)
    Hpp_d = _damp(Hpp, lam)
    Cinv = _inv3x3(_damp(Hll_p, lam))
    U4 = U_jo.reshape(J, -1, 6, 3)
    Wf = _contract(U4, w_idx, K, J)
    WCf = _contract(U4 @ Cinv[:, None], w_idx, K, J)
    S = -(WCf @ Wf.T)
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    S = S.reshape(K, 6, K, 6) + eyeK[:, None, :, None] * Hpp_d[:, :, None, :]
    return S.reshape(6 * K, 6 * K), Cinv, Wf, WCf, Hpp, Hll_p


def _equilibrated_cho(S: torch.Tensor):
    """Jacobi-equilibrated Cholesky of S; returns ``solve(b) = S^{-1} b``.
    A failed factorization gives NaN (as ``jax.scipy`` does), which the
    loops treat as a rejected step — and no host synchronization."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-30))
    L = lm._cholesky_or_nan(S * (s[:, None] * s[None, :]))

    def solve(b):
        sc = s[:, None] if b.ndim == 2 else s
        x = torch.cholesky_solve((b * sc).reshape(b.shape[0], -1), L)
        return x.reshape(b.shape) * sc

    return solve


def schur_solve(Hpp, Hll, U_jo, gp, gl, w_idx, lam: float):
    """Damped Gauss-Newton step by Schur elimination, computed in float64
    whatever the state dtype. Returns ``(dx, grad_norm, pred_decrease)``
    in the input dtype."""
    out_dtype = Hpp.dtype
    f64 = torch.float64
    Hpp, Hll, U_jo, gp, gl = (x.to(f64) for x in (Hpp, Hll, U_jo, gp, gl))
    K, J = Hpp.shape[0], Hll.shape[0]
    S, Cinv, Wf, WCf, Hpp_p, Hll_p = _schur_reduce(Hpp, Hll, U_jo, w_idx, lam)
    rhs = -(gp.reshape(-1) - WCf @ gl.reshape(-1))
    dp = _equilibrated_cho(S)(rhs)
    dl = -lie._mv(Cinv, gl + (Wf.T @ dp).reshape(J, 3))
    dx = torch.cat([dp, dl.reshape(-1)])
    grad_norm = torch.maximum(gp.abs().max(), gl.abs().max())
    dp_r = dp.reshape(K, 6)
    g_dot_dx = torch.sum(gp * dp_r) + torch.sum(gl * dl)
    dxHdx = (
        torch.einsum("ka,kab,kb->", dp_r, Hpp_p, dp_r)
        + 2.0 * torch.dot(dp, Wf @ dl.reshape(-1))
        + torch.einsum("ja,jab,jb->", dl, Hll_p, dl)
    )
    pred = -(g_dot_dx + 0.5 * dxHdx)
    return dx.to(out_dtype), grad_norm.to(out_dtype), pred.to(out_dtype)


def pose_marginal_covariance(Hpp, Hll, U_jo, w_idx, pose_idx: int):
    """6x6 tangent marginal covariance of pose ``pose_idx``: the block
    ``(S^{-1})_kk`` of the undamped reduced camera matrix."""
    K = Hpp.shape[0]
    S, *_ = _schur_reduce(Hpp, Hll, U_jo, w_idx, 0.0)
    E = torch.zeros((6 * K, 6), dtype=S.dtype, device=S.device)
    E[6 * pose_idx: 6 * pose_idx + 6] = torch.eye(6, dtype=S.dtype, device=S.device)
    X = _equilibrated_cho(S)(E)
    return X[6 * pose_idx: 6 * pose_idx + 6]


def total_blocks_fn(layout: WindowLayout):
    """``state -> (blocks, total_cost)``: one K1 pass plus the sun/prior cost."""
    problem = layout.problem

    def total(state):
        b = factor_blocks(layout, state)
        return b, b.stereo_cost + dense.ba_cost_aux(problem, state).to(b.stereo_cost.dtype)

    return total


def blocks_lm_loop(layout: WindowLayout, state0: dense.BAState, config: lm.SolveConfig):
    """Block-carrying Levenberg-Marquardt loop (one factor pass per
    iteration). Returns ``(state, summary, blocks_at_state)``."""
    problem = layout.problem
    total_blocks = total_blocks_fn(layout)
    history = lm.History(config)
    blocks, cost_t = total_blocks(state0)
    dtype = cost_t.dtype
    cost0 = cost = float(cost_t)
    state, lam, grad_norm, it = state0, config.init_lambda, math.inf, 0
    cost_buf = [cost0] * config.nonmonotonic_window
    best = (state, blocks, cost)
    while it < config.max_iters:
        Hpp_aux, gp_aux = _masked_aux_blocks(problem, state, dtype)
        dx, grad_norm_t, pred_t = schur_solve(
            blocks.Hpp + Hpp_aux, blocks.Hll, blocks.U_jo, blocks.gp + gp_aux, blocks.gl,
            layout.w_idx, lam)
        dx_ok_t = torch.all(torch.isfinite(dx))
        dx = torch.where(dx_ok_t, dx, torch.zeros_like(dx))
        new_state = dense._retract_state(problem, state, dx)
        new_blocks, new_cost_t = total_blocks(new_state)
        grad_norm, pred, new_cost, dx_ok, dx_max = torch.stack(
            [grad_norm_t, pred_t, new_cost_t, dx_ok_t.to(dtype), dx.abs().max()]).tolist()

        actual = cost - new_cost
        rho = actual / max(pred, 1e-30)
        accept_ref = max(cost_buf) if config.nonmonotonic else cost
        accept = math.isfinite(new_cost) and new_cost < accept_ref
        small = accept and actual >= 0.0 and actual <= config.ftol * max(cost, 1e-30)
        done = (small or grad_norm <= config.gtol or (dx_ok and dx_max <= 1e-14)
                or lam >= config.max_lambda)
        if accept:
            lam = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), config.min_lambda)
            state, blocks, cost = new_state, new_blocks, new_cost
            cost_buf[it % config.nonmonotonic_window] = new_cost
            if new_cost < best[2]:
                best = (new_state, new_blocks, new_cost)
        else:
            lam = min(lam * 4.0, config.max_lambda)
        history.add(it, cost, lam, grad_norm, accept)
        it += 1
        if done:
            break
    if config.nonmonotonic:
        state, blocks, cost = best
    return state, history.summary(it, cost0, cost, grad_norm, lam), blocks


def _run_loop(layout, state0, config, strategy):
    if strategy == "dogleg":
        from ceres_slam_tpu_torch.solver import dogleg

        return dogleg.blocks_dogleg_loop(layout, state0, config)
    if strategy != "lm":
        raise ValueError(f"unknown trust-region strategy: {strategy!r}")
    return blocks_lm_loop(layout, state0, config)


def solve_ba_window_with_covariance(problem, state0, pose_idx: int,
                                    config: lm.SolveConfig = lm.SolveConfig(),
                                    strategy: str = "lm", O_pad: int | None = None):
    """Window solve + the 6x6 tangent marginal covariance of pose
    ``pose_idx`` from the final iterate's blocks (float64, cast back to
    the state dtype). Returns ``(state, summary, cov)``."""
    K, J = state0.poses.shape[0], state0.points.shape[0]
    layout = build_window_layout(problem, K, J, O_pad, device=state0.poses.device)
    state, summary, blocks = _run_loop(layout, state0, config, strategy)
    f64 = torch.float64
    Hpp_aux, _ = _masked_aux_blocks(layout.problem, state, f64)
    cov = pose_marginal_covariance(
        blocks.Hpp.to(f64) + Hpp_aux, blocks.Hll.to(f64), blocks.U_jo.to(f64),
        layout.w_idx, pose_idx)
    return state, summary, cov.to(state.poses.dtype)
