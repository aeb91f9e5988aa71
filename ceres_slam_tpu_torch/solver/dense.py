"""Problem containers, the BA cost and the dense Levenberg-Marquardt solve.

Port of ``ceres_slam_tpu/solver/dense.py``. Structure that is fixed for one
problem (camera, Huber parameter, sun thresholds, which pose carries the
prior and whether it is on) is held as Python scalars; everything indexed
by observation, pose or landmark is a tensor.

Every mask is a ``torch.where``, never a product with the mask: an
invalid row may hold an uninitialized landmark at the origin seen from a
pose at the origin (z = 0), whose residual is not finite, and eagerly
``NaN * 0`` is NaN (ROADMAP F9, F15). Sums by pose, landmark or pair go
through a gather table and a reduction over a fixed axis
(``segment_sum``), so they are bit-reproducible on the card too (F14).
The dense solve (``solve_ba``, LM or Powell's dogleg) is for windows and
small batches; ``solver/schur.py`` eliminates the landmarks and
``solver/pcg.py`` covers full-batch BA. The tangent covariance of a pose is
a Cholesky solve against unit columns (``_marginal_block``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver import loss as loss_mod


class StereoObs(NamedTuple):
    uvd: torch.Tensor  # [N, 3]
    stiffness: torch.Tensor  # [N, 3, 3]
    pose_idx: torch.Tensor  # [N] int
    point_idx: torch.Tensor  # [N] int
    valid: torch.Tensor  # [N] bool


class SunObs(NamedTuple):
    dir_c: torch.Tensor  # [K, 3] observed sun dir, camera frame (unit)
    dir_g: torch.Tensor  # [K, 3] ephemeris sun dir, global frame (unit)
    stiffness: torch.Tensor  # [K, 2, 2]
    valid: torch.Tensor  # [K] bool


class PosePrior(NamedTuple):
    pose_idx: int
    T_ref: torch.Tensor  # [12]
    stiffness: torch.Tensor  # [6, 6]
    valid: bool


class StereoBAProblem(NamedTuple):
    camera: StereoCamera
    stereo: StereoObs
    sun: SunObs
    prior: PosePrior
    fixed_pose_mask: torch.Tensor  # [K] bool — gauge fixing
    point_valid: torch.Tensor  # [J] bool
    sun_huber: float  # 0 => no robust loss
    az_err_thresh: float  # radians
    zen_err_thresh: float  # radians


class BAState(NamedTuple):
    poses: torch.Tensor  # [K, 12]
    points: torch.Tensor  # [J, 3]


def to_device(x, device):
    """Move every tensor of a (nested) NamedTuple to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


def _sun_terms(problem: StereoBAProblem, state: BAState):
    p = problem
    r_sun, J_sun = factors.sun_sensor(
        state.poses, p.sun.dir_c, p.sun.dir_g, p.sun.stiffness,
        az_err_thresh=p.az_err_thresh, zen_err_thresh=p.zen_err_thresh,
    )
    return r_sun, J_sun, torch.sum(r_sun * r_sun, dim=-1)


def _prior_terms(problem: StereoBAProblem, state: BAState):
    pr = problem.prior
    return factors.pose_prior(state.poses[pr.pose_idx], pr.T_ref, pr.stiffness)


def ba_cost_aux(problem: StereoBAProblem, state: BAState) -> torch.Tensor:
    """Sun + prior cost only (the stereo cost comes out of the window factor
    pass). Its gates are Python tests of the problem's settings: a setting
    held as a device tensor is read from the host here (``aux_cost`` of
    ``aux_terms`` selects on the device instead)."""
    r_sun, _, sq = _sun_terms(problem, state)
    rho = loss_mod.huber_rho(sq, problem.sun_huber) if problem.sun_huber > 0.0 else sq
    cost = torch.sum(torch.where(problem.sun.valid, rho, 0.0))
    if problem.prior.valid:
        r_pr, _ = _prior_terms(problem, state)
        cost = cost + torch.sum(r_pr * r_pr)
    return 0.5 * cost


def aux_pose_blocks(problem: StereoBAProblem, state: BAState):
    """Sun + pose-prior contributions to the pose diagonal blocks:
    ``(Hpp_add [K, 6, 6], gp_add [K, 6])``."""
    r_sun, J_sun, sq = _sun_terms(problem, state)
    if problem.sun_huber > 0.0:
        w = loss_mod.huber_weight(sq, problem.sun_huber)
        r_sun, J_sun = r_sun * w[:, None], J_sun * w[:, None, None]
    valid = problem.sun.valid
    r_sun = torch.where(valid[:, None], r_sun, 0.0)
    J_sun = torch.where(valid[:, None, None], J_sun, 0.0)
    Hpp = J_sun.transpose(-1, -2) @ J_sun
    gp = lie._mv(J_sun.transpose(-1, -2), r_sun)
    if problem.prior.valid:
        r_pr, J_pr = _prior_terms(problem, state)
        k = problem.prior.pose_idx
        Hpp[k] += J_pr.T @ J_pr
        gp[k] += J_pr.T @ r_pr
    return Hpp, gp


def _retract_state(problem, state: BAState, dx: torch.Tensor) -> BAState:
    """Apply the tangent step ``dx [..., 6K + 3J]`` (a leading batch axis
    allowed): fixed poses and invalid landmarks stay. ``problem`` is anything
    with ``fixed_pose_mask [..., K]`` and ``point_valid [..., J]``."""
    lead, K = state.poses.shape[:-2], state.poses.shape[-2]
    J = state.points.shape[-2]
    d_pose = torch.where(problem.fixed_pose_mask[..., None], 0.0,
                         dx[..., : 6 * K].reshape(*lead, K, 6))
    d_pt = torch.where(problem.point_valid[..., None], dx[..., 6 * K:].reshape(*lead, J, 3), 0.0)
    return BAState(poses=lie.se3_retract(state.poses, d_pose), points=state.points + d_pt)


class AuxTerms(NamedTuple):
    """The sun and pose-prior terms of a window problem, or of B window
    problems solved together (leading axes ``...``: none, or ``[B]``), with
    the per-problem settings as tensors: the problems of one batch may
    differ in them. Every setting is selected with ``torch.where``, so one
    problem's terms are computed the same way, to the bit, alone or in a
    batch."""

    sun: SunObs  # [..., K, 3], [..., K, 3], [..., K, 2, 2], [..., K]
    prior: PosePrior  # pose_idx int; T_ref [..., 12]; stiffness [..., 6, 6]; valid [...] bool
    fixed_pose_mask: torch.Tensor  # [..., K] bool
    point_valid: torch.Tensor  # [..., J] bool
    sun_huber: torch.Tensor  # [...], 0 = no robust loss
    az_err_thresh: torch.Tensor  # [...] radians
    zen_err_thresh: torch.Tensor  # [...] radians


def aux_terms(problem: StereoBAProblem) -> AuxTerms:
    """One problem's sun and prior terms as ``AuxTerms`` (no leading axis),
    the settings on the problem's device in its dtype. It reads the prior's
    validity on the host and copies the settings to the device: make the
    terms once, before a loop that a CUDA graph captures."""
    dt, dev = problem.sun.dir_c.dtype, problem.sun.dir_c.device
    pr = problem.prior
    valid = torch.tensor(bool(pr.valid), device=dev)
    setting = torch.tensor([problem.sun_huber, problem.az_err_thresh, problem.zen_err_thresh],
                           dtype=dt, device=dev)
    return AuxTerms(problem.sun, pr._replace(T_ref=pr.T_ref.to(dev), stiffness=pr.stiffness.to(dev),
                                             valid=valid),
                    problem.fixed_pose_mask, problem.point_valid, *setting.unbind())


def _aux_residuals(terms: AuxTerms, state: BAState):
    """Sun residuals and Jacobians ``[..., K, 2(, 6)]`` with their squared
    norms, and the prior's ``[..., 1, 6(, 6)]`` on its pose (kept on a pose
    axis of one, so that its products batch the same way with or without a
    leading axis)."""
    sun = terms.sun
    r_sun, J_sun = factors.sun_sensor(
        state.poses, sun.dir_c, sun.dir_g, sun.stiffness,
        az_err_thresh=terms.az_err_thresh[..., None], zen_err_thresh=terms.zen_err_thresh[..., None])
    k = terms.prior.pose_idx
    r_pr, J_pr = factors.pose_prior(state.poses[..., k:k + 1, :], terms.prior.T_ref[..., None, :],
                                    terms.prior.stiffness[..., None, :, :])
    return r_sun, J_sun, torch.sum(r_sun * r_sun, dim=-1), r_pr, J_pr


def aux_cost(terms: AuxTerms, state: BAState) -> torch.Tensor:
    """Sun + prior cost ``[...]`` (``ba_cost_aux`` per problem)."""
    _, _, sq, r_pr, _ = _aux_residuals(terms, state)
    h = terms.sun_huber[..., None]
    rho = torch.where(h > 0.0, loss_mod.huber_rho(sq, h), sq)
    cost = torch.sum(torch.where(terms.sun.valid, rho, 0.0), dim=-1)
    cost = cost + torch.where(terms.prior.valid, torch.sum(r_pr * r_pr, dim=(-2, -1)), 0.0)
    return 0.5 * cost


def aux_blocks(terms: AuxTerms, state: BAState):
    """Sun + prior pose blocks ``(Hpp [..., K, 6, 6], gp [..., K, 6])`` with
    the gauge mask applied: a fixed pose's blocks are exact zeros, whatever
    its sun or prior terms hold (``aux_pose_blocks`` per problem, masked)."""
    r_sun, J_sun, sq, r_pr, J_pr = _aux_residuals(terms, state)
    h = terms.sun_huber[..., None]
    w = torch.where(h > 0.0, loss_mod.huber_weight(sq, h), torch.ones_like(sq))
    r_sun, J_sun = r_sun * w[..., None], J_sun * w[..., None, None]
    valid = terms.sun.valid
    r_sun = torch.where(valid[..., None], r_sun, 0.0)
    J_sun = torch.where(valid[..., None, None], J_sun, 0.0)
    JT = J_sun.transpose(-1, -2)
    Hpp, gp = JT @ J_sun, lie._mv(JT, r_sun)
    k, on = terms.prior.pose_idx, terms.prior.valid
    JT_pr = J_pr.transpose(-1, -2)
    Hpp[..., k, :, :] += torch.where(on[..., None, None], (JT_pr @ J_pr)[..., 0, :, :], 0.0)
    gp[..., k, :] += torch.where(on[..., None], lie._mv(JT_pr, r_pr)[..., 0, :], 0.0)
    free = ~terms.fixed_pose_mask
    return (torch.where(free[..., None, None], Hpp, 0.0), torch.where(free[..., None], gp, 0.0))


def segment_table(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, O]`` gather table of ``idx [N]``: row b lists the rows of bin b
    in increasing order, padded with ``N``; ``O`` is the largest bin (one
    host read). Built on ``idx``'s device: a stable sort, integer counts
    and an indexed write of distinct targets, all deterministic."""
    N = idx.shape[0]
    order = torch.sort(idx, stable=True).indices
    counts = torch.bincount(idx, minlength=n)
    sorted_ids = idx[order]
    rank = torch.arange(N, device=idx.device) - (torch.cumsum(counts, 0) - counts)[sorted_ids]
    table = torch.full((n, max(1, int(counts.max()))), N, dtype=torch.int64, device=idx.device)
    table[sorted_ids, rank] = order
    return table


def gather_sum(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows [N, F]`` summed through a gather table ``[n, D]`` (entries
    ``N`` are padding) -> ``[n, F]``, in a fixed order: a gather (padding
    reads an appended zero row) and a sum over the table's slot axis. No
    float atomics, so the card gives the same bits every run."""
    rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return rows[table].sum(1)


def segment_sum(per_obs: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows of ``per_obs`` into ``n`` bins by ``idx``, in a fixed order
    (``gather_sum`` through ``segment_table``)."""
    rows = per_obs.reshape(per_obs.shape[0], -1)
    return gather_sum(segment_table(idx, n), rows).reshape((n,) + per_obs.shape[1:])


def stereo_valid(problem: StereoBAProblem) -> torch.Tensor:
    """``[N]`` bool: the observation is valid and its landmark initialized."""
    return problem.stereo.valid & problem.point_valid[problem.stereo.point_idx]


def stereo_sq_sum(problem: StereoBAProblem, state: BAState) -> torch.Tensor:
    """``sum |r|^2`` over the valid stereo rows (whitened residuals)."""
    st = problem.stereo
    p_c = lie.se3_transform_point(state.poses[st.pose_idx], state.points[st.point_idx])
    r = lie._mv(st.stiffness, problem.camera.project(p_c) - st.uvd)
    sq = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(stereo_valid(problem), sq, torch.zeros_like(sq)))


def ba_cost(problem: StereoBAProblem, state: BAState, terms: AuxTerms | None = None
            ) -> torch.Tensor:
    """Total cost ``1/2 sum rho(|r|^2)`` (stereo + sun + prior), Ceres's objective.
    With ``terms`` (``aux_terms(problem)``, made once, outside a loop) the
    sun and prior settings are tensors selected with ``torch.where``, so the
    cost never reads the device from the host, whatever the problem holds
    (a captured loop's cost, ``solver/pcg.py``)."""
    aux = ba_cost_aux(problem, state) if terms is None else aux_cost(terms, state)
    return 0.5 * stereo_sq_sum(problem, state) + aux


class BlockNormalEq(NamedTuple):
    """Block-sparse Gauss-Newton system: pose blocks, landmark blocks, the
    dense pose-landmark coupling ``W`` and the gradients."""

    Hpp: torch.Tensor  # [K, 6, 6]
    Hll: torch.Tensor  # [J, 3, 3]
    W: torch.Tensor  # [K, J, 6, 3]
    gp: torch.Tensor  # [K, 6]
    gl: torch.Tensor  # [J, 3]


def stereo_block_contrib(camera: StereoCamera, stereo: StereoObs, point_valid: torch.Tensor,
                         state: BAState) -> BlockNormalEq:
    """Stereo-factor contribution in block form (fixed-order segment sums
    by pose, by landmark and by (pose, landmark) pair)."""
    K, J = state.poses.shape[0], state.points.shape[0]
    r, J_pose, J_pt = factors.stereo_reprojection(
        camera, state.poses[stereo.pose_idx], state.points[stereo.point_idx], stereo.uvd,
        stereo.stiffness)
    valid = stereo.valid & point_valid[stereo.point_idx]
    r = torch.where(valid[:, None], r, torch.zeros_like(r))
    J_pose = torch.where(valid[:, None, None], J_pose, torch.zeros_like(J_pose))
    J_pt = torch.where(valid[:, None, None], J_pt, torch.zeros_like(J_pt))
    JpT, JlT = J_pose.transpose(1, 2), J_pt.transpose(1, 2)
    seg = segment_sum
    return BlockNormalEq(
        Hpp=seg(JpT @ J_pose, stereo.pose_idx, K),
        Hll=seg(JlT @ J_pt, stereo.point_idx, J),
        W=seg(JpT @ J_pt, stereo.pose_idx * J + stereo.point_idx, K * J).reshape(K, J, 6, 3),
        gp=seg(lie._mv(JpT, r), stereo.pose_idx, K),
        gl=seg(lie._mv(JlT, r), stereo.point_idx, J),
    )


def blocks_to_dense(blocks: BlockNormalEq):
    """The dense tangent ``(H [D, D], g [D])`` of the block system, pose k at
    rows ``6k..6k+5`` and landmark j at ``6K + 3j..6K + 3j + 2``."""
    K, J = blocks.Hpp.shape[0], blocks.Hll.shape[0]
    H = torch.zeros((6 * K + 3 * J, 6 * K + 3 * J), dtype=blocks.Hpp.dtype,
                    device=blocks.Hpp.device)
    H[: 6 * K, : 6 * K] = torch.block_diag(*blocks.Hpp)
    H[6 * K:, 6 * K:] = torch.block_diag(*blocks.Hll)
    W = blocks.W.permute(0, 2, 1, 3).reshape(6 * K, 3 * J)
    H[: 6 * K, 6 * K:] = W
    H[6 * K:, : 6 * K] = W.T
    return H, torch.cat([blocks.gp.reshape(-1), blocks.gl.reshape(-1)])


def ba_block_normal_equations(problem: StereoBAProblem, state: BAState) -> BlockNormalEq:
    """Full block-sparse Gauss-Newton system (stereo + sun + prior)."""
    blocks = stereo_block_contrib(problem.camera, problem.stereo, problem.point_valid, state)
    Hpp_aux, gp_aux = aux_pose_blocks(problem, state)
    return blocks._replace(Hpp=blocks.Hpp + Hpp_aux, gp=blocks.gp + gp_aux)


def apply_gauge_mask(problem: StereoBAProblem, H: torch.Tensor, g: torch.Tensor):
    """Constant-parameter masking (zero rows and columns of fixed poses and
    invalid landmarks) and a unit diagonal wherever the diagonal is zero —
    the tangent equivalent of ``SetParameterBlockConstant``."""
    free = torch.cat([(~problem.fixed_pose_mask).repeat_interleave(6),
                      problem.point_valid.repeat_interleave(3)])
    H = torch.where(free[:, None] & free[None, :], H, 0.0)
    diag = torch.diagonal(H)
    return H + torch.diag((diag == 0.0).to(H.dtype)), torch.where(free, g, 0.0)


def ba_normal_equations(problem: StereoBAProblem, state: BAState):
    """The gauge-masked dense tangent normal equations ``(H, g)``."""
    H, g = blocks_to_dense(ba_block_normal_equations(problem, state))
    return apply_gauge_mask(problem, H, g)


def lm_minimize(problem: StereoBAProblem, state0: BAState, config: lm.SolveConfig,
                normal_eq_fn=ba_normal_equations):
    """LM with the dense damped Cholesky step of ``normal_eq_fn``."""
    return lm.lm_solve(
        state0, config, lambda s: ba_cost(problem, s),
        lm.dense_cholesky_step(lambda s: normal_eq_fn(problem, s)),
        lambda s, dx: _retract_state(problem, s, dx))


def solve_ba(problem: StereoBAProblem, state0: BAState,
             config: lm.SolveConfig = lm.SolveConfig(), strategy: str = "lm"):
    """Minimize the BA cost on the dense system (``ceres::Solve`` with
    DENSE_SCHUR's role at window scale): ``strategy`` ``'lm'``
    (Levenberg-Marquardt) or ``'dogleg'`` (Powell's dogleg, the reference's
    ceres::DOGLEG). Returns ``(state, SolveSummary)``."""
    if strategy == "dogleg":
        return lm.dogleg_solve(state0, config, lambda s: ba_cost(problem, s),
                               lambda s: ba_normal_equations(problem, s),
                               lambda s, dx: _retract_state(problem, s, dx))
    if strategy != "lm":
        raise ValueError(f"unknown strategy: {strategy!r}")
    return lm_minimize(problem, state0, config)


def _marginal_block(H: torch.Tensor, base: int, d: int = 6) -> torch.Tensor:
    """``(H^-1)[base:base+d, base:base+d]`` by a Cholesky solve against the
    ``d`` unit columns ``base..base+d-1``; all NaN when ``H`` is not
    positive definite."""
    E = torch.zeros((H.shape[0], d), dtype=H.dtype, device=H.device)
    E[base:base + d] = torch.eye(d, dtype=H.dtype, device=H.device)
    return torch.cholesky_solve(E, lm._cholesky_or_nan(H))[base:base + d]


def solve_ba_with_covariance(problem: StereoBAProblem, state0: BAState, pose_idx: int,
                             config: lm.SolveConfig = lm.SolveConfig()):
    """The LM solve, then the tangent covariance of pose ``pose_idx`` at the
    solution: ``(state, SolveSummary, cov [6, 6])``."""
    sol, summary = lm_minimize(problem, state0, config)
    return sol, summary, pose_tangent_covariance(problem, sol, pose_idx)


def pose_tangent_covariance(problem: StereoBAProblem, state: BAState,
                            pose_idx: int) -> torch.Tensor:
    """6x6 tangent marginal covariance of one pose (Ceres'
    ``GetCovarianceBlockInTangentSpace``): its diagonal block of ``H^-1``,
    ``H`` the gauge-masked Gauss-Newton Hessian at ``state``."""
    H, _ = ba_normal_equations(problem, state)
    return _marginal_block(H, 6 * int(pose_idx))
