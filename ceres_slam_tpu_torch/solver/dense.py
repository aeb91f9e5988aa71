"""Problem containers, the BA cost and the dense Levenberg-Marquardt solve.

Port of ``ceres_slam_tpu/solver/dense.py``. Structure that is fixed for one
problem (camera, Huber parameter, sun thresholds, which pose carries the
prior and whether it is on) is held as Python scalars; everything indexed
by observation, pose or landmark is a tensor.

Masked stereo rows are dropped with ``torch.where``, never multiplied by
the mask: an invalid row may hold an uninitialized landmark at the origin
seen from a pose at the origin (z = 0), whose residual is not finite, and
eagerly ``NaN * 0`` is NaN (ROADMAP F9). The dense solve (``solve_ba``) is
for windows and small batches; ``solver/pcg.py`` covers full-batch BA.
``dogleg_solve`` (``strategy="dogleg"``) and the covariance helpers of the
JAX module are not ported yet.
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
    """Sun + prior cost only (the stereo cost comes out of the window factor pass)."""
    r_sun, _, sq = _sun_terms(problem, state)
    rho = loss_mod.huber_rho(sq, problem.sun_huber) if problem.sun_huber > 0.0 else sq
    r_pr, _ = _prior_terms(problem, state)
    dtype = state.poses.dtype
    return 0.5 * (
        torch.sum(rho * problem.sun.valid.to(dtype))
        + torch.sum(r_pr * r_pr) * float(problem.prior.valid)
    )


def aux_pose_blocks(problem: StereoBAProblem, state: BAState):
    """Sun + pose-prior contributions to the pose diagonal blocks:
    ``(Hpp_add [K, 6, 6], gp_add [K, 6])``."""
    r_sun, J_sun, sq = _sun_terms(problem, state)
    dtype = state.poses.dtype
    w = problem.sun.valid.to(dtype)
    if problem.sun_huber > 0.0:
        w = w * loss_mod.huber_weight(sq, problem.sun_huber)
    r_sun = r_sun * w[:, None]
    J_sun = J_sun * w[:, None, None]
    Hpp = J_sun.transpose(-1, -2) @ J_sun
    gp = lie._mv(J_sun.transpose(-1, -2), r_sun)

    r_pr, J_pr = _prior_terms(problem, state)
    wp = float(problem.prior.valid)
    k = problem.prior.pose_idx
    Hpp = Hpp.clone()
    gp = gp.clone()
    Hpp[k] += wp * (J_pr.T @ J_pr)
    gp[k] += wp * (J_pr.T @ r_pr)
    return Hpp, gp


def _retract_state(problem: StereoBAProblem, state: BAState, dx: torch.Tensor) -> BAState:
    K = state.poses.shape[0]
    J = state.points.shape[0]
    d_pose = dx[: 6 * K].reshape(K, 6) * (~problem.fixed_pose_mask)[:, None].to(dx.dtype)
    d_pt = dx[6 * K:].reshape(J, 3) * problem.point_valid[:, None].to(dx.dtype)
    return BAState(poses=lie.se3_retract(state.poses, d_pose), points=state.points + d_pt)


def segment_sum(per_obs: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows of ``per_obs`` into ``n`` bins by ``idx`` (``index_add_``)."""
    out = torch.zeros((n,) + per_obs.shape[1:], dtype=per_obs.dtype, device=per_obs.device)
    return out.index_add_(0, idx, per_obs)


def stereo_valid(problem: StereoBAProblem) -> torch.Tensor:
    """``[N]`` bool: the observation is valid and its landmark initialized."""
    return problem.stereo.valid & problem.point_valid[problem.stereo.point_idx]


def ba_cost(problem: StereoBAProblem, state: BAState) -> torch.Tensor:
    """Total cost ``1/2 sum rho(|r|^2)`` (stereo + sun + prior), Ceres's objective."""
    st = problem.stereo
    p_c = lie.se3_transform_point(state.poses[st.pose_idx], state.points[st.point_idx])
    r = lie._mv(st.stiffness, problem.camera.project(p_c) - st.uvd)
    sq = torch.sum(r * r, dim=-1)
    c_st = torch.sum(torch.where(stereo_valid(problem), sq, torch.zeros_like(sq)))
    return 0.5 * c_st + ba_cost_aux(problem, state)


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
    """Stereo-factor contribution in block form (segment sums by pose, by
    landmark and by (pose, landmark) pair)."""
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
                      problem.point_valid.repeat_interleave(3)]).to(H.dtype)
    H = H * free[:, None] * free[None, :]
    diag = torch.diagonal(H)
    return H + torch.diag((diag == 0.0).to(H.dtype)), g * free


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
             config: lm.SolveConfig = lm.SolveConfig()):
    """Minimize the BA cost with Levenberg-Marquardt on the dense system
    (``ceres::Solve`` with DENSE_SCHUR's role at window scale). Returns
    ``(state, SolveSummary)``."""
    return lm_minimize(problem, state0, config)
