"""Direct (dense photometric) alignment solver.

Port of ``ceres_slam_tpu/solver/photometric.py``: one track-from-ref pose
plus per-pixel disparities against the photometric residual (the
reference's ``dense_stereo_test`` workload: one ImageError block per valid
pixel, parameters the pose and that pixel's disparity).

The Hessian is an arrowhead: one 6x6 pose block, a scalar diagonal for the
disparities and one 6-vector coupling per pixel. The disparities are
eliminated in closed form (a scalar Schur complement), so each LM
iteration costs one 6x6 Cholesky. The products over the N pixels are plain
matrix products. On CUDA every iteration samples the track image and its
gradients twice through K4: once for the step, once for the candidate's
cost.

The JAX package's ``resolve_sampler`` (a backend test choosing the Pallas
kernel on a TPU) and its x64 flag flip around that kernel are TPU matters
and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie, photometric
from ceres_slam_tpu_torch.solver import lm


class PhotometricProblem(NamedTuple):
    camera: StereoCamera
    ref_uv: torch.Tensor  # [N, 2]
    ref_intensity: torch.Tensor  # [N]
    track_img: torch.Tensor  # [H, W]
    grad_u: torch.Tensor  # [H, W]
    grad_v: torch.Tensor  # [H, W]
    valid: torch.Tensor  # [N] bool
    disp_meas: torch.Tensor  # [N] measured disparities (e.g. from the matcher)
    # 1/sigma_d: the measurement prior that anchors the depth field; without
    # it any pose is photometrically explainable by re-bending the depths
    disp_stiffness: float


class PhotometricState(NamedTuple):
    T: torch.Tensor  # [12]
    disparities: torch.Tensor  # [N]


def _residual(problem: PhotometricProblem, state: PhotometricState):
    return photometric.photometric_residual(
        problem.camera, state.T, state.disparities, problem.ref_uv, problem.ref_intensity,
        problem.track_img, problem.grad_u, problem.grad_v, problem.valid)


def photometric_cost(problem: PhotometricProblem, state: PhotometricState) -> torch.Tensor:
    r = _residual(problem, state)[0]
    r_d = torch.where(problem.valid,
                      problem.disp_stiffness * (state.disparities - problem.disp_meas), 0.0)
    return 0.5 * (torch.sum(r * r) + torch.sum(r_d * r_d))


def _step(problem: PhotometricProblem, state: PhotometricState, lam):
    """The damped arrowhead step ``(dx, grad_norm, pred)``, ``dx`` the pose
    step (6) then the disparity steps (N)."""
    r, J_pose, J_disp, _ = _residual(problem, state)
    Hpp = J_pose.T @ J_pose
    c = J_disp * J_disp  # [N]
    w = J_pose * J_disp[:, None]  # [N, 6]
    gp = J_pose.T @ r
    gd = J_disp * r
    # disparity measurement prior
    s2 = problem.disp_stiffness * problem.disp_stiffness
    c = c + s2 * problem.valid.to(c.dtype)
    gd = gd + torch.where(problem.valid, s2 * (state.disparities - problem.disp_meas), 0.0)

    # Damping with a clamped diagonal (Ceres's min_diagonal: pixels with
    # near-zero image gradient have c ~ 0 and would otherwise take
    # unbounded disparity steps).
    Hpp_d = Hpp + lam * torch.diag(torch.diagonal(Hpp).clamp(1e-6, 1e32))
    c_d = c + lam * c.clamp(1e-6, 1e32)
    dead = c <= 1e-10
    c_safe = torch.where(dead, 1.0, c_d)

    S = Hpp_d - (w / c_safe[:, None]).T @ w
    rhs = -(gp - w.T @ (gd / c_safe))
    dp = torch.cholesky_solve(rhs[:, None], lm._cholesky_or_nan(S))[:, 0]
    dd = torch.where(dead, 0.0, -(gd + w @ dp) / c_safe)
    # Disparity trust region: steps beyond a couple of pixels per iteration
    # are meaningless for a photometric model and destabilize low-gradient
    # pixels; clamp (the LM accept test then judges the clamped step).
    dd = dd.clamp(-2.0, 2.0)

    dx = torch.cat([dp, dd])
    grad_norm = torch.maximum(gp.abs().max(), gd.abs().max())
    g_dot_dx = gp @ dp + gd @ dd
    dxHdx = dp @ (Hpp @ dp) + 2.0 * (dd @ (w @ dp)) + torch.sum(c * dd * dd)
    pred = -(g_dot_dx + 0.5 * dxHdx)
    return dx, grad_norm, pred


def _retract(state: PhotometricState, dx: torch.Tensor) -> PhotometricState:
    return PhotometricState(T=lie.se3_retract(state.T, dx[:6]),
                            disparities=state.disparities + dx[6:])


def solve_photometric(problem: PhotometricProblem, state0: PhotometricState,
                      config: lm.SolveConfig = lm.SolveConfig(max_iters=30)):
    """LM over the pose and the disparities; returns ``(state, SolveSummary)``."""
    return lm.lm_solve(state0, config, lambda s: photometric_cost(problem, s),
                       lambda s, lam: _step(problem, s, lam), _retract)
