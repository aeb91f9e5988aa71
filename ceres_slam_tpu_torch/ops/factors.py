"""Batched residual/Jacobian factors of the sliding-window problem.

Port of ``ceres_slam_tpu/ops/factors.py``. Each factor is one batched
evaluation over all observations of its type:
gathered states in, whitened residuals ``r = S (predicted - observed)`` and
analytic tangent-space Jacobians out, ``S`` being the stiffness (inverse
matrix square root of the measurement covariance).
"""

from __future__ import annotations

import math

import torch

from ceres_slam_tpu_torch.models import lighting
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie


def inv_sqrt_psd(M: torch.Tensor) -> torch.Tensor:
    """Inverse matrix square root of symmetric PSD ``[..., d, d]``."""
    w, V = torch.linalg.eigh(M)
    w = torch.clamp(w, min=torch.finfo(M.dtype).tiny)
    return (V * (1.0 / torch.sqrt(w))[..., None, :]) @ V.transpose(-1, -2)


def chol_whiten(C: torch.Tensor) -> torch.Tensor:
    """A whitening of symmetric positive definite ``C [..., d, d]`` with no
    host read, so a captured loop can make it: ``S = L^-1`` with ``C = L
    L^T`` (``cholesky_ex``, and ``L^-1`` by a triangular solve against the
    identity); all NaN where the factorization fails. ``S^T S = C^-1``, as
    with ``inv_sqrt_psd``, so a factor whitened by either has the same cost
    and normal equations; ``S`` itself is another matrix (lower triangular,
    not the symmetric square root of the JAX package's ``inv_sqrt_psd``).
    ``torch.linalg.eigh`` checks its result on the host on CUDA."""
    L, info = torch.linalg.cholesky_ex(C)
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device).expand_as(C)
    S = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.where((info == 0)[..., None, None], S, torch.full_like(S, math.nan))


def _whiten(S: torch.Tensor, r: torch.Tensor, *jacs):
    return (lie._mv(S, r),) + tuple(S @ J for J in jacs)


def stereo_reprojection(
    camera: StereoCamera,
    T_c_g: torch.Tensor,  # [..., 12]
    pt_g: torch.Tensor,  # [..., 3]
    obs_uvd: torch.Tensor,  # [..., 3]
    stiffness: torch.Tensor,  # [..., 3, 3]
):
    """``r = S (project(T p) - uvd)``; returns (r, J_pose[...,3,6], J_point[...,3,3])."""
    p_c, J_pose_pt, R = lie.point_transform_jacobians(T_c_g, pt_g)
    pred, J_proj = camera.project_with_jacobian(p_c)
    return _whiten(stiffness, pred - obs_uvd, J_proj @ J_pose_pt, J_proj @ R)


def pose_prior(
    T: torch.Tensor,  # [..., 12]
    T_ref: torch.Tensor,  # [..., 12]
    stiffness: torch.Tensor,  # [..., 6, 6]
):
    """``r = S log(T_ref T^-1)`` with tangent Jacobian
    ``[[-R_res, 0], [0, -J_r^{-1}(psi_res)]]``."""
    T_res = lie.se3_compose(T_ref, lie.se3_inverse(T))
    r = lie.se3_log(T_res)
    R_res = lie.se3_rot(T_res)
    Z = torch.zeros_like(R_res)
    J = torch.cat(
        [
            torch.cat([-R_res, Z], dim=-1),
            torch.cat([Z, -lie.so3_inv_right_jacobian(r[..., 3:])], dim=-1),
        ],
        dim=-2,
    )
    return _whiten(stiffness, r, J)


def relative_pose(
    T_1_0: torch.Tensor,  # [..., 12]
    T_2_0: torch.Tensor,  # [..., 12]
    T_2_1_ref: torch.Tensor,  # [..., 12] measured T_2_1
    stiffness: torch.Tensor,  # [..., 6, 6]
):
    """``r = S log(T_2_1_ref T_1_0 T_2_0^-1)``; returns (r, J_1[..., 6, 6],
    J_2[..., 6, 6]), the tangent Jacobians (left perturbations, decoupled
    log): with respect to T_1_0 ``[[R_ref, -R_ref t_est^], [0, J_r^-1(psi)
    R_est^T]]``, with respect to T_2_0 ``[[-R_res, 0], [0, -J_r^-1(psi)]]``."""
    T_est = lie.se3_compose(T_1_0, lie.se3_inverse(T_2_0))
    T_res = lie.se3_compose(T_2_1_ref, T_est)
    r = lie.se3_log(T_res)
    R_ref, R_est, R_res = lie.se3_rot(T_2_1_ref), lie.se3_rot(T_est), lie.se3_rot(T_res)
    Jr_inv = lie.so3_inv_right_jacobian(r[..., 3:])
    Z = torch.zeros_like(R_res)
    R_ref = R_ref.expand_as(R_res)
    J1 = torch.cat([
        torch.cat([R_ref, -R_ref @ lie.so3_wedge(lie.se3_trans(T_est))], dim=-1),
        torch.cat([Z, Jr_inv @ R_est.transpose(-1, -2)], dim=-1),
    ], dim=-2)
    J2 = torch.cat([torch.cat([-R_res, Z], dim=-1), torch.cat([Z, -Jr_inv], dim=-1)], dim=-2)
    return _whiten(stiffness, r, J1, J2)


def sun_sensor(
    T_c_g: torch.Tensor,  # [..., 12]
    sun_obs_c: torch.Tensor,  # [..., 3] observed sun dir, camera frame (unit)
    sun_dir_g: torch.Tensor,  # [..., 3] ephemeris sun dir, global frame (unit)
    stiffness: torch.Tensor,  # [..., 2, 2]
    az_err_thresh: float = 1000.0,
    zen_err_thresh: float = 1000.0,
):
    """Azimuth/zenith sun-direction residual with hard outlier gating:
    ``zen = acos(-y)``, ``az = atan2(x, z)``, the azimuth difference wrapped
    to [-pi, pi]; a component beyond its threshold has both its residual
    and its Jacobian row zeroed."""
    s_c, J_pose_vec, _ = lie.vector_transform_jacobians(T_c_g, sun_dir_g)
    x, y, z = s_c[..., 0], s_c[..., 1], s_c[..., 2]

    r_az = torch.atan2(x, z) - torch.atan2(sun_obs_c[..., 0], sun_obs_c[..., 2])
    r_az = torch.where(r_az > math.pi, r_az - 2 * math.pi, r_az)
    r_az = torch.where(r_az < -math.pi, r_az + 2 * math.pi, r_az)
    r_zen = torch.acos(-y) - torch.acos(-sun_obs_c[..., 1])
    az_ok = torch.abs(r_az) <= az_err_thresh
    zen_ok = torch.abs(r_zen) <= zen_err_thresh

    # d az / d s_c = [z, 0, -x] / (x^2 + z^2);  d zen / d s_c = [0, 1, 0] / sqrt(1 - y^2)
    xz2 = x * x + z * z
    safe_xz2 = torch.where(xz2 > 0, xz2, torch.ones_like(xz2))
    dz_arg = 1.0 - y * y
    safe_dz = torch.sqrt(torch.where(dz_arg > 0, dz_arg, torch.ones_like(dz_arg)))
    zero = torch.zeros_like(x)
    J_angles = torch.stack(
        [
            torch.stack([z / safe_xz2, zero, -x / safe_xz2], dim=-1),
            torch.stack([zero, 1.0 / safe_dz, zero], dim=-1),
        ],
        dim=-2,
    )
    ok = torch.stack([az_ok, zen_ok], dim=-1)
    r = torch.where(ok, torch.stack([r_az, r_zen], dim=-1), 0.0)
    J_pose = (J_angles @ J_pose_vec) * ok[..., None].to(s_c.dtype)
    return _whiten(stiffness, r, J_pose)


def normal_obs(
    T_c_g: torch.Tensor,  # [..., 12]
    normal_g: torch.Tensor,  # [..., 3] estimated normal, global frame
    obs_normal_c: torch.Tensor,  # [..., 3] observed normal, camera frame
    stiffness: torch.Tensor,  # [..., 3, 3]
):
    """``r = S (R n_g - n_obs_c)``; returns (r, J_pose[...,3,6],
    J_normal[...,3,3]). ``J_normal`` is with respect to the raw 3-vector:
    the solver chains ``unit_vector_tangent_projector`` onto it."""
    n_c, J_pose, R = lie.vector_transform_jacobians(T_c_g, normal_g)
    return _whiten(stiffness, n_c - obs_normal_c, J_pose, R)


def _intensity_predict(T_c_g, pt_g, normal_g, phong, texture, light_g, directional: bool):
    """Predicted intensity per observation: the point, normal and light
    moved into the camera frame, shaded with the camera at the origin and
    light colour 1."""
    pt_c = lie.se3_transform_point(T_c_g, pt_g)
    normal_c = lie.se3_transform_vector(T_c_g, normal_g)
    campos_c = torch.zeros_like(pt_c)
    if directional:
        light_c = lie.se3_transform_vector(T_c_g, light_g)
        return lighting.directional_light_shade(pt_c, normal_c, phong, texture, light_c, campos_c)
    light_c = lie.se3_transform_point(T_c_g, light_g)
    return lighting.point_light_shade(pt_c, normal_c, phong, texture, light_c, campos_c)


def _intensity(T, pt_g, normal_g, phong, texture, light_g, obs, stiffness, directional):
    """Residual ``s (I_pred - I_obs)`` and its Jacobians with respect to the
    pose tangent (left perturbation at 0), point, normal, Phong
    parameters, texture and light. The prediction of observation n depends
    on row n of every input alone (the light is broadcast to a row per
    observation), so one reverse pass over the sum of the predictions gives
    every row's gradient: the result of ``vmap(grad)`` over the
    observations, as the JAX package computes it."""
    N = T.shape[0]
    with torch.enable_grad():
        leaves = [x.detach().clone().requires_grad_(True) for x in (
            T.new_zeros((N, 6)), pt_g, normal_g, phong, texture, light_g.expand(N, 3))]
        eps, pt, nrm, ph, tex, light = leaves
        pred = _intensity_predict(lie.se3_retract(T, eps), pt, nrm, ph, tex, light, directional)
        grads = torch.autograd.grad(pred.sum(), leaves)
    pred = pred.detach()
    return (stiffness * (pred - obs), *(g * (stiffness if g.dim() == 1 else stiffness[:, None])
                                        for g in grads))


def intensity_point_light(T, pt_g, normal_g, phong, texture, light_pos_g, obs, stiffness):
    """Point-light intensity factor, batched over N observations (``T [N,
    12]``, ``pt_g``, ``normal_g [N, 3]``, ``phong [N, 3]``, ``texture [N]``,
    ``light_pos_g [3]``, ``obs [N]``, ``stiffness [N]``). Returns
    ``(r [N], J_pose [N, 6], J_point [N, 3], J_normal [N, 3], J_phong [N, 3],
    J_texture [N], J_light [N, 3])``."""
    return _intensity(T, pt_g, normal_g, phong, texture, light_pos_g, obs, stiffness, False)


def intensity_directional_light(T, pt_g, normal_g, phong, texture, light_dir_g, obs, stiffness):
    """Directional-light intensity factor (a light direction in place of a
    position); the same arguments and outputs as ``intensity_point_light``."""
    return _intensity(T, pt_g, normal_g, phong, texture, light_dir_g, obs, stiffness, True)


def unit_vector_tangent_projector(x: torch.Tensor) -> torch.Tensor:
    """``d retract(x, delta) / d delta`` at 0 = ``I - x x^T / |x|^2``: chained
    onto the Jacobian columns of a state that uses the unit-vector
    retraction (a normal, a light direction)."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(*x.shape, 3)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    return eye - x[..., :, None] * x[..., None, :] / x2[..., None]
