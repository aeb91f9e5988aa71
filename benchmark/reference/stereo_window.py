"""Plain PyTorch reference of a sun-aided sliding-window stereo problem.

A window of poses ``T_k_g`` (``[t | R row-major]``) and landmarks has three
kinds of residuals, each whitened by the inverse square root of its
covariance:

- stereo: ``pi(R p + t) - uvd`` for every observation of an initialized
  landmark, ``pi`` the rectified projection ``(fu x/z + cu, fv y/z + cv, fu
  b/z)``;
- sun: at a pose with a sun observation, ``s = R s_g`` against the observed
  direction in azimuth ``atan2(x, z)`` (the difference wrapped to ``[-pi,
  pi]``) and zenith ``acos(-y)``; a component beyond its threshold counts
  zero; under the Huber loss of parameter ``a`` the cost is ``rho(|r|^2)``,
  ``rho(s) = s`` up to ``a^2``, ``2 a sqrt(s) - a^2`` beyond;
- prior on the window's first pose: ``(t_e, log R_e)`` of ``T_e = T_ref
  T^-1`` (the translation to first order, as the configuration defines it).

The cost is half their squared sum. Increments: a pose's left tangent ``(rho,
phi)`` (``t <- t + rho + phi x t``, ``R <- R + phi x R`` to first order) and
a landmark's position. ``analyse`` gives the cost, the gradient, and the
Gauss-Newton matrix (the sun rows weighted by ``sqrt(rho')``), whose inverse
gives a pose's marginal covariance. Torch alone, on the CPU, in float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Window(NamedTuple):
    camera: tuple  # (fu, fv, cu, cv, b)
    uvd: torch.Tensor  # [n, 3] observations of initialized landmarks
    obs_W: torch.Tensor  # [n, 3, 3] whitening
    pose_idx: torch.Tensor  # [n] 0..K-1
    point_idx: torch.Tensor  # [n] 0..J-1
    sun_c: torch.Tensor  # [K, 3] observed sun directions (camera)
    sun_g: torch.Tensor  # [K, 3] ephemeris directions
    sun_W: torch.Tensor  # [K, 2, 2]
    sun_valid: torch.Tensor  # [K] bool
    huber: float  # 0: no robust loss
    az_thresh: float
    zen_thresh: float
    prior_T: torch.Tensor  # [12]
    prior_W: torch.Tensor  # [6, 6]


def inv_sqrt(C: torch.Tensor) -> torch.Tensor:
    """``C^-1/2`` of symmetric positive definite matrices."""
    w, V = torch.linalg.eigh(C)
    return V @ torch.diag_embed(w.rsqrt()) @ V.transpose(-1, -2)


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _so3_log(R):
    c = ((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) / 2.0).clamp(-1.0, 1.0)
    axis = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = axis.norm() / 2.0
    small = s < 1e-12
    scale = torch.where(small, 0.5, torch.atan2(s, c) / (2.0 * torch.where(small, 1.0, s)))
    return scale * axis


def _wrap(a):
    return torch.where(a > math.pi, a - 2 * math.pi, torch.where(a < -math.pi, a + 2 * math.pi, a))


def residuals(w: Window, poses, points):
    """``(stereo [3n], sun [2K], prior [6])`` whitened residuals."""
    fu, fv, cu, cv, b = w.camera
    R = poses[:, 3:].reshape(-1, 3, 3)
    t = poses[:, :3]
    q = torch.einsum("nab,nb->na", R[w.pose_idx], points[w.point_idx]) + t[w.pose_idx]
    pred = torch.stack([fu * q[:, 0] / q[:, 2] + cu, fv * q[:, 1] / q[:, 2] + cv,
                        fu * b / q[:, 2]], -1)
    r_st = torch.einsum("nab,nb->na", w.obs_W, pred - w.uvd).reshape(-1)
    s = torch.einsum("kab,kb->ka", R, w.sun_g)
    az = _wrap(torch.atan2(s[:, 0], s[:, 2]) - torch.atan2(w.sun_c[:, 0], w.sun_c[:, 2]))
    zen = torch.acos(-s[:, 1]) - torch.acos(-w.sun_c[:, 1])
    az = torch.where(az.detach().abs() <= w.az_thresh, az, 0.0)
    zen = torch.where(zen.detach().abs() <= w.zen_thresh, zen, 0.0)
    r_sun = torch.einsum("kab,kb->ka", w.sun_W, torch.stack([az, zen], -1))
    r_sun = torch.where(w.sun_valid[:, None], r_sun, 0.0).reshape(-1)
    Rr = w.prior_T[3:].reshape(3, 3)
    Re = Rr @ R[0].T
    te = w.prior_T[:3] - Re @ t[0]
    r_pr = w.prior_W @ torch.cat([te, _so3_log(Re)])
    return r_st, r_sun, r_pr


def _moved(poses, points, x):
    K = poses.shape[0]
    xi = x[: 6 * K].reshape(K, 6)
    W = _skew(xi[:, 3:])
    R = poses[:, 3:].reshape(K, 3, 3)
    t = poses[:, :3]
    t1 = t + xi[:, :3] + torch.einsum("kab,kb->ka", W, t)
    return torch.cat([t1, (R + W @ R).reshape(K, 9)], -1), points + x[6 * K:].reshape(-1, 3)


def analyse(w: Window, poses, points):
    """``(cost, gradient [6K + 3J], Gauss-Newton matrix)`` at ``(poses,
    points)``."""
    K, J = poses.shape[0], points.shape[0]
    x0 = torch.zeros(6 * K + 3 * J, dtype=poses.dtype)

    def stacked(x):
        return torch.cat(residuals(w, *_moved(poses, points, x)))

    r_st, r_sun, r_pr = residuals(w, poses, points)
    Jac = torch.func.jacfwd(stacked)(x0)
    sq = (r_sun.reshape(K, 2) ** 2).sum(-1)
    a = w.huber
    if a > 0:
        rho = torch.where(sq <= a * a, sq, 2 * a * sq.clamp(min=a * a).sqrt() - a * a)
        dw = torch.where(sq <= a * a, 1.0, a / sq.clamp(min=a * a).sqrt()).sqrt()
    else:
        rho, dw = sq, torch.ones_like(sq)
    cost = 0.5 * float((r_st ** 2).sum() + rho[w.sun_valid].sum() + (r_pr ** 2).sum())
    n = r_st.numel()
    weight = torch.ones(Jac.shape[0], dtype=poses.dtype)
    weight[n: n + 2 * K] = dw.repeat_interleave(2)
    Jw = Jac * weight[:, None]
    rw = torch.cat([r_st, r_sun, r_pr]) * weight
    return cost, Jw.T @ rw, Jw.T @ Jw


def marginal_covariance(H: torch.Tensor, k: int) -> torch.Tensor:
    """The ``6 x 6`` block of ``H^-1`` of pose ``k``."""
    Hi = torch.linalg.inv(H)
    return Hi[6 * k: 6 * k + 6, 6 * k: 6 * k + 6]
