"""Plain PyTorch reference of full-batch stereo bundle adjustment.

The objective is Ceres' ``1/2 sum |W (pi(R p + t) - uvd)|^2`` over every
observation, with ``pi`` the rectified stereo projection ``(fu x/z + cu,
fv y/z + cv, fu b/z)``, ``W`` the inverse standard deviations of the
observation noise, poses ``T_k_g`` stored as ``[t | R row-major]`` and the
first pose held fixed (the gauge). The reference gives the cost of a state
and its gradient by every free pose (left tangent) and landmark. It shares
no code with the program: it imports torch and nothing else, and works out
the whitening and the Jacobians itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Problem(NamedTuple):
    camera: tuple  # (fu, fv, cu, cv, b)
    uvd: torch.Tensor  # [N, 3]
    sigma: torch.Tensor  # [3] standard deviations of (u, v, d)
    pose_idx: torch.Tensor  # [N] int64
    point_idx: torch.Tensor  # [N] int64
    num_poses: int
    num_points: int


def _split(poses):
    return poses[:, :3], poses[:, 3:].reshape(-1, 3, 3)


def _camera_points(pb: Problem, poses, points):
    t, R = _split(poses)
    return torch.einsum("nab,nb->na", R[pb.pose_idx], points[pb.point_idx]) + t[pb.pose_idx]


def residuals(pb: Problem, poses, points):
    """``[N, 3]`` whitened residuals."""
    fu, fv, cu, cv, b = pb.camera
    q = _camera_points(pb, poses, points)
    pred = torch.stack([fu * q[:, 0] / q[:, 2] + cu, fv * q[:, 1] / q[:, 2] + cv,
                        fu * b / q[:, 2]], dim=-1)
    return (pred - pb.uvd) / pb.sigma


def cost(pb: Problem, poses, points) -> float:
    r = residuals(pb, poses, points)
    return 0.5 * float((r * r).sum())


def _skew(q):
    z = torch.zeros_like(q[:, 0])
    return torch.stack([torch.stack([z, -q[:, 2], q[:, 1]], -1),
                        torch.stack([q[:, 2], z, -q[:, 0]], -1),
                        torch.stack([-q[:, 1], q[:, 0], z], -1)], -2)


def jacobians(pb: Problem, poses, points):
    """Whitened Jacobians ``[N, 3, 6]`` by the pose's left tangent ``(rho,
    phi)`` (``T <- Exp(phi) T`` with ``t <- t + rho``) and ``[N, 3, 3]`` by
    the landmark."""
    fu, fv, _, _, b = pb.camera
    _, R = _split(poses)
    q = _camera_points(pb, poses, points)
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    zero = torch.zeros_like(z)
    Jpi = torch.stack([torch.stack([fu / z, zero, -fu * x / z ** 2], -1),
                       torch.stack([zero, fv / z, -fv * y / z ** 2], -1),
                       torch.stack([zero, zero, -fu * b / z ** 2], -1)], -2)
    Jpi = Jpi / pb.sigma[:, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[0], 3, 3)
    dq = torch.cat([eye, -_skew(q)], dim=-1)
    return Jpi @ dq, Jpi @ R[pb.pose_idx]


def gradient(pb: Problem, poses, points, fixed):
    """The cost's gradient ``(gp [K, 6], gl [J, 3])`` by the pose tangents
    and the landmarks, zero at the poses of ``fixed [K]``."""
    r = residuals(pb, poses, points)
    Jp, Jl = jacobians(pb, poses, points)
    gp = torch.zeros(pb.num_poses, 6, dtype=r.dtype, device=r.device).index_add_(
        0, pb.pose_idx, torch.einsum("nab,na->nb", Jp, r))
    gl = torch.zeros(pb.num_points, 3, dtype=r.dtype, device=r.device).index_add_(
        0, pb.point_idx, torch.einsum("nab,na->nb", Jl, r))
    return torch.where(fixed[:, None], 0.0, gp), gl
