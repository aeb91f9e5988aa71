"""Batched SO(3)/SE(3) Lie-group operations on torch tensors.

Port of ``ceres_slam_tpu/ops/lie.py`` (same conventions, same names):

- An SE(3) element is a flat ``[..., 12]`` tensor ``[t(3) | R row-major(9)]``
  and every op is batched over arbitrary leading dimensions.
- SE(3) exp/log are first order in translation (the translation is not
  multiplied by the SO(3) left Jacobian), the convention the whole
  estimation stack — retraction ``T <- exp(eps) T`` and the pose-error
  residual ``log(T_ref T^-1)`` — is built on.
- Small-angle branches are ``torch.where`` selects over guarded
  denominators, so no division is ever evaluated at zero.

The JAX package's Jacobi eigensolvers and closed-form nearest rotation are
not ported: they exist because batched SVD is unusable on the TPU, and
``torch.linalg.svd``/``eigh`` serve here (``so3_normalize`` is the SVD
projection with the determinant's sign fixed).
"""

from __future__ import annotations

import torch

# Size of the flat SE(3) parameterization: [t(3) | R row-major (9)].
SE3_DIM = 12
SO3_DIM = 9
SE3_DOF = 6
SO3_DOF = 3


def _eps(dtype) -> float:
    return torch.finfo(dtype).eps


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``M[..., i, j] v[..., j]``."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def so3_wedge(phi: torch.Tensor) -> torch.Tensor:
    """so(3) wedge: ``phi[..., 3] -> Phi[..., 3, 3]``."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(Phi: torch.Tensor) -> torch.Tensor:
    """so(3) vee: inverse of wedge, averaging the antisymmetric part."""
    return 0.5 * torch.stack(
        [
            Phi[..., 2, 1] - Phi[..., 1, 2],
            Phi[..., 0, 2] - Phi[..., 2, 0],
            Phi[..., 1, 0] - Phi[..., 0, 1],
        ],
        dim=-1,
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues, series near zero): ``[..., 3] -> [..., 3, 3]``."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 <= _eps(phi.dtype)
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_theta = torch.sqrt(safe_theta2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_theta) / safe_theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta2)
    W = so3_wedge(phi)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(C: torch.Tensor) -> torch.Tensor:
    """SO(3) log: ``[..., 3, 3] -> [..., 3]``; first-order ``vee(C - I)``
    for tiny angles, singular at pi like the reference."""
    eps = _eps(C.dtype)
    axis = torch.stack(
        [
            C[..., 2, 1] - C[..., 1, 2],
            C[..., 0, 2] - C[..., 2, 0],
            C[..., 1, 0] - C[..., 0, 1],
        ],
        dim=-1,
    )
    n2 = torch.sum(axis * axis, dim=-1)
    tiny = n2 <= eps
    sin_angle = torch.where(
        tiny, torch.zeros_like(n2), 0.5 * torch.sqrt(torch.where(tiny, torch.ones_like(n2), n2))
    )
    cos_angle = 0.5 * (C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2] - 1.0)
    angle = torch.atan2(sin_angle, cos_angle)
    small = torch.abs(angle) <= eps ** 0.5
    safe_sin = torch.where(small, torch.ones_like(sin_angle), sin_angle)
    scale = torch.where(small, 0.5 * (1.0 + angle * angle / 6.0), 0.5 * angle / safe_sin)
    return scale[..., None] * axis


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian ``I + B w + C w^2`` with ``B = (1 - cos t)/t^2``,
    ``C = (t - sin t)/t^3`` (series near zero)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 <= _eps(phi.dtype)
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_theta = torch.sqrt(safe_theta2)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_theta - torch.sin(safe_theta)) / (safe_theta2 * safe_theta))
    W = so3_wedge(phi)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def so3_inv_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian ``I - 0.5 w + c w^2`` (singular at pi)."""
    eps = _eps(phi.dtype)
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 <= eps ** 0.5
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_theta = torch.sqrt(safe_theta2)
    sin_t = torch.sin(safe_theta)
    safe_sin = torch.where(torch.abs(sin_t) < eps, torch.ones_like(sin_t), sin_t)
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_theta2 - (1.0 + torch.cos(safe_theta)) / (2.0 * safe_theta * safe_sin),
    )
    W = so3_wedge(phi)
    return _eye_like(W) - 0.5 * W + c[..., None, None] * (W @ W)


def so3_inv_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """``J_r^{-1}(phi) = J_l^{-1}(-phi)``."""
    return so3_inv_left_jacobian(-phi)


def so3_inverse(C: torch.Tensor) -> torch.Tensor:
    return C.transpose(-1, -2)


def so3_adjoint(C: torch.Tensor) -> torch.Tensor:
    """The SO(3) adjoint is the rotation matrix itself."""
    return C


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[..., 4] = (w, x, y, z)``, normalized first, -> rotation
    matrix; the norm's floor is the dtype's smallest normal number, so a
    zero quaternion gives a finite matrix in float32 too."""
    n = torch.sum(q * q, dim=-1, keepdim=True)
    q = q / torch.sqrt(torch.clamp(n, min=torch.finfo(q.dtype).tiny))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def so3_normalize(C: torch.Tensor) -> torch.Tensor:
    """The proper rotation nearest to ``C`` (Frobenius): ``U diag(1, 1, d)
    V^T`` from the SVD, ``d = det(U V^T)``. For use between solves, to curb
    the drift of the over-parameterized rotation."""
    U, _, Vh = torch.linalg.svd(C)
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.cat([torch.ones_like(U[..., 0, :2]), d[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh


def so3_retract(C: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Left-perturbation retraction ``C <- exp(psi) C``."""
    return so3_exp(psi) @ C


# ---------------------------------------------------------------------------
# SE(3) — flat [t(3) | R row-major(9)] parameterization
# ---------------------------------------------------------------------------


def se3_trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def se3_rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:].reshape(*T.shape[:-1], 3, 3)


def se3_make(t: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, C.reshape(*C.shape[:-2], 9)], dim=-1)


def se3_identity(batch_shape=(), dtype=torch.float64, device=None) -> torch.Tensor:
    eye = torch.cat([torch.zeros(3, dtype=dtype, device=device),
                     torch.eye(3, dtype=dtype, device=device).reshape(9)])
    return eye.expand(*batch_shape, 12)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exp, first order in translation: ``[..., 6] -> [..., 12]``."""
    return se3_make(xi[..., :3], so3_exp(xi[..., 3:]))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log, first order in translation."""
    return torch.cat([se3_trans(T), so3_log(se3_rot(T))], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = so3_inverse(se3_rot(T))
    return se3_make(-_mv(Rt, se3_trans(T)), Rt)


def se3_compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    Ra, Rb = se3_rot(Ta), se3_rot(Tb)
    return se3_make(_mv(Ra, se3_trans(Tb)) + se3_trans(Ta), Ra @ Rb)


def se3_transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _mv(se3_rot(T), p) + se3_trans(T)


def se3_transform_vector(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _mv(se3_rot(T), v)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint ``[[R, t^ R], [0, R]]``."""
    R = se3_rot(T)
    top = torch.cat([R, so3_wedge(se3_trans(T)) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_matrix(T: torch.Tensor) -> torch.Tensor:
    """Flat pose -> homogeneous ``[..., 4, 4]``."""
    top = torch.cat([se3_rot(T), se3_trans(T)[..., :, None]], dim=-1)
    bottom = torch.zeros((*T.shape[:-1], 1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(M: torch.Tensor) -> torch.Tensor:
    """Homogeneous ``[..., 4, 4]`` -> flat pose ``[..., 12]``."""
    return se3_make(M[..., :3, 3], M[..., :3, :3])


def se3_normalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block onto SO(3) (``so3_normalize``)."""
    return se3_make(se3_trans(T), so3_normalize(se3_rot(T)))


def se3_wedge(xi: torch.Tensor) -> torch.Tensor:
    """se(3) wedge: ``[..., 6] -> [..., 4, 4]``."""
    top = torch.cat([so3_wedge(xi[..., 3:]), xi[..., :3, None]], dim=-1)
    bottom = torch.zeros((*xi.shape[:-1], 1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def se3_vee(Xi: torch.Tensor) -> torch.Tensor:
    return torch.cat([Xi[..., :3, 3], so3_vee(Xi[..., :3, :3])], dim=-1)


def se3_retract(T: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Left-perturbation retraction ``T <- exp(eps) T``."""
    return se3_compose(se3_exp(eps), T)


def unit_vector_retract(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Tangent-plane retraction of unit vectors: project ``delta`` onto the
    tangent plane of ``x``, add, renormalize (the reference's
    UnitVectorPerturbation)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y = x + (delta - (torch.sum(delta * x, dim=-1, keepdim=True) / x2) * x)
    return y / torch.linalg.norm(y, dim=-1, keepdim=True)


def point_transform_jacobians(T: torch.Tensor, p_g: torch.Tensor):
    """``(p_c, J_pose[..., 3, 6], J_point[..., 3, 3])`` with
    ``d p_c / d eps = [I | -p_c^]`` and ``d p_c / d p_g = R``."""
    R = se3_rot(T)
    p_c = _mv(R, p_g) + se3_trans(T)
    J_pose = torch.cat([_eye_like(R), -so3_wedge(p_c)], dim=-1)
    return p_c, J_pose, R


def vector_transform_jacobians(T: torch.Tensor, v_g: torch.Tensor):
    """``(v_c, J_pose[..., 3, 6], R)`` with ``d v_c / d eps = [0 | -v_c^]``."""
    R = se3_rot(T)
    v_c = _mv(R, v_g)
    J_pose = torch.cat([torch.zeros_like(R), -so3_wedge(v_c)], dim=-1)
    return v_c, J_pose, R
