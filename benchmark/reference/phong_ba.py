"""Plain PyTorch reference of Phong-illumination bundle adjustment.

The objective is ``1/2 sum`` over the observations of initialized vertices
of the stereo reprojection residual ``W_s (pi(R p + t) - uvd)`` and, with the
light, the normal residual ``W_n (R n - n_obs)`` and the intensity residual
``w_i (I(p, n, material, light) - I_obs)``: ``I`` the Phong shade in the
camera frame with the camera at the origin, no ambient term, diffuse
``kd max(0, l.n)``, specular ``ks max(0, r.c)^alpha`` with the mirror
direction ``r = 2 (n.l) n - l`` (normalized; zero where it vanishes), ``l``
and ``c`` the unit directions from the vertex to a point light and to the
camera, clamped to ``[0, 1]``. ``W`` are the inverse standard deviations of
the noise. Poses ``T_k_g`` are ``[t | R row-major]``; a material is
``[ambient, specular, exponent]`` with a texture (the diffuse albedo).

The gradient is taken by autograd at zero increments of the stage's free
variables: a pose's left tangent (``t <- t + rho + phi x t``, ``R <- R + phi
x R`` to first order), a vertex's position, a normal through ``n <-
normalize(n + delta)`` (its tangent plane), the materials, textures and
light; a material parameter or texture that sits on its box (``[0, 1]``,
the exponent ``>= 1``) with the gradient pointing out of it counts zero
there (the projected gradient). It imports torch and nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Problem(NamedTuple):
    camera: tuple  # (fu, fv, cu, cv, b)
    uvd: torch.Tensor  # [N, 3]
    ints: torch.Tensor  # [N]
    nobs: torch.Tensor  # [N, 3] observed normals, camera frame
    pose_idx: torch.Tensor  # [N]
    vertex_idx: torch.Tensor  # [N]
    material_idx: torch.Tensor  # [N]
    sigma_s: torch.Tensor  # [3]
    sigma_n: torch.Tensor  # [3]
    sigma_i: float
    valid: torch.Tensor  # [N] the observation's vertex is initialized
    fixed: torch.Tensor  # [K] poses held


class State(NamedTuple):
    poses: torch.Tensor  # [K, 12]
    points: torch.Tensor  # [J, 3]
    normals: torch.Tensor  # [J, 3]
    phong: torch.Tensor  # [M, 3]
    textures: torch.Tensor  # [M]
    light: torch.Tensor  # [3] point light position


def _unit(v):
    n2 = (v * v).sum(-1, keepdim=True)
    ok = n2 > 0
    return torch.where(ok, v / torch.sqrt(torch.where(ok, n2, 1.0)), 0.0), n2[..., 0]


def shade(p_c, n_c, light_c, phong, texture):
    light_dir, _ = _unit(light_c - p_c)
    cam_dir, _ = _unit(-p_c)
    ldn = (light_dir * n_c).sum(-1)
    diffuse = torch.where(ldn > 0, texture * ldn, 0.0)
    mirror, m2 = _unit(2.0 * ldn[:, None] * n_c - light_dir)
    mdc = (mirror * cam_dir).sum(-1)
    ok = (m2 > 0) & (mdc > 0)
    spec = torch.where(ok, phong[:, 1] * torch.where(ok, mdc, 1.0) ** phong[:, 2], 0.0)
    return (diffuse + spec).clamp(0.0, 1.0)


def residual_sq(pb: Problem, s: State, use_light: bool) -> torch.Tensor:
    """Squared whitened residuals of each valid observation."""
    fu, fv, cu, cv, b = pb.camera
    rows = pb.valid.nonzero()[:, 0]
    k, j, m = pb.pose_idx[rows], pb.vertex_idx[rows], pb.material_idx[rows]
    R = s.poses[k, 3:].reshape(-1, 3, 3)
    t = s.poses[k, :3]
    p_c = torch.einsum("nab,nb->na", R, s.points[j]) + t
    z = p_c[:, 2]
    pred = torch.stack([fu * p_c[:, 0] / z + cu, fv * p_c[:, 1] / z + cv, fu * b / z], -1)
    sq = (((pred - pb.uvd[rows]) / pb.sigma_s) ** 2).sum(-1)
    if use_light:
        n_c = torch.einsum("nab,nb->na", R, s.normals[j])
        sq = sq + (((n_c - pb.nobs[rows]) / pb.sigma_n) ** 2).sum(-1)
        light_c = torch.einsum("nab,b->na", R, s.light) + t
        pred_i = shade(p_c, n_c, light_c, s.phong[m], s.textures[m])
        sq = sq + ((pred_i - pb.ints[rows]) / pb.sigma_i) ** 2
    return sq


def cost(pb: Problem, s: State, use_light: bool) -> float:
    return 0.5 * float(residual_sq(pb, s, use_light).sum())


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def projected_gradient_max(pb: Problem, s: State, use_light: bool, freeze_geometry: bool,
                           vertex_ok: torch.Tensor) -> float:
    """The largest magnitude of the stage's projected gradient: by the
    free poses and initialized vertices (unless the geometry is frozen),
    by the initialized vertices' normals and the materials, textures and
    light (with the light)."""
    K, J, M = s.poses.shape[0], s.points.shape[0], s.phong.shape[0]
    dt, dev = s.poses.dtype, s.poses.device
    inc = [torch.zeros(K, 6, dtype=dt, device=dev, requires_grad=True),
           torch.zeros(J, 3, dtype=dt, device=dev, requires_grad=True),
           torch.zeros(J, 3, dtype=dt, device=dev, requires_grad=True),
           torch.zeros(M, 3, dtype=dt, device=dev, requires_grad=True),
           torch.zeros(M, dtype=dt, device=dev, requires_grad=True),
           torch.zeros(3, dtype=dt, device=dev, requires_grad=True)]
    xi, dp, dn, dph, dtex, dl = inc
    R = s.poses[:, 3:].reshape(K, 3, 3)
    t = s.poses[:, :3]
    with torch.enable_grad():
        W = _skew(xi[:, 3:])
        moved = State(torch.cat([t + xi[:, :3] + torch.einsum("kab,kb->ka", W, t),
                                 (R + W @ R).reshape(K, 9)], -1),
                      s.points + dp, _unit(s.normals + dn)[0], s.phong + dph,
                      s.textures + dtex, s.light + dl)
        g = torch.autograd.grad(0.5 * residual_sq(pb, moved, use_light).sum(), inc,
                                allow_unused=True, materialize_grads=True)
    parts = []
    if not freeze_geometry:
        parts += [torch.where(pb.fixed[:, None], 0.0, g[0]),
                  torch.where(vertex_ok[:, None], g[1], 0.0)]
    if use_light:
        lo = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
        hi = torch.tensor([1.0, 1.0, float("inf")], dtype=dt, device=dev)
        gph = torch.where(((s.phong <= lo) & (g[3] > 0)) | ((s.phong >= hi) & (g[3] < 0)),
                          0.0, g[3])
        gtex = torch.where(((s.textures <= 0) & (g[4] > 0)) | ((s.textures >= 1) & (g[4] < 0)),
                           0.0, g[4])
        parts += [torch.where(vertex_ok[:, None], g[2], 0.0), gph, gtex, g[5]]
    return max(float(p.abs().max()) for p in parts)
