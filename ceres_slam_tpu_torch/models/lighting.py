"""Phong shading and light-source models, branchless and batched.

Port of ``ceres_slam_tpu/models/lighting.py`` (the reference's
``lighting/phong.hpp``, ``directional_light.hpp``, ``point_light.hpp``):
the reference's early-return branches become ``torch.where`` selections,
and every guarded quantity (a division, a power) is made safe before the
selection, so that values and gradients stay finite on both sides of it.
Phong parameters are the row ``[ambient, specular, exponent]``; the
texture is the scalar diffuse albedo. Everything broadcasts over leading
dimensions and stays in the inputs' dtype.
"""

from __future__ import annotations

import torch


def _safe_normalize(v: torch.Tensor, eps: float = 0.0):
    """Normalize along the last axis; returns ``(unit_v, norm_sq)``. Where
    ``|v|^2 <= eps`` the direction is zeros (the reference's
    zero-contribution guard)."""
    norm_sq = torch.sum(v * v, dim=-1, keepdim=True)
    ok = norm_sq > eps
    safe = torch.where(ok, norm_sq, torch.ones_like(norm_sq))
    unit = torch.where(ok, v / torch.sqrt(safe), torch.zeros_like(v))
    return unit, norm_sq[..., 0]


def shade_diffuse(normal, light_dir, texture):
    """Diffuse component: ``kd * max(0, l . n)``, zero for a non-finite
    light direction."""
    finite = torch.all(torch.isfinite(light_dir), dim=-1)
    ldn = torch.sum(light_dir * normal, dim=-1)
    return torch.where(finite & (ldn > 0.0), texture * ldn, 0.0)


def shade_specular(normal, light_dir, camera_dir, ks, exponent):
    """Specular component: ``ks * max(0, r . c)^alpha`` with the mirror
    direction ``r = 2 (n.l) n - l``, guarding ``|r| = 0`` and the
    ``pow(<0, non-integer)`` NaN."""
    ndl = torch.sum(normal * light_dir, dim=-1, keepdim=True)
    mirror = 2.0 * ndl * normal - light_dir
    mirror_unit, mirror_norm_sq = _safe_normalize(mirror)
    mdc = torch.sum(mirror_unit * camera_dir, dim=-1)
    ok = (mirror_norm_sq > 0.0) & (mdc > 0.0)
    safe_mdc = torch.where(ok, mdc, torch.ones_like(mdc))
    return torch.where(ok, ks * safe_mdc ** exponent, 0.0)


def shade_specular_blinn(normal, light_dir, camera_dir, ks, exponent):
    """Blinn-Phong variant (part of the reference's API; no pipeline uses it)."""
    halfway = light_dir + camera_dir
    halfway_unit, halfway_norm_sq = _safe_normalize(halfway)
    hdn = torch.sum(halfway_unit * normal, dim=-1)
    ok = (halfway_norm_sq > 0.0) & (hdn > 0.0)
    safe_hdn = torch.where(ok, hdn, torch.ones_like(hdn))
    return torch.where(ok, ks * safe_hdn ** exponent, 0.0)


def phong_shade(normal, light_dir, camera_dir, phong_params, texture, light_colour=1.0):
    """Full Phong shade, clamped to [0, 1]. The ambient component is
    disabled, as in the reference."""
    diffuse = shade_diffuse(normal, light_dir, texture)
    specular = shade_specular(normal, light_dir, camera_dir, phong_params[..., 1],
                              phong_params[..., 2])
    ambient = torch.zeros_like(diffuse)
    col = light_colour * (ambient + diffuse + specular)
    # jnp.clip's form, so that a value exactly at a bound splits its
    # gradient as JAX's does
    return torch.minimum(torch.maximum(col, col.new_zeros(())), col.new_ones(()))


def directional_light_shade(vertex_pos, normal, phong_params, texture, light_dir, camera_pos,
                            light_colour=1.0):
    """Shade under a directional light: the camera direction is
    ``normalize(camera_pos - vertex)``, the light direction the unit light
    direction itself."""
    camera_dir, _ = _safe_normalize(camera_pos - vertex_pos)
    unit_light, _ = _safe_normalize(light_dir)
    return phong_shade(normal, unit_light, camera_dir, phong_params, texture, light_colour)


def point_light_shade(vertex_pos, normal, phong_params, texture, light_pos, camera_pos,
                      light_colour=1.0):
    """Shade under a point light: the light direction is
    ``normalize(light_pos - vertex)``."""
    light_dir, _ = _safe_normalize(light_pos - vertex_pos)
    camera_dir, _ = _safe_normalize(camera_pos - vertex_pos)
    return phong_shade(normal, light_dir, camera_dir, phong_params, texture, light_colour)
