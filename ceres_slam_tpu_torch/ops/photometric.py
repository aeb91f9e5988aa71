"""Dense photometric (direct) image alignment ops.

Port of ``ceres_slam_tpu/ops/photometric.py``, the reference's ImageError
factor (``include/ceres_slam/image_error.hpp``). Per pixel of the
reference image:

  p_ref   = triangulate(u, v, d)          # d is an optimized parameter
  p_track = T * p_ref                     # T: track-from-ref pose
  (u',v') = project(p_track)[:2]
  r       = I_track(u', v') - I_ref(u, v)

with chain-rule Jacobians ``dr/dT = grad_I . dproj/dp . dp/dT``; pixels
that project out of bounds contribute zero residual and zero Jacobian.

Bilinear sampling of the track image and its two gradients goes through
K4 (``ops/bilinear_kernel.py``): its CUDA kernel for CUDA tensors, its
plain version for CPU tensors. The JAX ``sampler`` argument (gather,
Pallas or Pallas-interpret) is gone: the tensors' device decides.
Nearest-neighbour sampling (``interp="nn"``) is a plain gather on both
devices, as in the JAX package.

Masked rows are selected with ``torch.where``, never multiplied by the
mask: a pixel whose projection is not finite (a disparity of 0, a point
at depth 0) has non-finite Jacobian factors, and ``0 * inf`` is NaN.
"""

from __future__ import annotations

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import bilinear_kernel, lie


def image_gradients(img: torch.Tensor):
    """Central-difference intensity gradients ``(gu, gv)``, zero on the
    one-pixel border."""
    gu = torch.zeros_like(img)
    gv = torch.zeros_like(img)
    gu[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gv[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gu, gv


def _sample_nn(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest-neighbour sampling with its validity mask (the reference
    rounds to the nearest pixel). A non-finite coordinate is out of bounds
    (the JAX package converts NaN to pixel 0 and counts it in bounds)."""
    h, w = img.shape
    ur, vr = torch.round(u), torch.round(v)
    inb = (ur >= 0) & (ur < w) & (vr >= 0) & (vr < h)
    ui = torch.nan_to_num(ur.clamp(0, w - 1), nan=0.0).to(torch.int64)
    vi = torch.nan_to_num(vr.clamp(0, h - 1), nan=0.0).to(torch.int64)
    return torch.where(inb, img[vi, ui], 0.0), inb


def _bilinear_in_bounds(u: torch.Tensor, v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    u0, v0 = torch.floor(u), torch.floor(v)
    return (u0 >= 0) & (u0 + 1 <= w - 1) & (v0 >= 0) & (v0 + 1 <= h - 1)


def _sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sampling of one ``[H, W]`` image, with its validity mask."""
    h, w = img.shape
    vals = bilinear_kernel.bilinear_sample_imgs(img[None].contiguous(), u.contiguous(),
                                                v.contiguous())[0]
    inb = _bilinear_in_bounds(u, v, h, w)
    return torch.where(inb, vals, 0.0), inb


def _sample3(track_img, grad_u, grad_v, u, v):
    """``(I, gu, gv, in_bounds)`` at shared coordinates: one K4 call on the
    ``[3, H, W]`` stack."""
    h, w = track_img.shape
    imgs = torch.stack([track_img, grad_u, grad_v])
    vals = bilinear_kernel.bilinear_sample_imgs(imgs, u.contiguous(), v.contiguous())
    inb = _bilinear_in_bounds(u, v, h, w)
    vals = torch.where(inb, vals, 0.0)
    return vals[0], vals[1], vals[2], inb


def photometric_residual(
    camera: StereoCamera,
    T: torch.Tensor,  # [12] track-from-ref pose
    disparities: torch.Tensor,  # [N] per-pixel disparity parameters
    ref_uv: torch.Tensor,  # [N, 2] pixel coordinates in the reference image
    ref_intensity: torch.Tensor,  # [N]
    track_img: torch.Tensor,  # [H, W]
    grad_u: torch.Tensor,  # [H, W]
    grad_v: torch.Tensor,  # [H, W]
    valid: torch.Tensor,  # [N] bool input validity (e.g. disparity known)
    interp: str = "bilinear",  # "bilinear" (default) or "nn" (reference parity)
):
    """Batched residual and analytic Jacobians for all pixels.

    Returns ``(r [N], J_pose [N, 6], J_disp [N], in_bounds & valid [N])``."""
    N = ref_uv.shape[0]
    obs = torch.cat([ref_uv, disparities[:, None]], dim=-1)
    p_ref = camera.triangulate(obs)
    Jtri = camera.triangulation_jacobian(obs)  # [N, 3, 3]
    p_trk, J_pose_pt, R = lie.point_transform_jacobians(T.expand(N, 12), p_ref)
    proj = camera.project(p_trk)
    Jproj = camera.projection_jacobian(p_trk)  # [N, 3, 3]
    u, v = proj[:, 0], proj[:, 1]

    if interp == "bilinear":
        I_trk, gu, gv, inb = _sample3(track_img, grad_u, grad_v, u, v)
    elif interp == "nn":
        I_trk, inb = _sample_nn(track_img, u, v)
        gu, _ = _sample_nn(grad_u, u, v)
        gv, _ = _sample_nn(grad_v, u, v)
    else:
        raise ValueError(f"interp must be 'bilinear' or 'nn', got {interp!r}")

    ok = inb & valid
    okc = ok[:, None]
    r = torch.where(ok, I_trk - ref_intensity, 0.0)
    # dr/dx = [gu gv] . Jproj[0:2] . (...)
    g_uv = torch.where(okc, torch.stack([gu, gv], dim=-1), 0.0)
    dI_dp = torch.where(okc, torch.einsum("ni,nij->nj", g_uv, Jproj[:, :2, :]), 0.0)  # [N, 3]
    J_pose = torch.where(okc, torch.einsum("ni,nij->nj", dI_dp, J_pose_pt), 0.0)  # [N, 6]
    # dp_ref/dd is the third column of the triangulation Jacobian
    J_disp = torch.where(ok, torch.einsum("ni,nij,nj->n", dI_dp, R, Jtri[:, :, 2]), 0.0)
    return r, J_pose, J_disp, ok
