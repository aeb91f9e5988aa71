"""Online stereo visual odometry from raw images.

Port of ``ceres_slam_tpu/frontend/stereo_vo.py`` (the reference's live ROS
node pipeline, ``sparse_stereo_odometry_node.cpp``). Per stereo pair:

  detect corners in both images        Harris + patch descriptors
  stereo match with the cross check    the similarity product, gated by the
    and the epipolar-row and positive    epipolar row and positive disparity
    disparity filters
  temporal match against the previous  the same matcher
    left image
  triangulate both sets, RANSAC        batched 3-point RANSAC on JAX's own
                                         threefry draw (the key split per
                                         frame, ``ops/prng.py``)
  refine the pose on the inliers       Gauss-Newton on 6 dof
  compound onto the map pose           ``T_curr_map = T_curr_prev T_prev_map``,
                                         in float64
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.frontend import alignment, features
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie, prng
from ceres_slam_tpu_torch.utils import device as device_mod


class StereoFrame(NamedTuple):
    """One frame's stereo features: uvd observations and left descriptors."""

    uvd: torch.Tensor  # [N, 3]
    desc: torch.Tensor  # [N, D] left-image descriptors
    valid: torch.Tensor  # [N] bool
    corners: torch.Tensor | None = None  # [] the left image's valid corners


def extract_stereo_frame(camera: StereoCamera, img_left: torch.Tensor, img_right: torch.Tensor,
                         max_corners: int = 384, patch_radius: int = 4,
                         epipolar_tol: float = 1.5, min_disparity: float = 0.25) -> StereoFrame:
    """Detect corners in a rectified pair and match them into uvd
    observations; the epipolar-row and positive-disparity filters gate the
    matcher."""
    uv_l, _, val_l = features.harris_corners(img_left, max_corners=max_corners)
    uv_r, _, val_r = features.harris_corners(img_right, max_corners=max_corners)
    d_l = features.patch_descriptors(img_left, uv_l, patch_radius)
    d_r = features.patch_descriptors(img_right, uv_r, patch_radius)
    gate = ((torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1]) <= epipolar_tol)
            & (uv_l[:, None, 0] - uv_r[None, :, 0] > min_disparity))
    idx_r, ok = features.match_descriptors(d_l, d_r, val_l, val_r, gate=gate)
    disparity = uv_l[:, 0] - uv_r[idx_r, 0]
    uvd = torch.stack([uv_l[:, 0], uv_l[:, 1], torch.clamp(disparity, min=1e-3)], dim=-1)
    return StereoFrame(uvd=uvd, desc=d_l, valid=ok, corners=val_l.sum())


def refine_pose_gn(camera: StereoCamera, T0: torch.Tensor, pts_prev: torch.Tensor,
                   obs_curr: torch.Tensor, weights: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pose-only Gauss-Newton refinement of the frame-to-frame transform
    ``T0 [12]`` against ``obs_curr [N, 3]`` of ``pts_prev [N, 3]`` (the
    landmarks held at their previous-frame triangulation), rows weighted by
    ``weights [N]``; a step that is not finite is skipped."""
    T = T0
    keep = weights != 0
    eye = 1e-8 * torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        p_c, J_pose, _ = lie.point_transform_jacobians(T.expand(pts_prev.shape[0], 12), pts_prev)
        r = torch.where(keep[:, None], (camera.project(p_c) - obs_curr) * weights[:, None], 0.0)
        J = torch.where(keep[:, None, None],
                        (camera.projection_jacobian(p_c) @ J_pose) * weights[:, None, None], 0.0)
        H = torch.einsum("nri,nrj->ij", J, J) + eye
        g = torch.einsum("nri,nr->i", J, r)
        dx, info = torch.linalg.solve_ex(H, -g)
        dx = torch.where(torch.all(torch.isfinite(dx)) & (info == 0), dx, 0.0)
        T = lie.se3_retract(T, dx)
    return T


class OnlineStereoVO:
    """Stateful online VO: feed rectified stereo pairs, read poses.

    Keeps ``T_curr_map`` (camera from map, float64), compounded per frame;
    ``trajectory`` starts with the identity before the first frame. Images
    (numpy or tensors) are taken in float64 on ``device``. ``counts`` holds,
    per frame, the left image's valid corners, the stereo matches and the
    temporal matches (0 on the first frame), as tensors."""

    def __init__(self, camera: StereoCamera, max_corners: int = 384, ransac_iters: int = 400,
                 ransac_thresh: float = 4.0, seed: int = 42, device="cuda"):
        self.camera = camera
        self.max_corners = max_corners
        self.ransac_iters = ransac_iters
        self.ransac_thresh = ransac_thresh
        self.device = device_mod.resolve(device)
        self._key = prng.prng_key(torch.tensor(seed)).to(self.device)
        self._prev: StereoFrame | None = None
        self.T_curr_map = lie.se3_identity(dtype=torch.float64, device=self.device).clone()
        self.trajectory = [self.T_curr_map]
        self.counts: list = []

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float64).to(self.device)

    def process(self, img_left, img_right) -> torch.Tensor:
        """Process one rectified pair; returns the updated ``T_curr_map``."""
        frame = extract_stereo_frame(self.camera, self._image(img_left), self._image(img_right),
                                     max_corners=self.max_corners)
        n_temporal = torch.zeros((), dtype=torch.int64, device=self.device)
        if self._prev is not None:
            idx, ok = features.match_descriptors(self._prev.desc, frame.desc, self._prev.valid,
                                                 frame.valid)
            pts_prev = self.camera.triangulate(self._prev.uvd)
            pts_curr = self.camera.triangulate(frame.uvd[idx])
            self._key, sub = prng.split(self._key)
            hyp = alignment.draw_jax_hypotheses(ok[None], self.ransac_iters, keys=sub[None])[0]
            res = alignment.ransac_align(self.camera, pts_prev, pts_curr, ok, hyp,
                                         thresh=self.ransac_thresh)
            T = refine_pose_gn(self.camera, res.T_1_0, pts_prev, frame.uvd[idx],
                               res.inliers.to(pts_prev.dtype))
            self.T_curr_map = lie.se3_compose(T.to(torch.float64), self.T_curr_map)
            n_temporal = ok.sum()
        self.counts.append(torch.stack([frame.corners, frame.valid.sum(), n_temporal]))
        self._prev = frame
        self.trajectory.append(self.T_curr_map)
        return self.T_curr_map
