"""Point-cloud alignment front end: Umeyama + batched 3-point RANSAC.

Port of ``ceres_slam_tpu/frontend/alignment.py``. All hypotheses of all
frame pairs are solved and scored at once:

  sample   ``[B, H, 3]`` indices: ``draw_hypotheses`` from a ``torch.Generator``,
           or ``draw_jax_hypotheses``, JAX's own draw (``ops/prng.py``)
  solve    3-point Umeyama by SVD, batched -> ``T_h [..., H, 12]``
  score    reprojected-uvd errors ``[..., H, P]`` in one batched product
  select   argmax of the inlier counts (first maximum on ties)

Sampling is separate from scoring, so hypothesis indices can be injected.
The solve is split around its SVD (``umeyama_moments``, then
``torch.linalg.svd``, then ``umeyama_transform``; ``hypothesis_points``
and ``ransac_select`` around the solve): ``torch.linalg.svd`` checks its
result on the host on CUDA, so a captured live-VO frame
(``frontend/stereo_vo.FrameGraph``) runs it eagerly between two graphs.
The dataset layer draws the JAX package's hypotheses by default (threefry
keys ``PRNGKey(seed + k)`` per pair): the chain depends directly on which
hypotheses are drawn, because — as in the JAX package — the best
hypothesis's minimal fit is returned as it is, with no refit on its
inliers, and other draws move the triangle200 ATE anywhere between ~0.15
and ~0.55 m.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie, prng
from ceres_slam_tpu_torch.utils import telemetry


def umeyama_moments(pts_0: torch.Tensor, pts_1: torch.Tensor):
    """The centroids ``c0``, ``c1`` and the cross-covariance
    ``W = sum (p1-c1)(p0-c0)^T / N`` of ``[..., N, 3]`` point sets, in
    float64: what ``umeyama`` decomposes."""
    p0, p1 = pts_0.to(torch.float64), pts_1.to(torch.float64)
    c0, c1 = p0.mean(dim=-2), p1.mean(dim=-2)
    W = (p1 - c1[..., None, :]).transpose(-1, -2) @ (p0 - c0[..., None, :]) / p0.shape[-2]
    return c0, c1, W


def umeyama_transform(c0: torch.Tensor, c1: torch.Tensor, U: torch.Tensor, Vh: torch.Tensor,
                      dtype) -> torch.Tensor:
    """``T_1_0`` from the moments and the SVD ``W = U S Vh``: the proper
    rotation ``U diag(1, 1, det(U Vh)) Vh`` and the translation that maps
    ``c0`` onto ``c1``, in ``dtype``."""
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.cat([torch.ones_like(c0[..., :2]), d[..., None]], dim=-1)
    C = (U * D[..., None, :]) @ Vh
    t = c1 - lie._mv(C, c0)
    return lie.se3_make(t, C).to(dtype)


def umeyama(pts_0: torch.Tensor, pts_1: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid alignment ``T_1_0`` with ``pts_1 ~= T_1_0 pts_0``
    (``[..., N, 3]`` each): centroids, the cross-covariance
    ``W = sum (p1-c1)(p0-c0)^T / N``, and the proper rotation
    ``U diag(1, 1, det(U V^T)) V^T`` from its SVD. Solved in float64,
    returned in the input dtype."""
    c0, c1, W = umeyama_moments(pts_0, pts_1)
    U, _, Vh = torch.linalg.svd(W)
    return umeyama_transform(c0, c1, U, Vh, pts_0.dtype)


def _top3(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``[B, H, P]`` non-negative keys -> the indices of the three largest
    valid keys per hypothesis (first index on ties, as ``argmax``). Rows
    with fewer than three valid entries get arbitrary picks."""
    keys = torch.where(valid[:, None, :], keys, -1)
    picks = []
    for _ in range(3):
        i = torch.argmax(keys, dim=-1, keepdim=True)
        picks.append(i)
        keys = keys.scatter(-1, i, -1)
    return torch.cat(picks, dim=-1)


def draw_hypotheses(valid: torch.Tensor, num_iters: int,
                    generator: torch.Generator) -> torch.Tensor:
    """``[B, P]`` validity -> ``[B, num_iters, 3]`` indices: three distinct
    valid entries per hypothesis, uniformly drawn from ``generator`` (on
    the generator's device, returned on ``valid``'s)."""
    keys = torch.rand((*valid.shape[:-1], num_iters, valid.shape[-1]), dtype=torch.float64,
                      generator=generator, device=generator.device)
    return _top3(keys, valid.to(generator.device)).to(valid.device)


def draw_jax_hypotheses(valid: torch.Tensor, num_iters: int, seeds: torch.Tensor | None = None,
                        keys: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, P]`` validity and ``[B]`` integer seeds, or ``[B, 2]`` keys
    (``ops/prng.py``), -> ``[B, num_iters, 3]`` indices: the very ones the
    JAX package's ``ransac_align`` draws under ``PRNGKey(seed)`` or under
    the key, on any device.

    JAX takes the top three of ``gumbel(key, (H, P))`` over the valid
    entries; the Gumbel transform is increasing in the uniform draw, whose
    order is that of the high 23 bits of each random word, so the top
    three of those bits are the same picks."""
    if keys is None:
        keys = prng.prng_key(seeds.reshape(-1))
    bits = prng.key_bits32(telemetry.to_device(keys, valid.device),
                           (num_iters, valid.shape[-1])) >> 9
    return _top3(bits, valid)


class RansacResult(NamedTuple):
    T_1_0: torch.Tensor  # [..., 12] best hypothesis (its minimal fit)
    inliers: torch.Tensor  # [..., P] bool inliers of the best hypothesis
    num_inliers: torch.Tensor  # [...] int


def hypothesis_points(pts_0: torch.Tensor, pts_1: torch.Tensor, hyp_idx: torch.Tensor):
    """The three point pairs of each hypothesis: ``[..., H, 3, 3]`` each."""
    H = hyp_idx.shape[-2]
    flat = hyp_idx.reshape(*hyp_idx.shape[:-2], H * 3, 1).expand(*hyp_idx.shape[:-2], H * 3, 3)
    h0 = torch.gather(pts_0, -2, flat).reshape(*hyp_idx.shape, 3)
    h1 = torch.gather(pts_1, -2, flat).reshape(*hyp_idx.shape, 3)
    return h0, h1


def ransac_select(camera: StereoCamera, pts_0: torch.Tensor, pts_1: torch.Tensor,
                  valid: torch.Tensor, T_h: torch.Tensor, thresh: float = 4.0) -> RansacResult:
    """Score the hypotheses ``T_h [..., H, 12]`` and keep the best: an
    inlier has squared reprojected-uvd error below ``thresh`` and is valid;
    the first maximum of the inlier counts wins."""
    p0_in_1 = torch.einsum("...hij,...nj->...hni", lie.se3_rot(T_h), pts_0) \
        + lie.se3_trans(T_h)[..., :, None, :]
    err = torch.sum((camera.project(pts_1)[..., None, :, :] - camera.project(p0_in_1)) ** 2, dim=-1)
    inl = (err < thresh) & valid[..., None, :]
    counts = inl.sum(dim=-1)  # [..., H]
    best = torch.argmax(counts, dim=-1, keepdim=True)  # first maximum
    T = torch.gather(T_h, -2, best[..., None].expand(*best.shape, 12)).squeeze(-2)
    inliers = torch.gather(inl, -2, best[..., None].expand(*best.shape, inl.shape[-1])).squeeze(-2)
    return RansacResult(T, inliers, torch.gather(counts, -1, best).squeeze(-1))


def ransac_align(camera: StereoCamera, pts_0: torch.Tensor, pts_1: torch.Tensor,
                 valid: torch.Tensor, hyp_idx: torch.Tensor,
                 thresh: float = 4.0) -> RansacResult:
    """Batched 3-point RANSAC over leading dims: ``pts_0/pts_1 [..., P, 3]``
    matched camera-frame points, ``valid [..., P]``, ``hyp_idx [..., H, 3]``.
    An inlier has squared reprojected-uvd error below ``thresh`` (4 px^2,
    the VO setting) and is valid."""
    T_h = umeyama(*hypothesis_points(pts_0, pts_1, hyp_idx))  # [..., H, 12]
    return ransac_select(camera, pts_0, pts_1, valid, T_h, thresh)
