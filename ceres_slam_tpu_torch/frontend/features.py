"""Feature detection, description and matching, batched.

Port of ``ceres_slam_tpu/frontend/features.py`` (the feature front end of
the reference's live ROS node): Harris corners with max-pool non-maximum
suppression and a top-k, normalized-patch descriptors, and cross-checked
nearest-neighbour matching by a similarity product. Everything has a fixed
shape: a corner budget with validity masks.

Ties are resolved as the JAX functions resolve them, so the port selects
the same corners and matches:
- the top-k is a stable descending sort (``lax.top_k`` puts the lower index
  first among equal scores; ``torch.topk`` promises no order), which
  matters because most scores tie at ``-inf`` and the invalid corners'
  coordinates still flow on into the stereo observations;
- ``argmax`` returns the first maximum in both libraries, and an all
  ``-inf`` row gives index 0 in both.

The similarity product runs in the descriptors' own dtype with TF32 off
(ROADMAP F2). The JAX matcher asks for ``Precision.DEFAULT``, which is one
bf16 pass on the TPU and full precision on the CPU; the port matches the
CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter(img: torch.Tensor, r: int) -> torch.Tensor:
    """``(2r+1)^2`` box sum through two cumulative sums (zero padding)."""
    k = 2 * r + 1
    cs = torch.cumsum(torch.cumsum(F.pad(img, (r + 1, r, r + 1, r)), dim=0), dim=1)
    return cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]


def harris_corners(img: torch.Tensor, max_corners: int = 512, k: float = 0.04,
                   nms_radius: int = 3, border: int = 8, min_response: float = 1e-6):
    """Harris corners with non-maximum suppression: ``(uv [N, 2], response
    [N], valid [N])``, ``N = max_corners``, sorted by response (the lower
    pixel index first among equal responses)."""
    h, w = img.shape
    Ix = torch.zeros_like(img)
    Ix[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    Iy = torch.zeros_like(img)
    Iy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    Sxx, Syy, Sxy = _box_filter(Ix * Ix, 2), _box_filter(Iy * Iy, 2), _box_filter(Ix * Iy, 2)
    tr = Sxx + Syy
    R = Sxx * Syy - Sxy * Sxy - k * tr * tr

    # keep pixels equal to the maximum of their window (padding is -inf)
    n = 2 * nms_radius + 1
    Rmax = F.max_pool2d(R[None, None], n, stride=1, padding=nms_radius)[0, 0]
    uu = torch.arange(w, device=img.device)[None, :]
    vv = torch.arange(h, device=img.device)[:, None]
    ok = ((R >= Rmax) & (R > min_response) & (uu >= border) & (uu < w - border)
          & (vv >= border) & (vv < h - border))
    score = torch.where(ok, R, -torch.inf).reshape(-1)
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:max_corners], idx[:max_corners]
    valid = torch.isfinite(top) & (top > min_response)
    uv = torch.stack([(idx % w).to(img.dtype), (idx // w).to(img.dtype)], dim=-1)
    return uv, top, valid


def patch_descriptors(img: torch.Tensor, uv: torch.Tensor, patch_radius: int = 4) -> torch.Tensor:
    """``[N, (2r)^2]`` descriptors: the ``2r x 2r`` patch at each corner
    (clipped inside the image), mean removed, scaled to unit norm."""
    r = patch_radius
    h, w = img.shape
    ui = torch.clamp(uv[:, 0].to(torch.int64), r, w - r - 1)
    vi = torch.clamp(uv[:, 1].to(torch.int64), r, h - r - 1)
    d = torch.arange(-r, r, device=img.device)
    patches = img[vi[:, None, None] + d[None, :, None], ui[:, None, None] + d[None, None, :]]
    patches = patches.reshape(uv.shape[0], -1)
    patches = patches - torch.mean(patches, dim=-1, keepdim=True)
    norm = torch.linalg.norm(patches, dim=-1, keepdim=True)
    return patches / torch.clamp(norm, min=1e-8)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor,
                      valid_b: torch.Tensor, min_similarity: float = 0.6,
                      gate: torch.Tensor | None = None):
    """Cross-checked nearest neighbours: ``(idx_b [Na], ok [Na])``, each
    valid a's mutual best partner in b (BFMatcher ``crossCheck``), subject
    to the similarity threshold and an optional ``[Na, Nb]`` gate."""
    sim = desc_a @ desc_b.T
    mask = valid_a[:, None] & valid_b[None, :]
    if gate is not None:
        mask = mask & gate
    sim = torch.where(mask, sim, -torch.inf)
    best_b, best_a = torch.argmax(sim, dim=1), torch.argmax(sim, dim=0)
    best_sim = torch.amax(sim, dim=1)
    mutual = best_a[best_b] == torch.arange(desc_a.shape[0], device=desc_a.device)
    return best_b, mutual & (best_sim > min_similarity) & valid_a
