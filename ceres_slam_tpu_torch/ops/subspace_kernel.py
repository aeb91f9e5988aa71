"""The 2x2 subproblem of SUBSPACE_DOGLEG — CUDA kernel, wrapper and plain version.

The JAX package minimizes the dogleg's quadratic model over span{gradient,
Gauss-Newton step} on the device, inside its ``lax.while_loop``
(``ceres_slam_tpu/solver/dogleg.py``: ``subspace_step`` and its More-Sorensen
boundary solve ``_boundary_min``, 64 bisection steps on the multiplier).
Once the model is projected to 2x2, what is left is a few hundred scalar
operations per window. ``subspace_step_plain`` is their port as tensor
functions over a batch of windows, in the model's dtype; written as PyTorch
operations it is ~13 kernels per bisection step, ~830 per trust-region
iteration inside the window loop's WHILE node. ``subspace_step`` is the
same function as one kernel (``csrc/subspace_step.cu``): one warp per
window, the 64 bisection steps as 13 rounds in which the warp's lanes test
the 31 nodes of the next 5 steps' tree at once, every operation rounded as
the plain version's (no FMA contraction), so the two give the same bits on
the card. This is a kernel of the port: the JAX package has no Pallas
kernel for it.

The model of window b is ``model[b] = (B00, B01, B11, g0, g1)`` (the
projected Hessian and gradient) with its trust radius ``radius[b]``; the
result is ``(y0, y1, pred)``: the model's minimizer within the radius and
the predicted decrease ``-(g.y + 0.5 y.B y)``.
"""

from __future__ import annotations

import ctypes

import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("subspace_step.cu",)
_fns: dict = {}
TINY = 1e-30
BISECTIONS = 64
# the kernel's rounds (csrc/subspace_step.cu: kBisections, kLevels): LEVELS
# bisection steps a round, a tree of 2**LEVELS - 1 nodes, one a lane
LEVELS = 5
ROUNDS = -(-BISECTIONS // LEVELS)


def _model_value(B00, B01, B11, g0, g1, y0, y1):
    """``0.5 (B00 y0^2 + 2 B01 y0 y1 + B11 y1^2) + (g0 y0 + g1 y1)``."""
    quad = B00 * y0 * y0 + 2.0 * B01 * y0 * y1 + B11 * y1 * y1
    return 0.5 * quad + (g0 * y0 + g1 * y1)


def too_big(mid, e1, e2, ngh1, ngh2, rr):
    """The bisection's test at the multiplier ``mid``: ``|y(mid)|^2 > r^2``."""
    y1 = ngh1 / torch.clamp(e1 + mid, min=TINY)
    y2 = ngh2 / torch.clamp(e2 + mid, min=TINY)
    return y1 * y1 + y2 * y2 > rr


def bisect(lo, hi, e1, e2, ngh1, ngh2, rr):
    """``BISECTIONS`` steps on the multiplier's bracket ``(lo, hi)``: ``mid =
    0.5 (lo + hi)``, then ``lo = mid`` where ``too_big(mid)``, else ``hi =
    mid``. Returns ``(lo, hi)``."""
    for _ in range(BISECTIONS):
        mid = 0.5 * (lo + hi)
        big = too_big(mid, e1, e2, ngh1, ngh2, rr)
        lo, hi = torch.where(big, mid, lo), torch.where(big, hi, mid)
    return lo, hi


def boundary_min(B00, B01, B11, g0, g1, r):
    """Minimize ``0.5 y^T B y + g^T y`` on the circle ``|y| = r`` (tensors of
    one shape): the exact More-Sorensen solve in the 2x2 eigenbasis, by
    bisection on the multiplier, then the best of four candidates (the
    More-Sorensen point, the boundary Cauchy point, +/- the lower
    eigendirection). Port of ``ceres_slam_tpu/solver/dogleg.py::
    _boundary_min``; returns ``(y0, y1)``."""
    mean = 0.5 * (B00 + B11)
    half = 0.5 * (B00 - B11)
    d = torch.sqrt(half * half + B01 * B01)
    e1, e2 = mean - d, mean + d
    # eigenvector for e1 from the better-conditioned row of (B - e1 I)
    use_a = torch.abs(e1 - B00) > torch.abs(e1 - B11)
    w0 = torch.where(use_a, B01, e1 - B11)
    w1 = torch.where(use_a, e1 - B00, B01)
    n1 = torch.sqrt(w0 * w0 + w1 * w1)
    n1_safe = torch.clamp(n1, min=TINY)
    big = n1 > TINY
    v10 = torch.where(big, w0 / n1_safe, 1.0)
    v11 = torch.where(big, w1 / n1_safe, 0.0)
    v20, v21 = -v11, v10
    gh1 = v10 * g0 + v11 * g1
    gh2 = v20 * g0 + v21 * g1
    ngh1, ngh2 = -gh1, -gh2

    # |y(lam)| decreases in lam; bracket so |y(hi)| <= r <= |y(lo+)|
    gnorm = torch.sqrt(gh1 * gh1 + gh2 * gh2)
    lo = torch.clamp(-e1, min=0.0)
    hi = torch.maximum(lo + TINY, -e1 + gnorm / torch.clamp(r, min=TINY))
    rr = r * r
    lo, hi = bisect(lo, hi, e1, e2, ngh1, ngh2, rr)
    lam = 0.5 * (lo + hi)
    yh1 = ngh1 / torch.clamp(e1 + lam, min=TINY)
    yh2 = ngh2 / torch.clamp(e2 + lam, min=TINY)
    # hard case (gh1 ~ 0, lam pinned at -e1, |y| < r): fill the missing norm
    # along the e1 eigendirection; then project exactly onto the circle
    tau = torch.sqrt(torch.clamp(rr - (yh1 * yh1 + yh2 * yh2), min=0.0))
    yh1 = yh1 + torch.where(gh1 > 0.0, -tau, tau)
    scale = r / torch.clamp(torch.sqrt(yh1 * yh1 + yh2 * yh2), min=TINY)
    yh1, yh2 = yh1 * scale, yh2 * scale

    gg = torch.clamp(torch.sqrt(g0 * g0 + g1 * g1), min=TINY)
    nr = -r
    cands = ((yh1 * v10 + yh2 * v20, yh1 * v11 + yh2 * v21),
             (nr * g0 / gg, nr * g1 / gg),
             (r * v10, r * v11),
             (nr * v10, nr * v11))
    # the first lowest model value (a NaN value first: argmin's rule)
    y0, y1 = cands[0]
    best = _model_value(B00, B01, B11, g0, g1, y0, y1)
    for c0, c1 in cands[1:]:
        v = _model_value(B00, B01, B11, g0, g1, c0, c1)
        take = (v < best) | (torch.isnan(v) & ~torch.isnan(best))
        y0, y1 = torch.where(take, c0, y0), torch.where(take, c1, y1)
        best = torch.where(take, v, best)
    return y0, y1


def subspace_step_plain(model: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``model [B, 5]``, ``radius [B]`` -> ``[B, 3]``
    ``(y0, y1, pred)``. The interior (Newton) point where the model is
    positive definite and the point lies within the radius, else the
    boundary minimizer (``ceres_slam_tpu/solver/dogleg.py::subspace_step``'s
    2x2 part)."""
    B00, B01, B11, g0, g1 = model.unbind(-1)
    det = B00 * B11 - B01 * B01
    posdef = (B00 > 0.0) & (det > 0.0)
    det_safe = torch.where(det == 0.0, 1.0, det)
    yi0 = (-g0 * B11 + g1 * B01) / det_safe
    yi1 = (-g1 * B00 + g0 * B01) / det_safe
    interior = posdef & (yi0 * yi0 + yi1 * yi1 <= radius * radius)
    yb0, yb1 = boundary_min(B00, B01, B11, g0, g1, radius)
    y0 = torch.where(interior, yi0, yb0)
    y1 = torch.where(interior, yi1, yb1)
    quad = B00 * y0 * y0 + 2.0 * B01 * y0 * y1 + B11 * y1 * y1
    pred = -(g0 * y0 + g1 * y1 + 0.5 * quad)
    return torch.stack([y0, y1, pred], dim=-1)


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = [p, p, p, i, i, i, p]  # model, radius, out, B, device, multi_device, stream
    lib = cuda_build.load("subspace_step", _SOURCES, {
        "subspace_step_f32": sig, "subspace_step_f64": sig})
    _fns.update({torch.float32: lib.subspace_step_f32, torch.float64: lib.subspace_step_f64})
    return str(cuda_build.library_path("subspace_step", _SOURCES))


def subspace_step(model: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """The 2x2 subproblem of B windows: ``model [B, 5]`` and ``radius [B]``
    (contiguous, float32 or float64, one dtype and device) -> ``[B, 3]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel once
    on the current stream (counted in ``.launches``), which a CUDA graph can
    capture."""
    if model.dim() != 2 or model.shape[1] != 5 or radius.shape != model.shape[:1]:
        raise ValueError(f"subspace_step takes model [B, 5] and radius [B], got "
                         f"{tuple(model.shape)} and {tuple(radius.shape)}")
    if model.dtype not in (torch.float32, torch.float64) or radius.dtype != model.dtype:
        raise ValueError(f"subspace_step takes float32 or float64 of one dtype, got "
                         f"{model.dtype} and {radius.dtype}")
    if radius.device != model.device:
        raise ValueError(f"radius is on {radius.device}, model on {model.device}")
    if model.device.type == "cpu":
        return subspace_step_plain(model, radius)
    if model.device.type != "cuda":
        raise ValueError(f"subspace_step runs on cpu or cuda, not {model.device}")
    if not (model.is_contiguous() and radius.is_contiguous()):
        raise ValueError("subspace_step: model and radius must be contiguous")
    if not _fns:
        build()
    out = model.new_empty((model.shape[0], 3))
    dev = model.get_device()
    err = _fns[model.dtype](model.data_ptr(), radius.data_ptr(), out.data_ptr(), model.shape[0],
                            dev, torch.cuda.device_count() > 1, cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "subspace_step")
    subspace_step.launches += 1
    return out


subspace_step.launches = 0


def random_models(B: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded ``(model [B, 5], radius [B])`` that cover the subproblem's cases
    in turn: an interior Newton point, a boundary point of a positive
    definite model, an indefinite model, the hard case (gradient orthogonal
    to the lower eigendirection), the 1-D collapse (``B11 = 1``, ``g1 = 0``,
    ``B01 = 0``: the basis' degenerate form), a zero gradient and a model
    that is not finite; the rest random with radii over 8 decades."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, 2, 2))
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(2)
    g = rng.normal(size=(B, 2))
    r = 10.0 ** rng.uniform(-4, 4, B)
    m = np.stack([H[:, 0, 0], H[:, 0, 1], H[:, 1, 1], g[:, 0], g[:, 1]], axis=1)
    fixed = [([4.0, 1.0, 3.0, 0.1, -0.2], 10.0),  # interior
             ([4.0, 1.0, 3.0, 10.0, -20.0], 0.5),  # boundary, positive definite
             ([-2.0, 0.5, 1.0, 1.0, 1.0], 1.0),  # indefinite
             ([-1.0, 0.0, 2.0, 0.0, 1.0], 2.0),  # hard case
             ([3.0, 0.0, 1.0, -1.5, 0.0], 0.2),  # degenerate basis (1-D)
             ([2.0, 0.3, 1.0, 0.0, 0.0], 1.0),  # zero gradient
             ([float("nan"), 0.0, 1.0, 1.0, 0.0], 1.0)]  # not finite
    for b in range(min(B, len(fixed))):
        m[b], r[b] = fixed[b]
    return (torch.as_tensor(m, dtype=dtype, device=device),
            torch.as_tensor(r, dtype=dtype, device=device))
