"""K4: bilinear sampling of an image stack at N points — CUDA kernel, wrapper and plain version.

``bilinear_sample_imgs`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::bilinear_sample_imgs``; the CUDA
source, with the note on what bounds it on an H100 and how its design
answers that, is ``csrc/bilinear_sample_imgs.cu``. The plain PyTorch
version ``bilinear_sample_imgs_plain`` is the CPU path and the kernel's
reference on the card; it rounds exactly as the kernel does.

``imgs [C, H, W]`` sampled at ``(u [N], v [N])`` gives ``[C, N]``. Indices
are ``clip(floor(u), 0, W-2)`` and ``clip(floor(v), 0, H-2)``, taken in
floating point (a non-finite coordinate lands on index 0 or the last one,
never outside the image); the fractions are taken from the clipped index,
so a point outside the image gets the clipped-border extrapolation, which
the caller masks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("bilinear_sample_imgs.cu",)


def _corner(u: torch.Tensor, size: int) -> torch.Tensor:
    """``clip(floor(u), 0, size-2)`` in floating point; NaN -> 0."""
    return torch.nan_to_num(torch.floor(u).clamp(0, size - 2), nan=0.0)


def bilinear_sample_imgs_plain(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of the kernel (same arguments and output)."""
    C, H, W = imgs.shape
    uf, vf = _corner(u, W), _corner(v, H)
    fu, fv = u - uf, v - vf
    gu, gv = 1.0 - fu, 1.0 - fv
    idx = vf.to(torch.int64) * W + uf.to(torch.int64)
    flat = imgs.reshape(C, H * W)
    i00, i01, i10, i11 = (flat[:, idx + k] for k in (0, 1, W, W + 1))
    col0 = i00 * gv + i10 * fv
    col1 = i01 * gv + i11 * fv
    return col0 * gu + col1 * fu


def _check(imgs, u, v):
    if imgs.dim() != 3:
        raise ValueError(f"imgs: shape {tuple(imgs.shape)}, expected [C, H, W]")
    C, H, W = imgs.shape
    if C < 1 or H < 2 or W < 2:
        raise ValueError(f"imgs: shape {tuple(imgs.shape)}, needs C >= 1, H >= 2, W >= 2")
    if imgs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bilinear_sample_imgs takes float32 or float64, got {imgs.dtype}")
    if u.dim() != 1 or u.shape[0] < 1 or v.shape != u.shape:
        raise ValueError(f"u, v: shapes {tuple(u.shape)}, {tuple(v.shape)}; expected [N], N >= 1")
    for name, t in (("u", u), ("v", v)):
        if t.dtype != imgs.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {imgs.dtype}")
        if t.device != imgs.device:
            raise ValueError(f"{name} is on {t.device}, imgs on {imgs.device}")
    for name, t in (("imgs", imgs), ("u", u), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("bilinear_sample_imgs", _SOURCES)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.bilinear_sample_imgs_f32, lib.bilinear_sample_imgs_f64):
            # imgs, u, v, C, H, W, N, out, stream
            fn.argtypes = [p, p, p, i, i, i, i, p, p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    _library()
    return str(cuda_build.library_path("bilinear_sample_imgs", _SOURCES))


def _launch(imgs, u, v):
    lib = _library()
    C, H, W = imgs.shape
    N = u.shape[0]
    out = torch.empty((C, N), dtype=imgs.dtype, device=imgs.device)
    fn = lib.bilinear_sample_imgs_f64 if imgs.dtype == torch.float64 else lib.bilinear_sample_imgs_f32
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(imgs.data_ptr(), u.data_ptr(), v.data_ptr(), C, H, W, N, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bilinear_sample_imgs launch failed with CUDA error {err}")
    bilinear_sample_imgs.launches += 1
    return out


def bilinear_sample_imgs(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample the ``[C, H, W]`` stack at the N points ``(u, v)`` -> ``[C, N]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``.launches``)."""
    _check(imgs, u, v)
    if imgs.device.type == "cpu":
        return bilinear_sample_imgs_plain(imgs, u, v)
    if imgs.device.type != "cuda":
        raise ValueError(f"bilinear_sample_imgs runs on cpu or cuda, not {imgs.device}")
    return _launch(imgs, u, v)


bilinear_sample_imgs.launches = 0


def random_inputs(C: int, H: int, W: int, N: int, dtype=torch.float64, device="cpu",
                  seed: int = 0):
    """Seeded K4 arguments ``(imgs, u, v)``: a smooth O(1) image stack; ~85%
    of the points inside the image, ~13% up to a quarter of the image
    outside it (the border extrapolation), and ~2% with a NaN or infinite
    coordinate (at least one of each when N >= 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, (C, 2))
    imgs = (0.5 + 0.3 * np.sin(9.0 * xx[None] + phase[:, :1, None])
            * np.cos(7.0 * yy[None] + phase[:, 1:, None])
            + 0.05 * rng.normal(size=(C, H, W)))
    u = rng.uniform(0, W - 1, N)
    v = rng.uniform(0, H - 1, N)
    kind = rng.random(N)
    out = kind > 0.85
    u[out] = rng.uniform(-0.25 * W, 1.25 * (W - 1), out.sum())
    v[out] = rng.uniform(-0.25 * H, 1.25 * (H - 1), out.sum())
    bad = np.nonzero(kind < 0.02)[0]
    specials = np.array([np.nan, np.inf, -np.inf])
    if N >= 3:
        bad = np.union1d(bad, [0, 1, 2])
    u[bad] = specials[np.arange(bad.size) % 3]
    v[bad[::2]] = np.nan

    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    return put(imgs), put(u), put(v)
