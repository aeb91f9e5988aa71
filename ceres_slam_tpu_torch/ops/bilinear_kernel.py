"""K4: bilinear sampling of an image stack at N points — CUDA kernel, wrapper and plain versions.

``bilinear_sample_imgs`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::bilinear_sample_imgs`` and keeps
its layout: ``imgs [C, H, W]`` sampled at ``(u [N], v [N])`` gives
``[C, N]``. It packs the stack (``pack_imgs``) and samples the packed form
(``bilinear_sample_packed``), which is what a photometric solve calls: it
packs its three images once and samples them twice per LM iteration. The
CUDA source, with the note on what bounds it on an H100 and how its design
answers that, is ``csrc/bilinear_sample_imgs.cu``. The plain PyTorch
versions (``bilinear_sample_packed_plain`` and the planar
``bilinear_sample_imgs_plain``) are the CPU path and the kernel's
reference on the card; all three round exactly alike.

Indices are ``clip(floor(u), 0, W-2)`` and ``clip(floor(v), 0, H-2)``,
taken in floating point (a non-finite coordinate lands on index 0 or the
last one, never outside the image); the fractions are taken from the
clipped index, so a point outside the image gets the clipped-border
extrapolation, which the caller masks.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("bilinear_sample_imgs.cu",)
MAX_CHANNELS = 4


class _Args(ctypes.Structure):
    """The C side's copy of a packed stack (``Args`` in the CUDA source)."""

    _fields_ = [("tex", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("H", "W", "C", "device", "multi_device")]


class PackedImages(NamedTuple):
    """K4's plan for one solve: a ``[C, H, W]`` stack packed
    channel-interleaved into ``texels [H, W, 4]`` (channels past C are
    zero), checked once by ``pack_imgs``. ``args`` is its C-side copy (None
    on the CPU)."""

    texels: torch.Tensor
    channels: int
    args: _Args | None


def pack_imgs(imgs: torch.Tensor) -> PackedImages:
    """Pack a ``[C, H, W]`` stack (C <= 4, H, W >= 2, float32 or float64, on
    the CPU or a CUDA device) for ``bilinear_sample_packed``."""
    if imgs.dim() != 3:
        raise ValueError(f"imgs: shape {tuple(imgs.shape)}, expected [C, H, W]")
    C, H, W = imgs.shape
    if not 1 <= C <= MAX_CHANNELS or H < 2 or W < 2:
        raise ValueError(f"imgs: shape {tuple(imgs.shape)}, needs 1 <= C <= {MAX_CHANNELS}, "
                         "H >= 2, W >= 2")
    if imgs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bilinear_sample_imgs takes float32 or float64, got {imgs.dtype}")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilinear_sample_imgs runs on cpu or cuda, not {imgs.device}")
    texels = imgs.new_zeros((H, W, MAX_CHANNELS))
    texels[..., :C] = imgs.permute(1, 2, 0)
    args = None
    if texels.is_cuda:
        args = _Args(texels.data_ptr(), H, W, C, texels.device.index, torch.cuda.device_count() > 1)
    return PackedImages(texels, C, args)


def _corner(u: torch.Tensor, size: int) -> torch.Tensor:
    """``clip(floor(u), 0, size-2)`` in floating point; NaN -> 0."""
    return torch.nan_to_num(torch.floor(u).clamp(0, size - 2), nan=0.0)


def _interpolate(planes: torch.Tensor, H: int, W: int, u: torch.Tensor, v: torch.Tensor):
    """The kernel's arithmetic on ``planes [C, H*W]`` (any strides)."""
    uf, vf = _corner(u, W), _corner(v, H)
    fu, fv = u - uf, v - vf
    gu, gv = 1.0 - fu, 1.0 - fv
    idx = vf.to(torch.int64) * W + uf.to(torch.int64)
    i00, i01, i10, i11 = (planes[:, idx + k] for k in (0, 1, W, W + 1))
    col0 = i00 * gv + i10 * fv
    col1 = i01 * gv + i11 * fv
    return col0 * gu + col1 * fu


def bilinear_sample_imgs_plain(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version on the channel-planar ``[C, H, W]`` stack."""
    C, H, W = imgs.shape
    return _interpolate(imgs.reshape(C, H * W), H, W, u, v)


def bilinear_sample_packed_plain(packed: PackedImages, u: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version of the kernel on the packed stack (same
    arguments and output as ``bilinear_sample_packed``)."""
    H, W, _ = packed.texels.shape
    planes = packed.texels.reshape(H * W, MAX_CHANNELS).T[: packed.channels]
    return _interpolate(planes, H, W, u, v)


def _library() -> ctypes.CDLL:
    args, p, i64, i = ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # plan, u, u stride, v, v stride, N, out, stream
    sig = [args, p, i64, p, i64, i, p, p]
    return cuda_build.load("bilinear_sample_imgs", _SOURCES,
                           {"bilinear_sample_packed_f32": sig, "bilinear_sample_packed_f64": sig})


_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    lib = _library()
    _fns.update({torch.float32: lib.bilinear_sample_packed_f32,
                 torch.float64: lib.bilinear_sample_packed_f64})
    return str(cuda_build.library_path("bilinear_sample_imgs", _SOURCES))


def _bad_coords(u, v, tex):
    if u.dim() != 1 or u.shape[0] < 1 or v.shape != u.shape:
        raise ValueError(f"u, v: shapes {tuple(u.shape)}, {tuple(v.shape)}; expected [N], N >= 1")
    if u.dtype != tex.dtype or v.dtype != tex.dtype:
        raise ValueError(f"u, v: dtypes {u.dtype}, {v.dtype}; expected {tex.dtype}")
    raise ValueError(f"u, v are on {u.device}, {v.device}; the stack on {tex.device}")


def bilinear_sample_packed(packed: PackedImages, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample a packed stack at the N points ``(u, v)`` -> ``[C, N]``. ``u``
    and ``v`` are 1-D, of the stack's dtype and device, with any stride (the
    columns of an ``[N, 3]`` projection are taken as they are); only they
    are checked here, the stack was checked by ``pack_imgs``. CPU tensors
    take the plain version; CUDA tensors launch the kernel (and count the
    launch in ``.launches``)."""
    tex, args = packed.texels, packed.args
    if args is None:  # the stack is on the CPU
        if (u.dim() != 1 or v.shape != u.shape or u.shape[0] < 1 or u.dtype != tex.dtype
                or v.dtype != tex.dtype or u.device != tex.device or v.device != tex.device):
            _bad_coords(u, v, tex)
        return bilinear_sample_packed_plain(packed, u, v)
    dev = args.device
    if (u.dim() != 1 or v.shape != u.shape or u.shape[0] < 1 or u.dtype is not tex.dtype
            or v.dtype is not tex.dtype or u.get_device() != dev or v.get_device() != dev):
        _bad_coords(u, v, tex)
    if not _fns:
        build()
    N = u.shape[0]
    out = tex.new_empty(packed.channels, N)
    err = _fns[tex.dtype](args, u.data_ptr(), u.stride()[0], v.data_ptr(), v.stride()[0], N,
                          out.data_ptr(), cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "bilinear_sample_packed")
    bilinear_sample_packed.launches += 1
    return out


bilinear_sample_packed.launches = 0


def bilinear_sample_imgs(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample the ``[C, H, W]`` stack at the N points ``(u, v)`` -> ``[C, N]``
    (the JAX kernel's layout): ``pack_imgs`` then ``bilinear_sample_packed``."""
    return bilinear_sample_packed(pack_imgs(imgs), u, v)


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
