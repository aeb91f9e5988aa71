"""K3: the coupling half of the Schur matvec — CUDA kernel, wrapper and plain version.

``schur_uy`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::schur_uy_packed`` (with its wrapper
``schur_uy``); the CUDA source, with the note on what bounds it on an H100
and how its design answers that, is ``csrc/schur_uy.cu``. The plain
PyTorch version ``schur_uy_plain`` is the coupling half of
``ceres_slam_tpu/solver/pcg.py::make_schur_matvec_gather``: the CPU path
and the kernel's reference on the card.

``Uy [K, 6] = sum_j U_j Cinv_j U_j^T v`` for the component-flat couplings
``U18 [N, 18]``, the damped inverted landmark blocks ``Cinv [J, 3, 3]`` and
``v [K, 6]``; ``tables`` is a ``solver.pcg.ObsTables`` (int32 slot tables
``by_point``/``by_point_pose`` ``[J, O_l]`` and ``by_pose``/``by_pose_point``
``[K, O_p]``, float32 0/1 slot weights ``by_point_w``/``by_pose_w``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import cuda_build, lie

_SOURCES = ("schur_uy.cu",)


def schur_uy_plain(U18, Cinv, v, tables):
    """Plain PyTorch version of the kernel (same arguments and output)."""
    t = tables
    J, O_l = t.by_point.shape
    K, O_p = t.by_pose.shape
    dtype = U18.dtype
    U_l = (U18[t.by_point.long()] * t.by_point_w.to(dtype)[..., None]).reshape(J, O_l, 6, 3)
    utv = torch.einsum("joac,joa->jc", U_l, v[t.by_point_pose.long()])
    y = lie._mv(Cinv, utv)
    U_p = (U18[t.by_pose.long()] * t.by_pose_w.to(dtype)[..., None]).reshape(K, O_p, 6, 3)
    return torch.einsum("koac,koc->ka", U_p, y[t.by_pose_point.long()])


def _check(U18, Cinv, v, t):
    if U18.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"schur_uy takes float32 or float64, got {U18.dtype}")
    N = U18.shape[0]
    J, O_l = t.by_point.shape
    K, O_p = t.by_pose.shape
    if min(N, J, O_l, K, O_p) < 1:
        raise ValueError("schur_uy needs at least one observation, landmark, pose and slot")
    shapes = {"U18": (U18, (N, 18), U18.dtype), "Cinv": (Cinv, (J, 3, 3), U18.dtype),
              "v": (v, (K, 6), U18.dtype),
              "by_point": (t.by_point, (J, O_l), torch.int32),
              "by_point_w": (t.by_point_w, (J, O_l), torch.float32),
              "by_point_pose": (t.by_point_pose, (J, O_l), torch.int32),
              "by_pose": (t.by_pose, (K, O_p), torch.int32),
              "by_pose_w": (t.by_pose_w, (K, O_p), torch.float32),
              "by_pose_point": (t.by_pose_point, (K, O_p), torch.int32)}
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if x.device != U18.device:
            raise ValueError(f"{name} is on {x.device}, U18 on {U18.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.dtype != dtype:
            raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("schur_uy", _SOURCES)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.schur_uy_f32, lib.schur_uy_f64):
            # U18, 6 tables, Cinv, v, J, O_l, K, O_p, y scratch, out, stream
            fn.argtypes = [p] * 9 + [i] * 4 + [p] * 3
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    _library()
    return str(cuda_build.library_path("schur_uy", _SOURCES))


def _launch(U18, Cinv, v, t):
    lib = _library()
    J, O_l = t.by_point.shape
    K, O_p = t.by_pose.shape
    y = torch.empty((J, 3), dtype=U18.dtype, device=U18.device)
    out = torch.empty((K, 6), dtype=U18.dtype, device=U18.device)
    fn = lib.schur_uy_f64 if U18.dtype == torch.float64 else lib.schur_uy_f32
    with torch.cuda.device(U18.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(U18.data_ptr(), t.by_point.data_ptr(), t.by_point_w.data_ptr(),
             t.by_point_pose.data_ptr(), t.by_pose.data_ptr(), t.by_pose_w.data_ptr(),
             t.by_pose_point.data_ptr(), Cinv.data_ptr(), v.data_ptr(), J, O_l, K, O_p,
             y.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"schur_uy launch failed with CUDA error {err}")
    schur_uy.launches += 1
    return out


def schur_uy(U18, Cinv, v, tables):
    """``Uy [K, 6]``. CPU tensors take the plain version; CUDA tensors
    launch the kernel (and count the launch in ``.launches``)."""
    _check(U18, Cinv, v, tables)
    if U18.device.type == "cpu":
        return schur_uy_plain(U18, Cinv, v, tables)
    if U18.device.type != "cuda":
        raise ValueError(f"schur_uy runs on cpu or cuda, not {U18.device}")
    return _launch(U18, Cinv, v, tables)


schur_uy.launches = 0


def random_inputs(N: int, J: int, K: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K3 arguments ``(U18, Cinv, v, tables)`` for ``N`` observations
    of ``J`` landmarks from ``K`` poses, stored pose by pose as the datasets
    are, with ~3% masked observations (zero coupling rows)."""
    from ceres_slam_tpu_torch.solver import pcg

    rng = np.random.default_rng(seed)
    pose_idx = np.sort(rng.integers(0, K, N))
    point_idx = rng.integers(0, J, N)
    U18 = rng.normal(0, 1.0, (N, 18))
    U18[rng.random(N) < 0.03] = 0.0
    A = rng.normal(0, 0.3, (J, 3, 3))
    Cinv = A @ A.transpose(0, 2, 1) + np.eye(3)

    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    tables = pcg.build_obs_tables(pose_idx, point_idx, K, J, device=device)
    return put(U18), put(Cinv), put(rng.normal(0, 1.0, (K, 6))), tables
