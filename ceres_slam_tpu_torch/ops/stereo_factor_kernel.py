"""K2: per-observation stereo factor blocks — CUDA kernel, wrapper and plain version.

``stereo_factor_blocks`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::stereo_factor_blocks`` (with
``flat=True``); the CUDA source, with the note on what bounds it on an
H100 and how its design answers that, is ``csrc/stereo_factor_blocks.cu``.
The plain PyTorch version ``stereo_factor_blocks_plain`` is the port of
the XLA branch of ``ceres_slam_tpu/solver/pcg.py::build_obs_blocks``, with
the kernel's depth guard: the CPU path and the kernel's reference on the card.

Layout (per observation, row-major): gathered poses ``T [N, 12]``, points
``p [N, 3]``, ``uvd [N, 3]``, ``stiffness [N, 3, 3]``, ``valid [N]`` bool.
Outputs ``r [N, 3]``, ``hpp [N, 36]``, ``hll [N, 9]``, ``u [N, 18]``,
``gp [N, 6]``, ``gl [N, 3]``, whitened and masked by ``valid``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import cuda_build, factors, lie

_SOURCES = ("stereo_factor_blocks.cu",)
_WIDTHS = (3, 36, 9, 18, 6, 3)


def stereo_factor_blocks_plain(camera: StereoCamera, T, p, uvd, stiffness, valid):
    """Plain PyTorch version of the kernel (same arguments and outputs)."""
    N = T.shape[0]
    p_c, J_pc, R = lie.point_transform_jacobians(T, p)
    z = p_c[:, 2]
    # depth guard before 1/z, as in the kernel
    p_proj = torch.stack([p_c[:, 0], p_c[:, 1], torch.where(z == 0, torch.ones_like(z), z)], dim=-1)
    pred, J_proj = camera.project_with_jacobian(p_proj)
    r, J_pose, J_pt = factors._whiten(stiffness, pred - uvd, J_proj @ J_pc, J_proj @ R)
    w = valid.to(T.dtype)
    r = r * w[:, None]
    J_pose = J_pose * w[:, None, None]
    J_pt = J_pt * w[:, None, None]
    JpT, JlT = J_pose.transpose(1, 2), J_pt.transpose(1, 2)
    return (r, (JpT @ J_pose).reshape(N, 36), (JlT @ J_pt).reshape(N, 9),
            (JpT @ J_pt).reshape(N, 18), lie._mv(JpT, r), lie._mv(JlT, r))


def _check(T, p, uvd, stiffness, valid):
    N = T.shape[0]
    if N < 1:
        raise ValueError("stereo_factor_blocks needs at least one observation")
    if T.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"stereo_factor_blocks takes float32 or float64, got {T.dtype}")
    shapes = {"T": (T, (N, 12)), "p": (p, (N, 3)), "uvd": (uvd, (N, 3)),
              "stiffness": (stiffness, (N, 3, 3)), "valid": (valid, (N,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != T.device:
            raise ValueError(f"{name} is on {t.device}, T on {T.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        want = torch.bool if name == "valid" else T.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {want}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("stereo_factor_blocks", _SOURCES)
    if not getattr(lib, "_typed", False):
        p, d, i = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
        for fn in (lib.stereo_factor_blocks_f32, lib.stereo_factor_blocks_f64):
            # 5 inputs, camera (fu, fv, cu, cv, b), N, 6 outputs, stream
            fn.argtypes = [p] * 5 + [d] * 5 + [i] + [p] * 7
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    _library()
    return str(cuda_build.library_path("stereo_factor_blocks", _SOURCES))


def _launch(camera, T, p, uvd, stiffness, valid):
    lib = _library()
    N = T.shape[0]
    outs = [torch.empty((N, w), dtype=T.dtype, device=T.device) for w in _WIDTHS]
    fn = lib.stereo_factor_blocks_f64 if T.dtype == torch.float64 else lib.stereo_factor_blocks_f32
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(T.data_ptr(), p.data_ptr(), uvd.data_ptr(), stiffness.data_ptr(), valid.data_ptr(),
             camera.fu, camera.fv, camera.cu, camera.cv, camera.b, N,
             *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"stereo_factor_blocks launch failed with CUDA error {err}")
    stereo_factor_blocks.launches += 1
    return tuple(outs)


def stereo_factor_blocks(camera: StereoCamera, T, p, uvd, stiffness, valid):
    """Per-observation factor blocks ``(r, hpp, hll, u, gp, gl)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``.launches``)."""
    _check(T, p, uvd, stiffness, valid)
    if T.device.type == "cpu":
        return stereo_factor_blocks_plain(camera, T, p, uvd, stiffness, valid)
    if T.device.type != "cuda":
        raise ValueError(f"stereo_factor_blocks runs on cpu or cuda, not {T.device}")
    return _launch(camera, T, p, uvd, stiffness, valid)


stereo_factor_blocks.launches = 0


def random_inputs(N: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K2 arguments for ``N`` observations, for checking the kernel
    against its plain version: poses near the origin looking along z,
    points 4-30 m ahead, noisy observations, symmetric stiffnesses and ~5%
    invalid rows, one of them at depth 0 (the guard's case)."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.5, (N, 3)), rng.normal(0, 0.05, (N, 3))], axis=1)
    xi[0, :3] = 0.0  # row 0: pose at the origin, point at the origin -> z = 0
    T = lie.se3_exp(torch.as_tensor(xi))
    p = rng.uniform([-4, -3, 4], [4, 3, 30], (N, 3))
    p[0] = 0.0
    p = torch.as_tensor(p)
    camera = StereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)
    uvd = camera.project(lie.se3_transform_point(T, p)) + torch.as_tensor(rng.normal(0, 0.5, (N, 3)))
    uvd[0] = 0.0
    A = rng.normal(0, 0.1, (N, 3, 3))
    stiffness = 2.0 * np.eye(3) + A + A.transpose(0, 2, 1)
    valid = rng.random(N) > 0.05
    valid[0] = False

    def put(x, dt=dtype):
        return torch.as_tensor(x).to(device=device, dtype=dt).contiguous()

    return camera, put(T), put(p), put(uvd), put(stiffness), put(valid, torch.bool)
