"""K2: the stereo factor pass with its pose and landmark sums — CUDA kernel,
wrapper and plain versions.

``stereo_factor_sums`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::stereo_factor_blocks`` (with
``flat=True``) together with the gather-table sums that
``ceres_slam_tpu/solver/pcg.py::build_obs_blocks`` runs right after it; the
CUDA source, with the note on what bounds it on an H100 and how its design
answers that, is ``csrc/stereo_factor_blocks.cu``.

Two plain PyTorch versions: ``stereo_factor_blocks_plain``, the TPU
kernel's per-observation function (the port of the XLA branch of
``build_obs_blocks``, with the kernel's depth guard), held against the
Pallas kernel; and ``stereo_factor_sums_plain``, that function followed by
the sums in slot order (``index_add_`` in observation order), the CPU path
and the kernel's reference on the card.

``stereo_factor_sums(plan, poses, points)``: the inputs fixed over a solve
come from the problem's ``FullBatchPlan`` (``ops/full_batch_plan.py``);
a call passes ``poses [K, 12]`` and ``points [J, 3]`` and gets ``(U18 [N,
18], Hpp [K, 36], gp [K, 6], Hll [J, 9], gl [J, 3])``: the coupling per
observation (zero where the observation is masked or its pose fixed), the
pose side summed by pose (zero for a fixed pose), the landmark side summed
by landmark (zero for an invalid landmark). On the card the five are views
of one buffer.
"""

from __future__ import annotations

import ctypes

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import cuda_build, factors, full_batch_plan, lie

_SOURCES = ("stereo_factor_blocks.cu",)


def stereo_factor_blocks_plain(camera: StereoCamera, T, p, uvd, stiffness, valid):
    """The TPU kernel's per-observation function: for gathered poses ``T
    [N, 12]``, points ``p [N, 3]``, ``uvd [N, 3]``, ``stiffness [N, 3, 3]``
    and ``valid [N]``, the whitened blocks ``(r [N, 3], hpp [N, 36], hll [N,
    9], u [N, 18], gp [N, 6], gl [N, 3])`` masked by ``valid``."""
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


def stereo_factor_sums_plain(plan: full_batch_plan.FullBatchPlan, poses, points):
    """Plain PyTorch version of the kernel (same arguments and outputs)."""
    K, J, N = plan.K, plan.J, plan.N
    _, hpp, hll, u, gp, gl = stereo_factor_blocks_plain(
        plan.camera, poses[plan.pose_idx], points[plan.point_idx], plan.uvd, plan.stiffness,
        torch.ones(N, dtype=torch.bool, device=poses.device))
    zero = poses.new_zeros(())
    on = plan.valid[:, None]

    def sums(x, idx, n, keep):
        out = poses.new_zeros((n, x.shape[1])).index_add_(0, idx, torch.where(on, x, zero))
        return torch.where(keep[:, None], out, zero)

    U18 = torch.where(on & plan.free_pose[plan.pose_idx][:, None], u, zero)
    by_pose, by_point = (plan.pose_idx, K, plan.free_pose), (plan.point_idx, J, plan.point_valid)
    return U18, sums(hpp, *by_pose), sums(gp, *by_pose), sums(hll, *by_point), sums(gl, *by_point)


def _library() -> ctypes.CDLL:
    p = ctypes.c_void_p
    sig = [ctypes.POINTER(full_batch_plan._Plan), p, p, p, p]  # plan, poses, points, out, stream
    return cuda_build.load("stereo_factor_blocks", _SOURCES,
                           {"stereo_factor_sums_f32": sig, "stereo_factor_sums_f64": sig})


_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    lib = _library()
    _fns.update({torch.float32: lib.stereo_factor_sums_f32,
                 torch.float64: lib.stereo_factor_sums_f64})
    return str(cuda_build.library_path("stereo_factor_blocks", _SOURCES))


def _bad_input(name, t, shape, ref):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != ref.dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {ref.dtype}")
    if t.device != ref.device:
        raise ValueError(f"{name} is on {t.device}, the plan on {ref.device}")
    raise ValueError(f"{name} is not contiguous")


def stereo_factor_sums(plan: full_batch_plan.FullBatchPlan, poses: torch.Tensor,
                       points: torch.Tensor):
    """The factor pass with its sums. A plan on the CPU takes the plain
    version; on CUDA the kernel runs (and counts the launch in
    ``.launches``). Only ``poses`` and ``points`` are checked here (shape,
    dtype, device, contiguity); the plan was checked when it was built."""
    ref, args = plan.rec, plan.args
    shapes = (("poses", poses, (plan.K, 12)), ("points", points, (plan.J, 3)))
    if args is None:  # the plan is on the CPU
        for name, t, shape in shapes:
            if (t.shape != shape or t.dtype != ref.dtype or t.device != ref.device
                    or not t.is_contiguous()):
                _bad_input(name, t, shape, ref)
        return stereo_factor_sums_plain(plan, poses, points)
    for name, t, shape in shapes:
        if (t.shape != shape or t.dtype is not ref.dtype or t.get_device() != args.device
                or not t.is_contiguous()):
            _bad_input(name, t, shape, ref)
    if not _fns:
        build()
    K, J, N = plan.K, plan.J, plan.N
    out = ref.new_empty(N * 18 + K * 42 + J * 12)
    err = _fns[ref.dtype](args, poses.data_ptr(), points.data_ptr(), out.data_ptr(),
                          cuda_build.current_stream(args.device))
    if err:
        raise cuda_build.launch_error(err, "stereo_factor_sums")
    stereo_factor_sums.launches += 1
    U18, Hpp, gp, Hll, gl = out.split_with_sizes([N * 18, K * 36, K * 6, J * 9, J * 3])
    return U18.view(N, 18), Hpp.view(K, 36), gp.view(K, 6), Hll.view(J, 9), gl.view(J, 3)


stereo_factor_sums.launches = 0


def random_inputs(N: int, J: int, K: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K2 arguments ``(plan, poses, points)`` at a full-batch shape
    (``full_batch_plan.random_problem``: pose-ordered rows, a padding tail
    at pose 0, masked rows, one at depth 0, pose 0 fixed)."""
    return full_batch_plan.random_problem(N, J, K, dtype, device, seed)
