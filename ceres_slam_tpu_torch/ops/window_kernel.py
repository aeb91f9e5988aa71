"""K1: the fused window-BA factor pass — CUDA kernel, wrapper and plain version.

``window_factor_blocks`` replaces the Pallas TPU kernel
``ceres_slam_tpu/ops/pallas_kernels.py::window_factor_blocks``; the CUDA
source, with the note on what bounds it on an H100 and how its design
answers that, is ``csrc/window_factor_blocks.cu``. The plain PyTorch
version ``window_factor_blocks_plain`` is the port of
``ceres_slam_tpu/solver/window.py::_xla_blocks`` with the kernel's
input/output layout: the CPU path and the kernel's reference on the card.

The inputs fixed over a window are checked once and packed into a
``WindowPlan`` (``make_plan``, built by the window layout): slot m of the
landmark-grouped layout belongs to landmark ``m // O``; ``pose_idx [M]``
(negative = padding slot), per-slot records ``obs [M, 16]`` (uvd, the 3x3
stiffness row-major, weight, pose_free, two zeros) and the non-padding
slots sorted by pose. A call passes ``poses [K, 12]`` and ``points [J, 3]``
and gets ``(hll [J, 9], u [M, 18], gl [J, 3], hppgp [K, 43], cost [])``:
the landmark side summed over each landmark's O slots, the coupling per
slot, the pose side per pose (36 Hpp, 6 gp, the pose's stereo cost
0.5 sum r^2) and the total stereo cost. On the card the five are views of
one buffer that one launch fills.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import cuda_build, factors, lie

MAX_POSES = 128
MAX_SLOTS_PER_LANDMARK = 128  # the kernel's block: one landmark's slots share one block
_SOURCES = ("window_factor_blocks.cu",)
_ROWS = 43
_REC = 16


class _Args(ctypes.Structure):
    """The C side's copy of a plan (``Args`` in the CUDA source); the pose
    offsets travel in it, with the launch's parameters."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("obs", "obs_by_pose", "pose_idx", "point_by_pose",
                                                 "ticket")]
                + [(n, ctypes.c_double) for n in ("fu", "fv", "cu", "cv", "fb")]
                + [(n, ctypes.c_int) for n in ("K", "J", "O", "device", "multi_device")]
                + [("pose_start", ctypes.c_int * (MAX_POSES + 1))])


class WindowPlan(NamedTuple):
    """K1's launch plan for one window: the inputs fixed over its solve,
    checked once by ``make_plan``. ``args`` is its C-side copy (None on the
    CPU)."""

    camera: StereoCamera
    K: int
    J: int
    O: int
    obs: torch.Tensor  # [M, 16]: uvd | stiffness (row-major) | weight | pose_free | 0, 0
    pose_idx: torch.Tensor  # [M] int32, -1 for padding slots
    pose_order: torch.Tensor  # [S] int32: the non-padding slots sorted by pose
    pose_start: torch.Tensor  # [K + 1] int32: pose k's slots are pose_order[start[k]:start[k+1]]
    obs_by_pose: torch.Tensor  # [S, 16]: obs[pose_order]
    point_by_pose: torch.Tensor  # [S] int32: pose_order // O, the slots' landmarks
    ticket: torch.Tensor  # [1] int32, 0 between calls: the kernel's count of finished pose blocks
    args: _Args | None


def make_plan(camera: StereoCamera, K: int, J: int, pose_idx, uvd, stiffness, weight, pose_free,
              dtype=torch.float64, device="cpu") -> WindowPlan:
    """Check and pack a window's fixed K1 inputs, given on the host (numpy
    arrays or CPU tensors) per slot: ``pose_idx [M]`` (negative = padding),
    ``uvd [M, 3]``, ``stiffness [M, 3, 3]``, ``weight [M]`` (valid & point
    valid), ``pose_free [M]`` (0 for a fixed pose). The plan lives on
    ``device`` (two host-to-device copies); the kernel reads the pose side's
    records in pose order (``obs_by_pose``)."""
    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"window_factor_blocks takes float32 or float64, got {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_factor_blocks runs on cpu or cuda, not {device}")
    if not 1 <= K <= MAX_POSES:
        raise ValueError(f"window_factor_blocks takes 1..{MAX_POSES} poses, got {K}")
    pose_idx = np.asarray(pose_idx).reshape(-1).astype(np.int64)
    M = pose_idx.size
    if J < 1 or M < 1 or M % J != 0:
        raise ValueError(f"slot count {M} is not a positive multiple of the landmark count {J}")
    O = M // J
    if device.type == "cuda" and O > MAX_SLOTS_PER_LANDMARK:
        raise ValueError(f"{O} slots per landmark; the kernel takes at most {MAX_SLOTS_PER_LANDMARK}")
    if pose_idx.max() >= K:
        raise ValueError(f"pose_idx holds {pose_idx.max()}, past the last of {K} poses")
    rec = np.zeros((M, _REC))
    for name, x, lo, width in (("uvd", uvd, 0, 3), ("stiffness", stiffness, 3, 9),
                               ("weight", weight, 12, 1), ("pose_free", pose_free, 13, 1)):
        x = np.asarray(x, dtype=np.float64)
        if x.shape[:1] != (M,) or x.size != M * width:
            raise ValueError(f"{name}: shape {x.shape}, expected {M} slots of {width}")
        rec[:, lo:lo + width] = x.reshape(M, width)

    on = np.nonzero(pose_idx >= 0)[0]
    order = on[np.argsort(pose_idx[on], kind="stable")]
    start = np.concatenate([[0], np.cumsum(np.bincount(pose_idx[on], minlength=K))])
    ints = torch.as_tensor(np.concatenate([np.maximum(pose_idx, -1), order, start, order // O,
                                           [0]]), dtype=torch.int32).to(device)
    S = order.size
    obs, obs_by_pose = torch.as_tensor(np.concatenate([rec, rec[order]]), dtype=dtype).to(
        device).split([M, S])
    pidx, porder, pstart, point_by_pose, ticket = ints.split([M, S, K + 1, S, 1])
    args = None
    if device.type == "cuda":
        args = _Args(obs.data_ptr(), obs_by_pose.data_ptr(), pidx.data_ptr(),
                     point_by_pose.data_ptr(), ticket.data_ptr(), camera.fu, camera.fv,
                     camera.cu, camera.cv, camera.fu * camera.b, K, J, O, obs.device.index,
                     torch.cuda.device_count() > 1,
                     (ctypes.c_int * (MAX_POSES + 1))(*start.tolist()))
    return WindowPlan(camera, K, J, O, obs, pidx, porder, pstart, obs_by_pose, point_by_pose,
                      ticket, args)


def window_factor_blocks_plain(plan: WindowPlan, poses, points):
    """Plain PyTorch version of the kernel (same arguments and outputs)."""
    K, J, O, obs = plan.K, plan.J, plan.O, plan.obs
    M = J * O
    on = plan.pose_idx >= 0
    slot_pose = torch.where(on, plan.pose_idx, K).long()  # padding -> dropped row K
    T = poses[slot_pose.clamp(max=K - 1)]
    p_c, J_pc, R = lie.point_transform_jacobians(T, points.repeat_interleave(O, dim=0))
    z = p_c[:, 2]
    # depth guard before 1/z, as in the kernel
    p_proj = torch.stack([p_c[:, 0], p_c[:, 1], torch.where(z == 0, torch.ones_like(z), z)], dim=-1)
    pred, J_proj = plan.camera.project_with_jacobian(p_proj)
    r, J_pose, J_pt = factors._whiten(
        obs[:, 3:12].reshape(M, 3, 3), pred - obs[:, :3], J_proj @ J_pc, J_proj @ R)
    w = obs[:, 12] * on.to(poses.dtype)
    r = r * w[:, None]
    J_pose = J_pose * (w * obs[:, 13])[:, None, None]
    J_pt = J_pt * w[:, None, None]

    JpT, JlT = J_pose.transpose(1, 2), J_pt.transpose(1, 2)
    hll = (JlT @ J_pt).reshape(J, O, 9).sum(1)
    u = (JpT @ J_pt).reshape(M, 18)
    gl = lie._mv(JlT, r).reshape(J, O, 3).sum(1)
    pose_rows = torch.cat(
        [(JpT @ J_pose).reshape(M, 36), lie._mv(JpT, r), 0.5 * torch.sum(r * r, dim=1, keepdim=True)],
        dim=1,
    )
    hppgp = torch.zeros(K + 1, _ROWS, dtype=poses.dtype, device=poses.device)
    hppgp.index_add_(0, slot_pose, pose_rows)
    hppgp = hppgp[:K]
    return hll, u, gl, hppgp, hppgp[:, 42].sum()


def _library() -> ctypes.CDLL:
    p = ctypes.c_void_p
    sig = [ctypes.POINTER(_Args), p, p, p, p]  # plan, poses, points, out, stream
    return cuda_build.load("window_factor_blocks", _SOURCES,
                           {"window_factor_blocks_f32": sig, "window_factor_blocks_f64": sig})


_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    lib = _library()
    _fns.update({torch.float32: lib.window_factor_blocks_f32,
                 torch.float64: lib.window_factor_blocks_f64})
    return str(cuda_build.library_path("window_factor_blocks", _SOURCES))


def _bad_input(name, t, shape, obs):
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.dtype != obs.dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {obs.dtype}")
    if t.device != obs.device:
        raise ValueError(f"{name} is on {t.device}, the plan on {obs.device}")
    raise ValueError(f"{name} is not contiguous")


def window_factor_blocks(plan: WindowPlan, poses: torch.Tensor, points: torch.Tensor):
    """Fused window factor pass. CPU plans take the plain version; CUDA
    plans launch the kernel once (and count the launch in ``.launches``).
    Only ``poses`` and ``points`` are checked here (shape, dtype, device,
    contiguity); the plan was checked when it was built."""
    obs, args = plan.obs, plan.args
    shapes = (("poses", poses, (plan.K, 12)), ("points", points, (plan.J, 3)))
    if args is None:  # the plan is on the CPU
        for name, t, shape in shapes:
            if (t.shape != shape or t.dtype != obs.dtype or t.device != obs.device
                    or not t.is_contiguous()):
                _bad_input(name, t, shape, obs)
        return window_factor_blocks_plain(plan, poses, points)
    dev = args.device
    for name, t, shape in shapes:
        if (t.shape != shape or t.dtype is not obs.dtype or t.get_device() != dev
                or not t.is_contiguous()):
            _bad_input(name, t, shape, obs)
    if not _fns:
        build()
    K, J, M = plan.K, plan.J, plan.J * plan.O
    out = obs.new_empty(M * 18 + J * 12 + K * _ROWS + 1)
    err = _fns[obs.dtype](args, poses.data_ptr(), points.data_ptr(), out.data_ptr(),
                          cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "window_factor_blocks")
    window_factor_blocks.launches += 1
    u, hll, gl, hppgp, cost = out.split_with_sizes([M * 18, J * 9, J * 3, K * _ROWS, 1])
    return hll.view(J, 9), u.view(M, 18), gl.view(J, 3), hppgp.view(K, _ROWS), cost.view(())


window_factor_blocks.launches = 0


def random_inputs(K: int, J: int, O: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K1 arguments ``(plan, poses, points)`` at a given shape, for
    checking the kernel against its plain version: poses stepping forward
    along z, landmarks 4-30 m ahead of the last pose, noisy observations,
    random slot poses with ~20% padding slots, ~5% invalid slots and pose 0
    fixed."""
    rng = np.random.default_rng(seed)
    M = J * O
    xi = np.concatenate([rng.normal(0, 0.1, (K, 3)), rng.normal(0, 0.02, (K, 3))], axis=1)
    xi[:, 2] -= 0.5 * np.arange(K)
    poses = lie.se3_exp(torch.as_tensor(xi))
    points = torch.as_tensor(rng.uniform([-4, -3, 4 + 0.5 * K], [4, 3, 30 + 0.5 * K], (J, 3)))
    pose_idx = rng.integers(0, K, M)
    pose_idx[rng.random(M) < 0.2] = -1
    camera = StereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)
    p_c = lie.se3_transform_point(poses[torch.as_tensor(np.maximum(pose_idx, 0))],
                                  points.repeat_interleave(O, dim=0))
    uvd = camera.project(p_c) + torch.as_tensor(rng.normal(0, 0.5, (M, 3)))
    A = rng.normal(0, 0.1, (M, 3, 3))
    stiffness = 2.0 * np.eye(3) + A + A.transpose(0, 2, 1)
    weight = ((pose_idx >= 0) & (rng.random(M) > 0.05)).astype(np.float64)
    pose_free = (pose_idx != 0).astype(np.float64)
    plan = make_plan(camera, K, J, pose_idx, uvd.to(dtype), stiffness, weight, pose_free, dtype,
                     device)

    def put(x):
        return x.to(device=device, dtype=dtype).contiguous()

    return plan, put(poses), put(points)
