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

``window_factor_blocks_batch`` is the same pass over B windows of one
shape in one launch (``BatchPlan``, ``make_batch_plan``): the windows'
plans side by side, each window's pose offsets and ticket its own. It takes
``poses [B, K, 12]``, ``points [B, J, 3]`` and gives the five outputs with a
leading B axis (a cost per window); window b's outputs equal a
single-window call on window b's plan bit for bit.
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


class _BatchArgs(ctypes.Structure):
    """The C side's copy of a batch plan (``BatchArgs`` in the CUDA source)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("obs", "obs_by_pose", "pose_idx", "point_by_pose",
                                                 "pose_start", "ticket", "cams")]
                + [(n, ctypes.c_int) for n in ("B", "K", "J", "O", "device", "multi_device")])


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


def plan_arrays(K: int, J: int, pose_idx, uvd, stiffness, weight, pose_free) -> dict:
    """Check a window's fixed K1 inputs, given on the host (numpy arrays or
    CPU tensors) per slot: ``pose_idx [M]`` (negative = padding), ``uvd
    [M, 3]``, ``stiffness [M, 3, 3]``, ``weight [M]`` (valid & point valid),
    ``pose_free [M]`` (0 for a fixed pose). Returns the plan's host arrays:
    ``rec [M, 16]`` (float64 records), ``pose_idx [M]`` (-1 for padding),
    ``order [S]`` (the non-padding slots sorted by pose) and ``start
    [K + 1]`` (pose k's run in ``order``)."""
    if not 1 <= K <= MAX_POSES:
        raise ValueError(f"window_factor_blocks takes 1..{MAX_POSES} poses, got {K}")
    pose_idx = np.asarray(pose_idx).reshape(-1).astype(np.int64)
    M = pose_idx.size
    if J < 1 or M < 1 or M % J != 0:
        raise ValueError(f"slot count {M} is not a positive multiple of the landmark count {J}")
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
    return {"rec": rec, "pose_idx": np.maximum(pose_idx, -1), "order": order, "start": start}


def _check_target(dtype, device, O: int) -> torch.device:
    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"window_factor_blocks takes float32 or float64, got {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_factor_blocks runs on cpu or cuda, not {device}")
    if device.type == "cuda" and O > MAX_SLOTS_PER_LANDMARK:
        raise ValueError(f"{O} slots per landmark; the kernel takes at most {MAX_SLOTS_PER_LANDMARK}")
    return device


def make_plan(camera: StereoCamera, K: int, J: int, pose_idx, uvd, stiffness, weight, pose_free,
              dtype=torch.float64, device="cpu") -> WindowPlan:
    """Check and pack a window's fixed K1 inputs (``plan_arrays``) into its
    plan on ``device``."""
    return plan_from_arrays(camera, K, J, plan_arrays(K, J, pose_idx, uvd, stiffness, weight,
                                                      pose_free), dtype, device)


def plan_host(a: dict, J: int, dtype) -> dict:
    """The host arrays of ``plan_arrays``'s plan as they go to the device:
    the records followed by the pose-sorted records in ``dtype``
    (``plan_obs``), and in int32 the slot poses, the pose order, the pose
    offsets, the sorted slots' landmarks and the ticket (``plan_ints``)."""
    rec, order, start = a["rec"], a["order"], a["start"]
    O = rec.shape[0] // J
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return {"plan_obs": np.concatenate([rec, rec[order]]).astype(np_dt),
            "plan_ints": np.concatenate([a["pose_idx"], order, start, order // O, [0]]).astype(
                np.int32)}


def bind_plan(camera: StereoCamera, K: int, J: int, t: dict, start: np.ndarray) -> WindowPlan:
    """The plan over ``plan_host``'s arrays once they are on their device
    (``t``, the same names); ``start`` is the host copy of the pose offsets
    (the kernel takes them with its launch parameters)."""
    obs_all, ints = t["plan_obs"], t["plan_ints"]
    S = int(start[-1])
    M = obs_all.shape[0] - S
    device = _check_target(obs_all.dtype, obs_all.device, M // J)
    obs, obs_by_pose = obs_all.split([M, S])
    pidx, porder, pstart, point_by_pose, ticket = ints.split([M, S, K + 1, S, 1])
    args = None
    if device.type == "cuda":
        args = _Args(obs.data_ptr(), obs_by_pose.data_ptr(), pidx.data_ptr(),
                     point_by_pose.data_ptr(), ticket.data_ptr(), camera.fu, camera.fv,
                     camera.cu, camera.cv, camera.fu * camera.b, K, J, M // J, obs.device.index,
                     torch.cuda.device_count() > 1,
                     (ctypes.c_int * (MAX_POSES + 1))(*np.asarray(start).tolist()))
    return WindowPlan(camera, K, J, M // J, obs, pidx, porder, pstart, obs_by_pose,
                      point_by_pose, ticket, args)


def plan_from_arrays(camera: StereoCamera, K: int, J: int, a: dict, dtype=torch.float64,
                     device="cpu") -> WindowPlan:
    """The plan of ``plan_arrays``'s arrays on ``device`` (one host-to-device
    copy); the kernel reads the pose side's records in pose order
    (``obs_by_pose``)."""
    from ceres_slam_tpu_torch.utils import device as device_mod

    _check_target(dtype, device, a["rec"].shape[0] // J)
    return bind_plan(camera, K, J, device_mod.upload(plan_host(a, J, dtype), device), a["start"])


class BatchPlan(NamedTuple):
    """K1's launch plan for B windows of one shape ``(K, J, O)``: window b's
    slots are ``b * M .. b * M + M - 1`` of ``obs``/``pose_idx``, its pose k's
    records ``obs_by_pose[pose_start[b, k] : pose_start[b, k + 1]]``; a
    ticket and a camera per window. ``args`` is its C-side copy (None on the
    CPU)."""

    cameras: tuple  # B StereoCameras
    B: int
    K: int
    J: int
    O: int
    obs: torch.Tensor  # [B * M, 16]
    pose_idx: torch.Tensor  # [B * M] int32, -1 for padding slots
    pose_start: torch.Tensor  # [B, K + 1] int32, offsets into obs_by_pose
    obs_by_pose: torch.Tensor  # [B * M, 16]: every window's records sorted by pose, in turn
    point_by_pose: torch.Tensor  # [B * M] int32: the slots' landmarks within their window
    ticket: torch.Tensor  # [B] int32, 0 between calls
    cams: torch.Tensor  # [B, 5] float64: fu, fv, cu, cv, fu * b
    args: _BatchArgs | None


def batch_plan_arrays(windows: list, J: int, cameras, dtype) -> dict:
    """The host arrays of a batch plan from the windows' ``plan_arrays`` (one
    shape, ``J`` landmarks): records in ``dtype``, the kernel's integers in
    int32, the cameras in float64."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    M, K1 = windows[0]["rec"].shape[0], windows[0]["start"].size
    if any(w["rec"].shape[0] != M or w["start"].size != K1 for w in windows):
        raise ValueError("the windows of a batch plan must share one shape (K, J, O)")
    O, B = M // J, len(windows)
    base = np.cumsum([0] + [w["order"].size for w in windows[:-1]])
    S = int(base[-1]) + windows[-1]["order"].size
    by_pose = np.zeros((B * M, _REC), np_dt)  # padded to every slot: one size per shape
    by_pose[:S] = np.concatenate([w["rec"][w["order"]] for w in windows])
    point_by_pose = np.zeros(B * M, np.int32)
    point_by_pose[:S] = np.concatenate([w["order"] // O for w in windows])
    return {
        "obs": np.concatenate([w["rec"] for w in windows]).astype(np_dt),
        "obs_by_pose": by_pose,
        "pose_idx": np.concatenate([w["pose_idx"] for w in windows]).astype(np.int32),
        "pose_start": np.stack([w["start"] + b0 for w, b0 in zip(windows, base)]).astype(np.int32),
        "point_by_pose": point_by_pose,
        "ticket": np.zeros(len(windows), np.int32),
        "cams": np.asarray([[c.fu, c.fv, c.cu, c.cv, c.fu * c.b] for c in cameras], np.float64),
    }


def bind_batch_plan(cameras, K: int, J: int, t: dict) -> BatchPlan:
    """The batch plan over ``batch_plan_arrays``'s arrays once they are on
    their device (``t``, the same names)."""
    obs = t["obs"]
    B = len(cameras)
    O = obs.shape[0] // (B * J)
    _check_target(obs.dtype, obs.device, O)
    if t["pose_start"].shape != (B, K + 1) or obs.shape[0] != B * J * O:
        raise ValueError(f"batch plan arrays of {obs.shape[0]} slots and pose offsets "
                         f"{tuple(t['pose_start'].shape)} do not fit {B} windows of {K} poses "
                         f"and {J} landmarks")
    args = None
    if obs.device.type == "cuda":
        args = _BatchArgs(*(t[n].data_ptr() for n in ("obs", "obs_by_pose", "pose_idx",
                                                       "point_by_pose", "pose_start", "ticket",
                                                       "cams")),
                          B, K, J, O, obs.device.index, torch.cuda.device_count() > 1)
    return BatchPlan(tuple(cameras), B, K, J, O, obs, t["pose_idx"], t["pose_start"],
                     t["obs_by_pose"], t["point_by_pose"], t["ticket"], t["cams"], args)


def make_batch_plan(cameras, K: int, J: int, windows: list, dtype=torch.float64,
                    device="cpu") -> BatchPlan:
    """The batch plan of windows given by their ``plan_arrays`` (one shape),
    placed on ``device`` in one host-to-device copy."""
    from ceres_slam_tpu_torch.utils import device as device_mod

    return bind_batch_plan(cameras, K, J, device_mod.upload(
        batch_plan_arrays(windows, J, cameras, dtype), device))


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
    batch = [ctypes.POINTER(_BatchArgs), p, p, p, p]
    return cuda_build.load("window_factor_blocks", _SOURCES,
                           {"window_factor_blocks_f32": sig, "window_factor_blocks_f64": sig,
                            "window_factor_blocks_batch_f32": batch,
                            "window_factor_blocks_batch_f64": batch})


_fns: dict = {}
_batch_fns: dict = {}


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    lib = _library()
    _fns.update({torch.float32: lib.window_factor_blocks_f32,
                 torch.float64: lib.window_factor_blocks_f64})
    _batch_fns.update({torch.float32: lib.window_factor_blocks_batch_f32,
                       torch.float64: lib.window_factor_blocks_batch_f64})
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


def _window_of(plan: BatchPlan, b: int) -> WindowPlan:
    """Window b of a batch plan, as the plain single-window version reads it."""
    M = plan.J * plan.O
    return WindowPlan(plan.cameras[b], plan.K, plan.J, plan.O, plan.obs[b * M:(b + 1) * M],
                      plan.pose_idx[b * M:(b + 1) * M], None, None, None, None, None, None)


def window_factor_blocks_batch_plain(plan: BatchPlan, poses, points):
    """Plain PyTorch version of the batched kernel (same arguments and
    outputs): the plain single-window version on each window in turn."""
    outs = [window_factor_blocks_plain(_window_of(plan, b), poses[b], points[b])
            for b in range(plan.B)]
    return tuple(torch.stack(x) for x in zip(*outs))


def window_factor_blocks_batch(plan: BatchPlan, poses: torch.Tensor, points: torch.Tensor):
    """The fused factor pass of B windows: ``poses [B, K, 12]``, ``points
    [B, J, 3]`` -> ``(hll [B, J, 9], u [B, M, 18], gl [B, J, 3], hppgp
    [B, K, 43], cost [B])``. CPU plans take the plain version; CUDA plans
    launch the kernel once (counted in ``.launches``, the windows it served
    in ``.windows``)."""
    obs, args = plan.obs, plan.args
    B, K, J = plan.B, plan.K, plan.J
    shapes = (("poses", poses, (B, K, 12)), ("points", points, (B, J, 3)))
    if args is None:
        for name, t, shape in shapes:
            if (t.shape != shape or t.dtype != obs.dtype or t.device != obs.device
                    or not t.is_contiguous()):
                _bad_input(name, t, shape, obs)
        return window_factor_blocks_batch_plain(plan, poses, points)
    dev = args.device
    for name, t, shape in shapes:
        if (t.shape != shape or t.dtype is not obs.dtype or t.get_device() != dev
                or not t.is_contiguous()):
            _bad_input(name, t, shape, obs)
    if not _batch_fns:
        build()
    M = J * plan.O
    out = obs.new_empty(B * (M * 18 + J * 12 + K * _ROWS + 1))
    err = _batch_fns[obs.dtype](args, poses.data_ptr(), points.data_ptr(), out.data_ptr(),
                                cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "window_factor_blocks_batch")
    window_factor_blocks_batch.launches += 1
    window_factor_blocks_batch.windows += B
    u, hll, gl, hppgp, cost = out.split_with_sizes(
        [B * M * 18, B * J * 9, B * J * 3, B * K * _ROWS, B])
    return (hll.view(B, J, 9), u.view(B, M, 18), gl.view(B, J, 3), hppgp.view(B, K, _ROWS),
            cost)


window_factor_blocks_batch.launches = 0
window_factor_blocks_batch.windows = 0
# the counts a captured loop scales by its iterations (ops/graph_loop.py)
window_factor_blocks_batch.counters = ("launches", "windows")


def _random_window(K: int, J: int, O: int, rng):
    """Seeded host inputs of one window (see ``random_inputs``)."""
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
    return camera, poses, points, (pose_idx, uvd, stiffness, weight, pose_free)


def random_inputs(K: int, J: int, O: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded K1 arguments ``(plan, poses, points)`` at a given shape, for
    checking the kernel against its plain version: poses stepping forward
    along z, landmarks 4-30 m ahead of the last pose, noisy observations,
    random slot poses with ~20% padding slots, ~5% invalid slots and pose 0
    fixed."""
    camera, poses, points, slots = _random_window(K, J, O, np.random.default_rng(seed))
    pose_idx, uvd, stiffness, weight, pose_free = slots
    plan = make_plan(camera, K, J, pose_idx, uvd.to(dtype), stiffness, weight, pose_free, dtype,
                     device)

    def put(x):
        return x.to(device=device, dtype=dtype).contiguous()

    return plan, put(poses), put(points)


def random_batch_inputs(B: int, K: int, J: int, O: int, dtype=torch.float64, device="cpu",
                        seed: int = 0):
    """Seeded arguments of the batched kernel, ``(batch_plan, poses [B, K,
    12], points [B, J, 3])``, and of the single-window kernel on the same
    windows, ``[(plan, poses, points)] * B``: window b as ``random_inputs``
    draws one, from seed ``seed + b``."""
    windows, cameras, single = [], [], []
    for b in range(B):
        camera, poses, points, slots = _random_window(K, J, O, np.random.default_rng(seed + b))
        pose_idx, uvd, stiffness, weight, pose_free = slots
        uvd = uvd.to(dtype)
        windows.append(plan_arrays(K, J, pose_idx, uvd, stiffness, weight, pose_free))
        cameras.append(camera)
        single.append((make_plan(camera, K, J, pose_idx, uvd, stiffness, weight, pose_free, dtype,
                                 device),
                       poses.to(device=device, dtype=dtype).contiguous(),
                       points.to(device=device, dtype=dtype).contiguous()))
    plan = make_batch_plan(cameras, K, J, windows, dtype, device)
    return (plan, torch.stack([s[1] for s in single]), torch.stack([s[2] for s in single]),
            single)
