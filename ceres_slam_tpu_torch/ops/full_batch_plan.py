"""The full-batch plan: K2's and K3's inputs that are fixed over a solve.

``make_plan`` groups the observations of a full-batch bundle-adjustment
problem once, on the host, by landmark and by pose, and moves the groups,
the static masks, K2's per-observation records and the kernels' scratch to
the device in one step. K2 (``ops/stereo_factor_kernel``) and K3
(``ops/schur_kernel``) read it through one argument struct (``args``,
None on the CPU), so a launch checks and passes only its own tensors.

Segments keep the slot order of the gather tables (``solver/pcg.py
::ObsTables``): landmark j's observations are ``pt_obs[pt_start[j]:
pt_start[j + 1]]`` in increasing observation id, pose k's are
``ps_obs[ps_start[k]:ps_start[k + 1]]`` likewise. The pose segments come
from the grouping, not from the row order: a window problem
(``problems/dataset.py::build_window_problem``) ends with padding rows at
pose 0, so its observations are not sorted by pose.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import lie
from ceres_slam_tpu_torch.utils import telemetry

REC = 12  # K2's record per observation, in pose order: uvd (3) | stiffness row-major (9)
GROUP_SLOTS = 128  # K3's landmark groups: whole landmarks, at most this many slots...
GROUP_LANDMARKS = 32  # ...and landmarks (kGroupLandmarks in csrc/full_batch_plan.h)


class _Plan(ctypes.Structure):
    """The C side's copy of a plan (``Plan`` in csrc/full_batch_plan.h, which
    must list the same fields in the same order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "pt_start", "pt_obs", "pt_pose", "pt_q", "lm_group", "ps_start", "ps_obs", "ps_point",
        "ps_valid", "ps_contig", "free_pose", "point_valid", "rec", "y", "hg")]
        + [(n, ctypes.c_double) for n in ("fu", "fv", "cu", "cv", "fb")]
        + [(n, ctypes.c_int) for n in ("K", "J", "N", "G", "max_group", "device", "multi_device")])


class FullBatchPlan(NamedTuple):
    """One full-batch problem's fixed kernel inputs, checked by ``make_plan``."""

    camera: StereoCamera
    K: int
    J: int
    N: int
    # observation order (the plain versions read these)
    pose_idx: torch.Tensor  # [N] int64
    point_idx: torch.Tensor  # [N] int64
    uvd: torch.Tensor  # [N, 3]
    stiffness: torch.Tensor  # [N, 3, 3]
    valid: torch.Tensor  # [N] bool: observation valid and its landmark initialized
    free_pose: torch.Tensor  # [K] bool: not gauge-fixed
    point_valid: torch.Tensor  # [J] bool
    # landmark segments
    pt_start: torch.Tensor  # [J + 1] int32
    pt_obs: torch.Tensor  # [N] int32 observation of each landmark slot
    pt_pose: torch.Tensor  # [N] int32 its pose
    pt_q: torch.Tensor  # [N] int32 its position in the pose segments
    lm_group: torch.Tensor  # [G + 1] int32 first landmark of each of K3's landmark groups
    # pose segments
    ps_start: torch.Tensor  # [K + 1] int32
    ps_obs: torch.Tensor  # [N] int32 observation of each pose slot
    ps_point: torch.Tensor  # [N] int32 its landmark
    ps_valid: torch.Tensor  # [N] bool valid[ps_obs]
    ps_contig: torch.Tensor  # [K] bool: the pose's observation ids are consecutive
    rec: torch.Tensor  # [N, 12] K2's records in pose order
    # scratch, written by every launch
    y: torch.Tensor  # [J, 4] K3: Cinv U^T v by landmark, padded to 4
    hg: torch.Tensor  # [N, 12] K2: per-slot Hll | gl in pose order
    args: _Plan | None  # the C side's copy (None on the CPU)


def _group(ids: np.ndarray, n: int):
    """Stable grouping: the order, and the offsets of each group's run."""
    order = np.argsort(ids, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(ids, minlength=n))])
    return order, start


def _landmark_groups(pt_start: np.ndarray) -> np.ndarray:
    """Greedy runs of whole landmarks of at most ``GROUP_SLOTS`` slots and
    ``GROUP_LANDMARKS`` landmarks; returns each run's first landmark and J."""
    J = pt_start.size - 1
    first, j = [0], 0
    while j < J:
        hi = min(j + GROUP_LANDMARKS, J)
        end = int(np.searchsorted(pt_start[j + 1:hi + 1], pt_start[j] + GROUP_SLOTS, "right"))
        j += max(1, end)
        first.append(j)
    return np.asarray(first)


def make_plan(camera: StereoCamera, K: int, J: int, pose_idx, point_idx, uvd, stiffness, valid,
              free_pose, point_valid, dtype=torch.float64, device="cpu") -> FullBatchPlan:
    """Check, group and pack a full-batch problem's fixed K2/K3 inputs,
    given on the host (numpy arrays or CPU tensors): ``pose_idx``,
    ``point_idx``, ``uvd [N, 3]``, ``stiffness [N, 3, 3]``, ``valid [N]``
    per observation, ``free_pose [K]`` (False for a gauge-fixed pose),
    ``point_valid [J]``. An observation counts as valid only if its
    landmark is valid too."""
    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the full-batch kernels take float32 or float64, got {dtype}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the full-batch kernels run on cpu or cuda, not {device}")
    pose_idx = np.asarray(pose_idx).reshape(-1).astype(np.int64)
    point_idx = np.asarray(point_idx).reshape(-1).astype(np.int64)
    N = pose_idx.size
    if min(N, K, J) < 1 or point_idx.size != N:
        raise ValueError(f"need at least one observation, pose and landmark, with one pose and "
                         f"one landmark index each: {N} / {point_idx.size} indices, K {K}, J {J}")
    if N * REC >= 2**31:
        raise ValueError(f"{N} observations: the kernels index with 32-bit integers")
    if pose_idx.min() < 0 or pose_idx.max() >= K or point_idx.min() < 0 or point_idx.max() >= J:
        raise ValueError("pose_idx / point_idx out of range")
    arrays = {}
    for name, x, shape, kind in (("uvd", uvd, (N, 3), np.float64),
                                 ("stiffness", stiffness, (N, 3, 3), np.float64),
                                 ("valid", valid, (N,), bool), ("free_pose", free_pose, (K,), bool),
                                 ("point_valid", point_valid, (J,), bool)):
        x = np.asarray(x)
        if x.shape != shape:
            raise ValueError(f"{name}: shape {x.shape}, expected {shape}")
        arrays[name] = x.astype(kind)
    valid = arrays["valid"] & arrays["point_valid"][point_idx]

    order_l, pt_start = _group(point_idx, J)
    order_p, ps_start = _group(pose_idx, K)
    rank_p = np.empty(N, np.int64)
    rank_p[order_p] = np.arange(N)
    # breaks[i]: the steps other than +1 between consecutive ids before slot i
    breaks = np.concatenate([[0], np.cumsum(np.diff(order_p) != 1)])
    first = np.minimum(ps_start[:-1], N - 1)
    contig = breaks[np.minimum(np.maximum(ps_start[1:] - 1, first), N - 1)] == breaks[first]
    rec = np.concatenate([arrays["uvd"], arrays["stiffness"].reshape(N, 9)], axis=1)[order_p]
    groups = _landmark_groups(pt_start)
    G = groups.size - 1

    ints = telemetry.to_device(np.concatenate([
        pt_start, order_l, pose_idx[order_l], rank_p[order_l], groups, ps_start, order_p,
        point_idx[order_p]]), device, torch.int32)
    pt_start_t, pt_obs, pt_pose, pt_q, groups_t, ps_start_t, ps_obs, ps_point = ints.split(
        [J + 1, N, N, N, G + 1, K + 1, N, N])
    flags = telemetry.to_device(np.concatenate([valid, valid[order_p], contig,
                                                arrays["free_pose"], arrays["point_valid"]]),
                                device)
    valid_t, ps_valid, ps_contig, free_t, pv_t = flags.split([N, N, K, K, J])
    floats = telemetry.to_device(np.concatenate([rec.reshape(-1), arrays["uvd"].reshape(-1),
                                                 arrays["stiffness"].reshape(-1)]), device, dtype)
    rec_t, uvd_t, stiff_t = floats.split([N * REC, 3 * N, 9 * N])
    # rec and hg lead their buffers: the kernels move them in 16-byte words
    scratch = torch.empty(N * REC + J * 4, dtype=dtype, device=device)
    hg, y = scratch.split([N * REC, J * 4])
    idx = telemetry.to_device(np.stack([pose_idx, point_idx]), device)

    args = None
    if device.type == "cuda":
        args = _Plan(*(t.data_ptr() for t in (pt_start_t, pt_obs, pt_pose, pt_q, groups_t,
                                             ps_start_t, ps_obs, ps_point, ps_valid, ps_contig,
                                             free_t, pv_t, rec_t, y, hg)),
                     camera.fu, camera.fv, camera.cu, camera.cv, camera.fu * camera.b, K, J, N, G,
                     int(np.diff(groups).max()), rec_t.device.index,
                     torch.cuda.device_count() > 1)
    return FullBatchPlan(camera, K, J, N, idx[0], idx[1], uvd_t.view(N, 3),
                         stiff_t.view(N, 3, 3), valid_t, free_t, pv_t, pt_start_t, pt_obs, pt_pose,
                         pt_q, groups_t, ps_start_t, ps_obs, ps_point, ps_valid, ps_contig,
                         rec_t.view(N, REC), y.view(J, 4), hg.view(N, REC), args)


def plan_for_problem(problem) -> FullBatchPlan:
    """The plan of a ``solver.dense.StereoBAProblem``, on its device and in
    its dtype (one host round trip of its observation tables)."""
    st = problem.stereo
    K, J = problem.fixed_pose_mask.shape[0], problem.point_valid.shape[0]
    return make_plan(problem.camera, K, J, st.pose_idx.cpu(), st.point_idx.cpu(),
                     st.uvd.cpu(), st.stiffness.cpu(), st.valid.cpu(),
                     (~problem.fixed_pose_mask).cpu(), problem.point_valid.cpu(),
                     dtype=st.uvd.dtype, device=st.uvd.device)


def random_problem(N: int, J: int, K: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded ``(plan, poses, points)`` of a full-batch problem's shape, for
    checking K2 and K3 against their plain versions: poses stepping along
    z, landmarks 4-30 m ahead, observations stored pose by pose as the
    datasets store them, then a padding tail of 0.1% of the rows at pose 0
    (invalid, as ``build_window_problem`` pads: 18 rows at kitti1100, 26 at
    triangle200), ~5% invalid rows, ~3%
    invalid landmarks, pose 0 fixed. Landmark 0 is invalid and at the
    origin, and row 0 sees it from pose 0 at the origin (depth 0: masked
    rows must stay exact zeros whatever their landmark holds)."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.5, (K, 3)), rng.normal(0, 0.05, (K, 3))], axis=1)
    xi[0] = 0.0
    T = lie.se3_exp(torch.as_tensor(xi))
    pts = rng.uniform([-4, -3, 4], [4, 3, 30], (J, 3))
    pts[0] = 0.0
    n_pad = max(1, N // 1000)
    pose_idx = np.concatenate([np.sort(rng.integers(0, K, N - n_pad)), np.zeros(n_pad, np.int64)])
    point_idx = rng.integers(0, J, N)
    pose_idx[0], point_idx[0] = 0, 0
    camera = StereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)
    T_obs = T[torch.as_tensor(pose_idx)]
    uvd = camera.project(lie.se3_transform_point(T_obs, torch.as_tensor(pts[point_idx])))
    uvd = uvd + torch.as_tensor(rng.normal(0, 0.5, (N, 3)))
    uvd[0] = 0.0
    A = rng.normal(0, 0.1, (N, 3, 3))
    stiffness = 2.0 * np.eye(3) + A + A.transpose(0, 2, 1)
    valid = rng.random(N) > 0.05
    valid[0] = False
    valid[N - n_pad:] = False
    point_valid = rng.random(J) > 0.03
    point_valid[0] = False  # an uninitialized landmark, at the origin
    free_pose = np.arange(K) != 0
    plan = make_plan(camera, K, J, pose_idx, point_idx, uvd.numpy(), stiffness, valid, free_pose,
                     point_valid, dtype, device)

    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    return plan, put(T), put(pts)
