"""Carry problems over from the JAX package: numpy in, torch out.

The JAX package's ``StereoBAProblem``, ``BAState``, ``WindowLayout``,
``ObsTables``, ``ObsBlocks``, ``TrackInfo``, ``PhotometricProblem`` and
``PhotometricState`` are NamedTuples; given with
numpy leaves (``jax.tree.map(np.asarray, x)``) these functions build the
port's containers on ``device``, so that a test can hand both packages the
same inputs. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.solver import banded, dense, pcg, photometric, window


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def _camera(camera) -> StereoCamera:
    return StereoCamera.create(*(np.asarray(v) for v in camera))


def problem_from_numpy(problem, device="cpu") -> dense.StereoBAProblem:
    st, sun, pr = problem.stereo, problem.sun, problem.prior
    return dense.StereoBAProblem(
        camera=_camera(problem.camera),
        stereo=dense.StereoObs(
            uvd=_t(st.uvd, device), stiffness=_t(st.stiffness, device),
            pose_idx=_t(st.pose_idx, device, torch.int64),
            point_idx=_t(st.point_idx, device, torch.int64), valid=_t(st.valid, device),
        ),
        sun=dense.SunObs(dir_c=_t(sun.dir_c, device), dir_g=_t(sun.dir_g, device),
                         stiffness=_t(sun.stiffness, device), valid=_t(sun.valid, device)),
        prior=dense.PosePrior(pose_idx=int(pr.pose_idx), T_ref=_t(pr.T_ref, device),
                              stiffness=_t(pr.stiffness, device), valid=bool(pr.valid)),
        fixed_pose_mask=_t(problem.fixed_pose_mask, device),
        point_valid=_t(problem.point_valid, device),
        sun_huber=float(problem.sun_huber),
        az_err_thresh=float(problem.az_err_thresh),
        zen_err_thresh=float(problem.zen_err_thresh),
    )


def state_from_numpy(state, device="cpu") -> dense.BAState:
    return dense.BAState(poses=_t(state.poses, device), points=_t(state.points, device))


def obs_tables_from_numpy(tables, pose_idx, point_idx, device="cpu") -> pcg.ObsTables:
    """The JAX gather tables, with the slot pose / landmark tables that the
    port's ``ObsTables`` adds, derived from the observation indices."""
    bp, bk = np.asarray(tables.by_point), np.asarray(tables.by_pose)
    pose_idx, point_idx = np.asarray(pose_idx), np.asarray(point_idx)
    return pcg.ObsTables(
        by_point=_t(bp, device, torch.int32), by_point_w=_t(tables.by_point_w, device, torch.float32),
        by_pose=_t(bk, device, torch.int32), by_pose_w=_t(tables.by_pose_w, device, torch.float32),
        by_point_pose=_t(pose_idx[bp], device, torch.int32),
        by_pose_point=_t(point_idx[bk], device, torch.int32))


def obs_blocks_from_numpy(b, device="cpu") -> pcg.ObsBlocks:
    """A JAX ``pcg.ObsBlocks`` (its ``U`` field, a reshape of ``U18``, dropped)."""
    return pcg.ObsBlocks(**{f: _t(getattr(b, f), device) for f in pcg.ObsBlocks._fields
                            if f not in ("pose_idx", "point_idx")},
                         pose_idx=_t(b.pose_idx, device, torch.int64),
                         point_idx=_t(b.point_idx, device, torch.int64))


def track_info_from_numpy(t, device="cpu") -> banded.TrackInfo:
    """A JAX ``banded.TrackInfo``; index tables become int64."""
    arrays = {f: _t(getattr(t, f), device, torch.int64)
              for f in ("slots", "start", "by_bin", "start_bins")}
    arrays.update({f: _t(getattr(t, f), device) for f in ("slot_w", "by_bin_w", "start_bins_w")})
    return banded.TrackInfo(L=int(t.L), n_super=int(t.n_super), eligible_frac=float(t.eligible_frac),
                            **arrays)


def layout_from_numpy(layout, device="cpu") -> window.WindowLayout:
    """The JAX layout's ``[M, K]`` pose one-hot becomes the slot pose index
    (``-1`` for padding slots); its lane-major kernel inputs, padded to a
    512-slot tile there, are cut back to ``M``."""
    problem = problem_from_numpy(layout.problem, device)
    onehot = np.asarray(layout.onehot)
    M, K = onehot.shape
    J = problem.point_valid.shape[0]
    has_pose = onehot.sum(axis=1) > 0
    pose_idx = np.where(has_pose, onehot.argmax(axis=1), -1)
    slot_pose = np.where(has_pose, pose_idx, K)
    return window.WindowLayout(
        problem=problem,
        O=M // J,
        pose_idx=_t(pose_idx, device, torch.int32),
        slot_pose=_t(slot_pose, device, torch.int64),
        w_idx=_t(slot_pose * J + np.repeat(np.arange(J), M // J), device, torch.int64),
        uvdT=_t(np.ascontiguousarray(np.asarray(layout.uvdT)[:, :M]), device),
        stiffT=_t(np.ascontiguousarray(np.asarray(layout.stiffT)[:, :M]), device),
        weight=_t(np.asarray(layout.weightT)[0, :M].copy(), device),
        pose_free=_t(np.asarray(layout.pose_freeT)[0, :M].copy(), device),
    )


def photometric_problem_from_numpy(problem, device="cpu") -> photometric.PhotometricProblem:
    """A JAX ``photometric.PhotometricProblem``; the disparity stiffness
    becomes a Python float."""
    arrays = {f: _t(getattr(problem, f), device)
              for f in photometric.PhotometricProblem._fields
              if f not in ("camera", "disp_stiffness")}
    return photometric.PhotometricProblem(camera=_camera(problem.camera),
                                          disp_stiffness=float(np.asarray(problem.disp_stiffness)),
                                          **arrays)


def photometric_state_from_numpy(state, device="cpu") -> photometric.PhotometricState:
    return photometric.PhotometricState(T=_t(state.T, device),
                                        disparities=_t(state.disparities, device))
