"""Carry problems over from the JAX package: numpy in, torch out.

The JAX package's ``StereoBAProblem``, ``BAState``, ``WindowLayout``,
``ObsTables``, ``ObsBlocks``, ``TrackInfo``, ``PhotometricProblem``,
``PhotometricState``, ``PhongBAProblem``, ``PhongState``,
``PoseGraphProblem`` and ``StereoFrame`` are NamedTuples; given with
numpy leaves (``jax.tree.map(np.asarray, x)``) these functions build the
port's containers on ``device``, so that a test can hand both packages the
same inputs. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_slam_tpu_torch.frontend import stereo_vo
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import window_kernel
from ceres_slam_tpu_torch.solver import (banded, dense, pcg, phong, photometric, pose_graph,
                                         window)


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
    """A JAX ``pcg.ObsBlocks`` (its ``U`` field, a reshape of ``U18``, dropped;
    no K3 binding: bind one with ``schur_kernel.bind``)."""
    return pcg.ObsBlocks(**{f: _t(getattr(b, f), device) for f in pcg.ObsBlocks._fields
                            if f not in ("pose_idx", "point_idx", "uy")},
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
    512-slot tile there, are cut back to ``M`` and packed into K1's plan."""
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
        slot_pose=_t(slot_pose, device, torch.int64),
        w_idx=_t(window.gather_table(slot_pose * J + np.repeat(np.arange(J), M // J), K * J),
                 device, torch.int64),
        plan=window_kernel.make_plan(
            problem.camera, K, J, pose_idx, np.asarray(layout.uvdT)[:, :M].T,
            np.asarray(layout.stiffT)[:, :M].T, np.asarray(layout.weightT)[0, :M],
            np.asarray(layout.pose_freeT)[0, :M], problem.stereo.uvd.dtype, device),
        pose_slots=_t(window.gather_table(slot_pose, K), device, torch.int64),
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


def phong_problem_from_numpy(problem, device="cpu") -> phong.PhongBAProblem:
    """A JAX ``phong.PhongBAProblem``; indices become int64."""
    o = problem.obs
    ints = {f: _t(getattr(o, f), device, torch.int64)
            for f in ("pose_idx", "vertex_idx", "material_idx")}
    obs = phong.PhongObs(uvd=_t(o.uvd, device), int_obs=_t(o.int_obs, device),
                         normal_obs=_t(o.normal_obs, device), valid=_t(o.valid, device), **ints)
    return phong.PhongBAProblem(
        camera=_camera(problem.camera), obs=obs,
        stereo_stiffness=_t(problem.stereo_stiffness, device),
        normal_stiffness=_t(problem.normal_stiffness, device),
        int_stiffness=_t(problem.int_stiffness, device),
        fixed_pose_mask=_t(problem.fixed_pose_mask, device),
        vertex_valid=_t(problem.vertex_valid, device))


def phong_state_from_numpy(state, device="cpu") -> phong.PhongState:
    return phong.PhongState(*(_t(x, device) for x in state))


def pose_graph_problem_from_numpy(problem, device="cpu") -> pose_graph.PoseGraphProblem:
    """A JAX ``pose_graph.PoseGraphProblem``; indices become int64."""
    r, p = problem.rel, problem.priors
    return pose_graph.PoseGraphProblem(
        rel=pose_graph.RelPoseFactors(
            idx1=_t(r.idx1, device, torch.int64), idx2=_t(r.idx2, device, torch.int64),
            T_ref=_t(r.T_ref, device), stiffness=_t(r.stiffness, device),
            valid=_t(r.valid, device)),
        priors=pose_graph.PriorFactors(idx=_t(p.idx, device, torch.int64),
                                       T_ref=_t(p.T_ref, device),
                                       stiffness=_t(p.stiffness, device),
                                       valid=_t(p.valid, device)),
        fixed_pose_mask=_t(problem.fixed_pose_mask, device))


def stereo_frame_from_numpy(frame, device="cpu") -> stereo_vo.StereoFrame:
    """A JAX ``stereo_vo.StereoFrame`` (no corner count)."""
    return stereo_vo.StereoFrame(*(_t(x, device) for x in frame))
