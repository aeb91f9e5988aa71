"""FactorGraph — ``ceres::Problem``-style incremental problem assembly.

Port of ``ceres_slam_tpu/solver/graph.py``: a host-side class that
collects variables (numpy arrays) and factors, then ``build()``s the padded
batched problem the solvers take, on ``device`` (default ``cuda``; pass
``device="cpu"`` to run on the CPU). For users assembling custom problems
(the dataset layer builds its problems directly).

    g = FactorGraph(camera)
    k0 = g.add_pose(T0, fixed=True)
    k1 = g.add_pose(T1)
    j = g.add_point(p)
    g.add_stereo_obs(k0, j, uvd0, covariance=np.diag([.25, .25, .49]))
    g.add_stereo_obs(k1, j, uvd1)
    g.add_pose_prior(k0, T0, covariance=1e-6 * np.eye(6))
    sol, summary = g.solve()          # linear_solver 'dense' | 'schur' | 'pcg'
    cov = g.covariance(k1)

Observations keep the order they were added in; ``build()`` pads them to a
multiple of 32 with invalid rows at pose 0 and landmark 0. On CUDA the
``pcg`` solver builds the full-batch plan of that order and runs the
kernels K2 and K3 (``solver/pcg.py``); every LM solve (``dense``,
``schur``, ``pcg``) and the dense dogleg run their loop as a conditional
WHILE node on the card by default (``lm_loop``).
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.utils import device as device_mod
from ceres_slam_tpu_torch.utils import se3np


def _round_up(n: int, m: int = 32) -> int:
    return max(m, ((n + m - 1) // m) * m)


class FactorGraph:
    def __init__(self, camera: StereoCamera, default_stereo_var=(1.0, 1.0, 1.0), device="cuda"):
        self.camera = camera
        self.device = device_mod.resolve(device)
        self._default_cov = np.diag(default_stereo_var)
        self._poses: list = []
        self._fixed: list = []
        self._points: list = []
        self._stereo: list = []  # (pose_id, point_id, uvd, cov)
        self._sun: dict = {}  # pose_id -> (dir_c, dir_g, cov)
        self._prior = None  # (pose_id, T_ref, cov)
        self._huber = 0.0
        self._az_thresh = 1000.0
        self._zen_thresh = 1000.0
        self._solution = None

    # -- variables ----------------------------------------------------------

    def add_pose(self, T, fixed: bool = False) -> int:
        self._poses.append(np.asarray(T, float))
        self._fixed.append(bool(fixed))
        return len(self._poses) - 1

    def add_point(self, p) -> int:
        self._points.append(np.asarray(p, float))
        return len(self._points) - 1

    def set_pose_constant(self, pose_id: int, fixed: bool = True):
        """SetParameterBlockConstant / Variable."""
        self._fixed[pose_id] = bool(fixed)

    # -- factors ------------------------------------------------------------

    def add_stereo_obs(self, pose_id: int, point_id: int, uvd, covariance=None):
        cov = self._default_cov if covariance is None else np.asarray(covariance)
        self._stereo.append((pose_id, point_id, np.asarray(uvd, float), cov))

    def add_sun_obs(self, pose_id: int, dir_c, dir_g, covariance=None):
        cov = np.eye(2) if covariance is None else np.asarray(covariance)
        self._sun[pose_id] = (np.asarray(dir_c, float), np.asarray(dir_g, float), cov)

    def add_pose_prior(self, pose_id: int, T_ref, covariance=None):
        cov = np.eye(6) if covariance is None else np.asarray(covariance)
        self._prior = (pose_id, np.asarray(T_ref, float), cov)

    def set_sun_robust_loss(self, huber_param: float):
        self._huber = float(huber_param)

    def set_sun_gating(self, az_err_thresh: float, zen_err_thresh: float):
        """Hard outlier gating thresholds in radians."""
        self._az_thresh = float(az_err_thresh)
        self._zen_thresh = float(zen_err_thresh)

    # -- build / solve -------------------------------------------------------

    def build(self):
        """``(StereoBAProblem, BAState)`` on the graph's device, float64; the
        stiffnesses (inverse square roots of the covariances) are computed
        on the host, as the dataset layer computes them."""
        K, J, n = len(self._poses), max(1, len(self._points)), len(self._stereo)
        N = _round_up(max(1, n))
        uvd = np.zeros((N, 3))
        covs = np.broadcast_to(np.eye(3), (N, 3, 3)).copy()
        pose_idx = np.zeros(N, np.int64)
        point_idx = np.zeros(N, np.int64)
        valid = np.arange(N) < n
        if n:
            k, j, o, c = zip(*self._stereo)
            pose_idx[:n], point_idx[:n], uvd[:n], covs[:n] = k, j, np.stack(o), np.stack(c)

        def t(x, dtype=torch.float64):
            return torch.as_tensor(x, dtype=dtype).to(self.device)

        stereo = dense.StereoObs(uvd=t(uvd), stiffness=t(se3np.inv_sqrt_psd(covs)),
                                 pose_idx=t(pose_idx, torch.int64),
                                 point_idx=t(point_idx, torch.int64), valid=t(valid, torch.bool))

        sun_dir_c, sun_dir_g = np.zeros((K, 3)), np.zeros((K, 3))
        sun_cov = np.broadcast_to(np.eye(2), (K, 2, 2)).copy()
        sun_valid = np.zeros(K, bool)
        for k, (dc, dg, c) in self._sun.items():
            sun_dir_c[k] = dc / max(np.linalg.norm(dc), 1e-30)
            sun_dir_g[k] = dg / max(np.linalg.norm(dg), 1e-30)
            sun_cov[k] = c
            sun_valid[k] = True
        sun = dense.SunObs(dir_c=t(sun_dir_c), dir_g=t(sun_dir_g),
                           stiffness=t(se3np.inv_sqrt_psd(sun_cov)),
                           valid=t(sun_valid, torch.bool))

        if self._prior is not None:
            pid, T_ref, cov = self._prior
            prior = dense.PosePrior(pose_idx=int(pid), T_ref=t(T_ref),
                                    stiffness=t(se3np.inv_sqrt_psd(np.asarray(cov, float))),
                                    valid=True)
        else:
            prior = dense.PosePrior(pose_idx=0,
                                    T_ref=t(np.concatenate([np.zeros(3), np.eye(3).reshape(9)])),
                                    stiffness=t(np.eye(6)), valid=False)

        pts = np.zeros((J, 3))
        if self._points:
            pts[: len(self._points)] = np.stack(self._points)
        problem = dense.StereoBAProblem(
            camera=self.camera, stereo=stereo, sun=sun, prior=prior,
            fixed_pose_mask=t(np.asarray(self._fixed, bool), torch.bool),
            point_valid=t(np.arange(J) < len(self._points), torch.bool),
            sun_huber=self._huber, az_err_thresh=self._az_thresh,
            zen_err_thresh=self._zen_thresh)
        return problem, dense.BAState(poses=t(np.stack(self._poses)), points=t(pts))

    def solve(self, config: lm.SolveConfig = lm.SolveConfig(max_iters=100),
              linear_solver: str = "dense", strategy: str = "lm", cg_loop: str | None = None,
              lm_loop: str | None = None):
        """Solve and absorb the solution into the graph's variables.

        ``linear_solver``: ``'dense'`` | ``'schur'`` | ``'pcg'`` (Ceres'
        DENSE_NORMAL_CHOLESKY / SPARSE_SCHUR / ITERATIVE_SCHUR);
        ``strategy`` (``'lm'`` | ``'dogleg'``) applies to ``'dense'``;
        ``lm_loop`` (``'device'`` | ``'host'``): the trust-region loop of
        every solver and strategy, a WHILE node on the card by default
        there (``'device'`` raises elsewhere); ``cg_loop`` applies
        to ``'pcg'``: its CG loop (``pcg.solve_ba_pcg``'s ``loop``, on the
        card by default too)."""
        if linear_solver != "pcg" and cg_loop:
            raise ValueError(f"cg_loop sets the pcg solver's CG loop, not {linear_solver!r}'s")
        problem, state = self.build()
        if linear_solver == "schur":
            from ceres_slam_tpu_torch.solver import schur

            sol, summary = schur.solve_ba_schur(problem, state, config, lm_loop=lm_loop)
        elif linear_solver == "pcg":
            from ceres_slam_tpu_torch.solver import pcg

            sol, summary = pcg.solve_ba_pcg(problem, state, config, loop=cg_loop,
                                            lm_loop=lm_loop)
        elif linear_solver == "dense":
            sol, summary = dense.solve_ba(problem, state, config, strategy=strategy,
                                          lm_loop=lm_loop)
        else:
            raise ValueError(f"unknown linear solver: {linear_solver!r}")
        self._solution = (problem, sol)
        poses, points = sol.poses.cpu().numpy(), sol.points.cpu().numpy()
        self._poses = list(poses[: len(self._poses)])
        self._points = list(points[: len(self._points)])
        return sol, summary

    def covariance(self, pose_id: int) -> np.ndarray:
        """6x6 tangent-space marginal covariance at the last solution
        (``GetCovarianceBlockInTangentSpace``)."""
        if self._solution is None:
            raise RuntimeError("solve() first")
        problem, sol = self._solution
        return dense.pose_tangent_covariance(problem, sol, pose_id).cpu().numpy()

    def pose(self, pose_id: int) -> np.ndarray:
        return self._poses[pose_id]

    def point(self, point_id: int) -> np.ndarray:
        return self._points[point_id]
