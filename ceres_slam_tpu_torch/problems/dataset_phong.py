"""Phong BA dataset layer: CSV input, VO initial guess, staged solves.

Port of ``ceres_slam_tpu/problems/dataset_phong.py`` (the reference's
``dataset_problem_phong``). Track CSV: header ``K,J,M``; intrinsics; the
stereo (3), normal (3) and intensity (1) variances; the initial light
position or direction; the first pose as a row-major 4x4; then rows
``[t, j, m, u, v, d, I, nx, ny, nz]``. ``write_csv`` writes
``_poses.csv``, ``_map.csv`` (``point_id,x,y,z,nx,ny,nz,ka,ks,exponent,kd``)
and ``_lights.csv``.

Index bookkeeping is host numpy; the batched RANSAC (the JAX package's
hypotheses, pair k under seed ``rng_seed + k``, 9 px^2 threshold) and the
solves run on ``device``. Every window's problem is padded to one budget
of observations and vertices, as in the JAX package (there so that XLA
reuses one program): the padding changes no value, and it keeps each
window's size, and so ``auto``'s choice of linear solver, equal to JAX's.
Here it also gives every window of a pass one shape, and with its gather
tables padded to one width (``_table_widths``), the pass's LM loops on the
card are captured once a stage and restarted for every later window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors
from ceres_slam_tpu_torch.problems.dataset import _round_up, run_batched_ransac
from ceres_slam_tpu_torch.frontend import alignment
from ceres_slam_tpu_torch.solver import lm as lm_mod
from ceres_slam_tpu_torch.solver import phong as phong_mod
from ceres_slam_tpu_torch.utils import csvio, se3np
from ceres_slam_tpu_torch.utils import device as device_mod
from ceres_slam_tpu_torch.utils import telemetry


@dataclasses.dataclass
class DatasetProblemPhong:
    camera: StereoCamera = None
    directional_light: bool = False
    num_states: int = 0
    num_vertices: int = 0
    num_materials: int = 0
    poses: np.ndarray = None  # [K, 12]
    vertex_positions: np.ndarray = None  # [J, 3]
    vertex_normals: np.ndarray = None  # [J, 3]
    material_of_vertex: np.ndarray = None  # [J]
    materials: np.ndarray = None  # [M, 3] Phong parameters
    textures: np.ndarray = None  # [M]
    light: np.ndarray = None  # [3]
    initialized_vertex: np.ndarray = None  # [J] bool
    state_ids: np.ndarray = None  # [N] (timestamps mapped to state index)
    vertex_ids: np.ndarray = None  # [N]
    material_ids: np.ndarray = None  # [N]
    obs_list: np.ndarray = None  # [N, 3]
    int_list: np.ndarray = None  # [N]
    normal_obs_list: np.ndarray = None  # [N, 3]
    stereo_obs_var: np.ndarray = None  # [3]
    normal_obs_var: np.ndarray = None  # [3]
    int_var: float = 0.0
    ransac_iters: int = 400
    ransac_thresh: float = 9.0
    rng_seed: int = 42
    dtype: str = "float64"
    # where RANSAC and the solves run: "cuda" (raises without a card) or "cpu"
    device: str = "cuda"

    @property
    def _dt(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def _device(self) -> torch.device:
        return device_mod.resolve(self.device)

    # -- IO -----------------------------------------------------------------

    @classmethod
    def read_csv(cls, filename: str, directional_light: bool = False):
        self = cls(directional_light=directional_light)
        rows = csvio.read_numeric_csv(filename)
        self.num_states, self.num_vertices, self.num_materials = (int(x) for x in rows[0][:3])
        self.camera = StereoCamera.create(*rows[1][:5])
        self.stereo_obs_var = np.asarray(rows[2][:3])
        self.normal_obs_var = np.asarray(rows[2][3:6])
        self.int_var = float(rows[2][6])
        self.light = np.asarray(rows[3][:3])
        if directional_light:
            self.light = self.light / np.linalg.norm(self.light)
        T_0_g = np.asarray(rows[4][:16]).reshape(4, 4)

        body = np.asarray(rows[5:])
        # timestamps may be arbitrary: dense state ids by change points
        t = body[:, 0]
        self.state_ids = np.concatenate([[0], np.cumsum(t[1:] != t[:-1])]).astype(np.int64)
        self.vertex_ids = body[:, 1].astype(np.int64)
        self.material_ids = body[:, 2].astype(np.int64)
        self.obs_list = body[:, 3:6].copy()
        self.int_list = body[:, 6].copy()
        self.normal_obs_list = body[:, 7:10].copy()

        K, J, M = self.num_states, self.num_vertices, self.num_materials
        self.poses = np.zeros((K, 12))
        self.poses[:] = np.concatenate([np.zeros(3), np.eye(3).reshape(9)])
        self.poses[0] = np.concatenate([T_0_g[:3, 3], T_0_g[:3, :3].reshape(9)])
        self.vertex_positions = np.zeros((J, 3))
        self.vertex_normals = np.tile(np.array([0.0, 0.0, 1.0]), (J, 1))
        self.material_of_vertex = np.zeros(J, np.int64)
        self.material_of_vertex[self.vertex_ids] = self.material_ids  # the last row wins
        self.materials = np.tile(np.array([0.0, 0.0, 1.0]), (M, 1))
        self.textures = np.full(M, 0.5)
        self.initialized_vertex = np.zeros(J, bool)
        self._state_obs = [np.nonzero(self.state_ids == k)[0] for k in range(K)]
        self._pts_c = self.camera.triangulate(torch.as_tensor(self.obs_list)).numpy()
        max_matches = 1
        for k in range(1, K):
            m = np.intersect1d(self.vertex_ids[self._state_obs[k - 1]],
                               self.vertex_ids[self._state_obs[k]]).size
            max_matches = max(max_matches, m)
        self._match_pad = _round_up(max_matches)
        self._pair_T = None
        return self

    def obs_indices_for_material(self, m):
        return np.nonzero(self.material_ids == m)[0]

    def reset_points(self):
        self.initialized_vertex[:] = False

    def write_csv(self, filename: str):
        base = filename.rsplit(".", 1)[0]
        csvio.write_poses_csv(base + "_poses.csv", self.poses)
        with open(base + "_map.csv", "w") as f:
            f.write("point_id, x, y, z, nx, ny, nz, ka, ks, exponent, kd\n")
            for j in range(self.num_vertices):
                if self.initialized_vertex[j]:
                    m = self.material_of_vertex[j]
                    vals = (list(self.vertex_positions[j]) + list(self.vertex_normals[j])
                            + list(self.materials[m]) + [self.textures[m]])
                    f.write(f"{j}," + ",".join(repr(float(x)) for x in vals) + "\n")
        with open(base + "_lights.csv", "w") as f:
            f.write("i, j, k\n" if self.directional_light else "x, y, z\n")
            f.write(",".join(repr(float(x)) for x in self.light) + "\n")

    # -- initial guess ---------------------------------------------------------

    def _pair_match(self, k: int):
        idx_a, idx_b = self._state_obs[k - 1], self._state_obs[k]
        _, ia, ib = np.intersect1d(self.vertex_ids[idx_a], self.vertex_ids[idx_b],
                                   return_indices=True)
        return idx_a[ia], idx_b[ib]

    def precompute_pair_alignments(self):
        """RANSAC for all consecutive pairs at once (idempotent), in the
        solver dtype, on the JAX package's hypotheses."""
        if self._pair_T is not None:
            return
        K, P = self.num_states, self._match_pad
        dt = np.dtype(self.dtype)
        pts0 = np.zeros((K, P, 3), dt)
        pts1 = np.zeros((K, P, 3), dt)
        valid = np.zeros((K, P), bool)
        for k in range(1, K):
            idx_a, idx_b = self._pair_match(k)
            n = idx_a.size
            pts0[k, :n] = self._pts_c[idx_a]
            pts1[k, :n] = self._pts_c[idx_b]
            valid[k, :n] = True
        with telemetry.span("phong.ransac"):
            hyp_idx = alignment.draw_jax_hypotheses(
                telemetry.to_device(valid, self._device), self.ransac_iters,
                self.rng_seed + torch.arange(K))
            self._pair_T, self._pair_inliers, _ = run_batched_ransac(
                self.camera, pts0, pts1, valid, hyp_idx, self.ransac_thresh, self._device)

    def compute_initial_guess(self, k1: int = 0, k2: int = 0):
        """Materials (Phong (0, 0, 1), texture = the median observed
        intensity of the material), then the pair alignments chained over
        ``[k1, k2)``, initializing the inlier vertices' positions and
        normals; a pair with fewer than 3 matches carries the previous pose."""
        with telemetry.span("phong.initial_guess", k1=k1, k2=k2):
            if k1 >= k2:
                k1, k2 = 0, self.num_states
            self.precompute_pair_alignments()
            for m in range(self.num_materials):
                self.materials[m] = [0.0, 0.0, 1.0]
                ints = self.int_list[self.obs_indices_for_material(m)]
                if ints.size:
                    half = ints.size // 2
                    self.textures[m] = np.partition(ints, half)[half]
            for k in range(k1 + 1, k2):
                idx_a, _ = self._pair_match(k)
                n = idx_a.size
                if n < 3:
                    self.poses[k] = self.poses[k - 1]
                    continue
                self.poses[k] = se3np.compose(self._pair_T[k], self.poses[k - 1])
                inl = self._pair_inliers[k, :n]
                jj = self.vertex_ids[idx_a[inl]]
                new = ~self.initialized_vertex[jj]
                if np.any(new):
                    T_inv = se3np.inverse(self.poses[k - 1])
                    p_g = se3np.transform_point(T_inv, self._pts_c[idx_a[inl]])
                    n_g = se3np.transform_vector(T_inv, self.normal_obs_list[idx_a[inl]])
                    self.vertex_positions[jj[new]] = p_g[new]
                    norms = np.linalg.norm(n_g[new], axis=-1, keepdims=True)
                    self.vertex_normals[jj[new]] = n_g[new] / np.maximum(norms, 1e-12)
                    self.initialized_vertex[jj[new]] = True

    # -- solving ---------------------------------------------------------------

    def _window_budget(self, window: int):
        """Pad sizes (observations, vertices) shared by every window."""
        max_obs, max_vtx = 1, 1
        for k1 in range(0, self.num_states - window + 1):
            sel = np.concatenate(self._state_obs[k1:k1 + window])
            max_obs = max(max_obs, sel.size)
            max_vtx = max(max_vtx, np.unique(self.vertex_ids[sel]).size)
        return _round_up(max_obs), _round_up(max_vtx)

    def _window_obs(self, k1: int, k2: int):
        """Window ``[k1, k2)``'s observations, its active vertices (global
        ids) and each observation's vertex slot among them."""
        sel = np.concatenate(self._state_obs[k1:k2])
        slots, local_v = np.unique(self.vertex_ids[sel], return_inverse=True)
        return sel, slots, local_v

    def _table_widths(self, window: int) -> dict:
        """The gather tables' widths shared by every window of a pass
        (``phong.table_widths``, the largest over the windows; the vertices
        initialized as they are now), so that the pass's LM loops capture
        once per stage and restart for every later window."""
        widths = {}
        for k1 in range(0, self.num_states - window + 1):
            k2 = min(k1 + window, self.num_states)
            sel, slots, local_v = self._window_obs(k1, k2)
            valid = self.initialized_vertex[slots][local_v]
            ids = phong_mod.table_ids(self.state_ids[sel] - k1, local_v, self.material_ids[sel],
                                      valid, k2 - k1, slots.size, self.num_materials)
            for k, w in phong_mod.table_widths(ids).items():
                widths[k] = max(w, widths.get(k, 1))
        return widths

    def build_window_problem(self, k1: int, k2: int, n_obs_pad: int, n_vtx_pad: int):
        """The padded problem and state of window ``[k1, k2)`` on ``device``:
        the window's active vertices (in slots ``[0, n_vtx_pad)``), the
        global materials, textures and light. Returns ``(problem, state,
        slots)``, ``slots`` the global ids of the active vertices."""
        with telemetry.span("phong.build_problem", k1=k1, k2=k2):
            Kw = k2 - k1
            sel, slots, local_v = self._window_obs(k1, k2)
            n_obs, n_vtx = sel.size, slots.size
            if n_obs > n_obs_pad or n_vtx > n_vtx_pad:
                raise ValueError("window pad budget too small")
            dev, dt = self._device, self._dt
            uvd = np.zeros((n_obs_pad, 3))
            uvd[:n_obs] = self.obs_list[sel]
            ints = np.zeros(n_obs_pad)
            ints[:n_obs] = self.int_list[sel]
            nobs = np.tile(np.array([0.0, 0.0, 1.0]), (n_obs_pad, 1))
            nobs[:n_obs] = self.normal_obs_list[sel]
            idx = np.zeros((3, n_obs_pad), np.int64)
            idx[:, :n_obs] = [self.state_ids[sel] - k1, local_v, self.material_ids[sel]]
            valid = np.arange(n_obs_pad) < n_obs
            vertex_valid = np.zeros(n_vtx_pad, bool)
            vertex_valid[:n_vtx] = self.initialized_vertex[slots]

            def put(x, dtype=dt):
                return telemetry.to_device(x, dev, dtype)

            ii = put(idx, torch.int64)
            obs = phong_mod.PhongObs(uvd=put(uvd), int_obs=put(ints), normal_obs=put(nobs),
                                     pose_idx=ii[0], vertex_idx=ii[1], material_idx=ii[2],
                                     valid=put(valid, torch.bool))
            fixed = np.zeros(Kw, bool)
            fixed[0] = True
            problem = phong_mod.PhongBAProblem(
                camera=self.camera, obs=obs,
                stereo_stiffness=factors.inv_sqrt_psd(torch.diag(put(self.stereo_obs_var))),
                normal_stiffness=factors.inv_sqrt_psd(torch.diag(put(self.normal_obs_var))),
                int_stiffness=put(1.0 / np.sqrt(self.int_var)),
                fixed_pose_mask=put(fixed, torch.bool), vertex_valid=put(vertex_valid, torch.bool))
            pts = np.zeros((n_vtx_pad, 3))
            pts[:n_vtx] = self.vertex_positions[slots]
            nrm = np.tile(np.array([0.0, 0.0, 1.0]), (n_vtx_pad, 1))  # unit padding: the
            nrm[:n_vtx] = self.vertex_normals[slots]  # projector of a zero normal is singular
            state = phong_mod.PhongState(poses=put(self.poses[k1:k2]), points=put(pts),
                                         normals=put(nrm), phong=put(self.materials),
                                         textures=put(self.textures), light=put(self.light))
            return problem, state, slots

    def absorb_window_solution(self, k1, k2, sol: phong_mod.PhongState, slots: np.ndarray):
        with telemetry.span("phong.absorb", k1=k1, k2=k2):
            self.poses[k1:k2] = sol.poses.cpu().numpy()
            upd = self.initialized_vertex[slots]
            self.vertex_positions[slots[upd]] = sol.points.cpu().numpy()[:slots.size][upd]
            self.vertex_normals[slots[upd]] = sol.normals.cpu().numpy()[:slots.size][upd]
            self.materials = sol.phong.cpu().numpy().astype(np.float64)
            self.textures = sol.textures.cpu().numpy().astype(np.float64)
            self.light = sol.light.cpu().numpy().astype(np.float64)

    def solve_full(self, window: int = 0, use_light: bool = True, multistage: bool = False,
                   config: lm_mod.SolveConfig | None = None, linear_solver: str = "auto",
                   lm_loop: str | None = None):
        """The ``dataset_ba_phong`` pipeline: the full-trajectory initial
        guess, then windowed (``window`` poses) or full-batch (0) staged
        solves. ``lm_loop``: ``phong.solve_phong_ba``'s (``"device"``, the
        default on the card: each stage one WHILE node; ``"host"``). The
        pass keeps one ``lm.LMGraph``: every window is padded to one budget
        and its tables to one width, so the first window captures each
        stage once and every later window restarts those captures. Returns
        every stage's ``SolveSummary``."""
        config = config or lm_mod.SolveConfig(max_iters=100)
        lm_loop = phong_mod.resolve_lm_loop(self._device, lm_loop)
        K = self.num_states
        window = window or K
        n_obs_pad, n_vtx_pad = self._window_budget(window)
        widths = None
        if window < K:
            # the reference initializes the whole chain before the window
            # loop; each window then re-initializes only its newest frame
            self.compute_initial_guess()
            widths = self._table_widths(window)
        graph = lm_mod.LMGraph() if lm_loop == "device" else None
        summaries = []
        try:
            for k1 in range(0, K - window + 1):
                k2 = min(k1 + window, K)
                if k1 > 0:
                    self.compute_initial_guess(k2 - 1, k2)
                else:
                    self.compute_initial_guess(k1, k2)
                problem, state, slots = self.build_window_problem(k1, k2, n_obs_pad, n_vtx_pad)
                sol, stage_summaries = phong_mod.solve_phong_staged(
                    problem, state, config, use_light=use_light,
                    directional=self.directional_light, multistage=multistage,
                    linear_solver=linear_solver, lm_loop=lm_loop, graph=graph, widths=widths)
                self.absorb_window_solution(k1, k2, sol, slots)
                summaries.extend(stage_summaries)
        finally:
            if graph is not None:
                graph.close()
        return summaries
