"""Phong-illumination bundle adjustment: joint geometry and lighting.

Port of ``ceres_slam_tpu/solver/phong.py`` (the reference's
``dataset_ba_phong``): stereo reprojection, intensity and normal factors
over poses, vertex positions, vertex normals, per-material Phong
parameters and textures shared by gather on the material id, and one light
(a point's position or a unit direction). Normals and a light direction
live on the unit sphere (the tangent projector chained into their
Jacobians, and the unit-vector retraction); the Phong parameters are boxed
to ``[0, 1]^2 x [1, inf)`` and the textures to ``[0, 1]`` by projection
after each step; the optional 3-stage schedule is geometry only, then
lighting only with the geometry frozen, then the joint solve.

The dense linear solver (``linear_solver="dense"``, window scale) builds
the ``[D, D]`` normal equations from per-observation blocks summed by
their target block (``dense.segment_sum``: a gather and a sum over a fixed
axis, so the card gives the same bits every run); ``solver/phong_schur.py``
is the vertex-Schur solver for full batches. Masks are ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import dense, lm


class PhongObs(NamedTuple):
    """Per-observation data (CSV rows ``[t, j, m, u, v, d, I, nx, ny, nz]``)."""

    uvd: torch.Tensor  # [N, 3]
    int_obs: torch.Tensor  # [N]
    normal_obs: torch.Tensor  # [N, 3] observed normals, camera frame
    pose_idx: torch.Tensor  # [N] int64
    vertex_idx: torch.Tensor  # [N] int64
    material_idx: torch.Tensor  # [N] int64
    valid: torch.Tensor  # [N] bool


class PhongBAProblem(NamedTuple):
    camera: StereoCamera
    obs: PhongObs
    stereo_stiffness: torch.Tensor  # [3, 3] shared
    normal_stiffness: torch.Tensor  # [3, 3] shared
    int_stiffness: torch.Tensor  # [] 1/sqrt(int_var)
    fixed_pose_mask: torch.Tensor  # [K] bool
    vertex_valid: torch.Tensor  # [J] bool


class PhongState(NamedTuple):
    poses: torch.Tensor  # [K, 12]
    points: torch.Tensor  # [J, 3] vertex positions (global)
    normals: torch.Tensor  # [J, 3] vertex normals (global, unit)
    phong: torch.Tensor  # [M, 3] [ambient, specular, exponent] per material
    textures: torch.Tensor  # [M] per-material diffuse albedo
    light: torch.Tensor  # [3] light position (point) or direction (directional)


def _offsets(state: PhongState):
    """Offsets of the point, normal, Phong, texture and light blocks in the
    full tangent vector ``[6K | 3J | 3J | 3M | M | 3]``, and its size D."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    off_pt = 6 * K
    off_n = off_pt + 3 * J
    off_ph = off_n + 3 * J
    off_tex = off_ph + 3 * M
    off_light = off_tex + M
    return off_pt, off_n, off_ph, off_tex, off_light, off_light + 3


def obs_valid(problem: PhongBAProblem) -> torch.Tensor:
    """``[N]`` bool: the observation is valid and its vertex initialized."""
    return problem.obs.valid & problem.vertex_valid[problem.obs.vertex_idx]


def _gathered_terms(problem: PhongBAProblem, state: PhongState, directional: bool):
    """Every factor's whitened residual and Jacobians per observation, the
    unit-vector projectors chained in; and the ``[N]`` validity mask."""
    o = problem.obs
    T = state.poses[o.pose_idx]
    pts = state.points[o.vertex_idx]
    nrm = state.normals[o.vertex_idx]
    ph = state.phong[o.material_idx]
    tex = state.textures[o.material_idx]
    N = o.uvd.shape[0]
    st = factors.stereo_reprojection(problem.camera, T, pts, o.uvd,
                                     problem.stereo_stiffness.expand(N, 3, 3))
    r_n, Jp_n, Jn_n = factors.normal_obs(T, nrm, o.normal_obs,
                                         problem.normal_stiffness.expand(N, 3, 3))
    intensity = (factors.intensity_directional_light if directional
                 else factors.intensity_point_light)
    r_i, Jp_i, Jpt_i, Jn_i, Jph_i, Jtex_i, Jl_i = intensity(
        T, pts, nrm, ph, tex, state.light, o.int_obs, problem.int_stiffness.expand(N))

    # the unit-vector tangent projectors (the reference's
    # UnitVectorPerturbation parameterization Jacobian)
    P_n = factors.unit_vector_tangent_projector(nrm)
    Jn_n = Jn_n @ P_n
    Jn_i = lie._mv(P_n.transpose(-1, -2), Jn_i)
    if directional:
        Jl_i = Jl_i @ factors.unit_vector_tangent_projector(state.light)
    return st, (r_n, Jp_n, Jn_n), (r_i, Jp_i, Jpt_i, Jn_i, Jph_i, Jtex_i, Jl_i), obs_valid(problem)


def phong_cost(problem: PhongBAProblem, state: PhongState, use_light: bool,
               directional: bool) -> torch.Tensor:
    st, nr, it, valid = _gathered_terms(problem, state, directional)
    sq = torch.sum(st[0] ** 2, dim=-1)
    if use_light:
        sq = sq + torch.sum(nr[0] ** 2, dim=-1) + it[0] ** 2
    return 0.5 * torch.sum(torch.where(valid, sq, 0.0))


def _accumulate(H, g, r, blocks, valid, tables: dict):
    """Add one factor batch's normal equations to ``(H, g)`` in place.
    ``blocks`` lists ``(offset, count, kind, index [N], J [N, r, d])`` per
    parameter group (group member i at ``offset + d i``; ``kind`` names the
    index: pose, vertex, material, light). Each block pair's
    per-observation products are summed by target block in a fixed order,
    through gather tables by index kind or pair of kinds, cached in
    ``tables`` (the indices are fixed over a solve): two groups of one kind
    meet on block diagonals (an indexed add of distinct entries), two kinds
    in a dense sub-matrix. The lower triangle is the upper one transposed,
    the same products summed in the same order. Invalid observations add
    zeros."""
    r = torch.where(valid[:, None], r, 0.0)
    blocks = [(off, n, kind, idx, torch.where(valid[:, None, None], J, 0.0))
              for off, n, kind, idx, J in blocks]
    N = r.shape[0]

    def table(key, idx, n):
        if key not in tables:
            tables[key] = dense.segment_table(idx, n)
        return tables[key]

    for a, (off_a, n_a, kind_a, idx_a, Ja) in enumerate(blocks):
        da = Ja.shape[-1]
        t_a = table(kind_a, idx_a, n_a)
        g[off_a:off_a + n_a * da] += dense.gather_sum(
            t_a, torch.einsum("nri,nr->ni", Ja, r)).reshape(-1)
        for off_b, n_b, kind_b, idx_b, Jb in blocks[a:]:
            db = Jb.shape[-1]
            prod = (Ja.transpose(1, 2) @ Jb).reshape(N, da * db)
            if kind_a == kind_b:
                blk = dense.gather_sum(t_a, prod).reshape(n_a, da, db)
                i = torch.arange(n_a, device=H.device)[:, None, None]
                rows = off_a + da * i + torch.arange(da, device=H.device)[:, None]
                cols = off_b + db * i + torch.arange(db, device=H.device)
                H[rows, cols] += blk
                if off_b != off_a:
                    H[cols.transpose(1, 2), rows.transpose(1, 2)] += blk.transpose(1, 2)
                continue
            t = table((kind_a, kind_b), idx_a * n_b + idx_b, n_a * n_b)
            blk = dense.gather_sum(t, prod).reshape(n_a, n_b, da, db)
            blk = blk.permute(0, 2, 1, 3).reshape(n_a * da, n_b * db)
            H[off_a:off_a + n_a * da, off_b:off_b + n_b * db] += blk
            H[off_b:off_b + n_b * db, off_a:off_a + n_a * da] += blk.T


def phong_normal_equations(problem: PhongBAProblem, state: PhongState, use_light: bool,
                           directional: bool, freeze_geometry: bool, tables: dict | None = None):
    """The masked dense normal equations ``(H [D, D], g [D])``. ``tables``
    caches the gather tables of the fixed observation indices across calls
    (a solve passes one dict)."""
    o = problem.obs
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    off_pt, off_n, off_ph, off_tex, off_light, D = _offsets(state)
    tables = {} if tables is None else tables
    H = state.poses.new_zeros((D, D))
    g = state.poses.new_zeros((D,))
    st, nr, it, valid = _gathered_terms(problem, state, directional)
    pose = (0, K, "pose", o.pose_idx)
    vertex = (J, "vertex", o.vertex_idx)
    r_st, Jp_st, Jpt_st = st
    _accumulate(H, g, r_st, [(*pose, Jp_st), (off_pt, *vertex, Jpt_st)], valid, tables)
    if use_light:
        r_n, Jp_n, Jn_n = nr
        _accumulate(H, g, r_n, [(*pose, Jp_n), (off_n, *vertex, Jn_n)], valid, tables)
        r_i, Jp_i, Jpt_i, Jn_i, Jph_i, Jtex_i, Jl_i = it
        material = (M, "material", o.material_idx)
        _accumulate(H, g, r_i[:, None], [
            (*pose, Jp_i[:, None, :]),
            (off_pt, *vertex, Jpt_i[:, None, :]),
            (off_n, *vertex, Jn_i[:, None, :]),
            (off_ph, *material, Jph_i[:, None, :]),
            (off_tex, *material, Jtex_i[:, None, None]),
            (off_light, 1, "light", torch.zeros_like(o.pose_idx), Jl_i[:, None, :]),
        ], valid, tables)
    free = _free_vector(problem, state, use_light, freeze_geometry)
    H = torch.where(free[:, None] & free[None, :], H, 0.0)
    H = H + torch.diag((torch.diagonal(H) == 0.0).to(H.dtype))
    return H, torch.where(free, g, 0.0)


def _free_vector(problem: PhongBAProblem, state: PhongState, use_light: bool,
                 freeze_geometry: bool) -> torch.Tensor:
    """``[D]`` bool: the tangent dimensions the stage may move."""
    M = state.phong.shape[0]
    geom = not freeze_geometry
    free_pose = (~problem.fixed_pose_mask) & geom
    free_pt = problem.vertex_valid & geom
    free_n = problem.vertex_valid & bool(use_light)
    light = torch.full((4 * M + 3,), bool(use_light), device=free_pose.device)
    return torch.cat([free_pose.repeat_interleave(6), free_pt.repeat_interleave(3),
                      free_n.repeat_interleave(3), light])


def phong_retract(problem: PhongBAProblem, state: PhongState, dx: torch.Tensor, use_light: bool,
                  directional: bool, freeze_geometry: bool) -> PhongState:
    """Apply a full-layout step: poses by the left SE(3) retraction, normals
    (and a light direction) by the unit-vector retraction, the Phong
    parameters and textures projected onto their boxes."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    off_pt, off_n, off_ph, off_tex, off_light, _ = _offsets(state)
    dx = torch.where(_free_vector(problem, state, use_light, freeze_geometry), dx, 0.0)
    poses = lie.se3_retract(state.poses, dx[:off_pt].reshape(K, 6))
    points = state.points + dx[off_pt:off_n].reshape(J, 3)
    normals = lie.unit_vector_retract(state.normals, dx[off_n:off_ph].reshape(J, 3))
    phong = state.phong + dx[off_ph:off_tex].reshape(M, 3)
    phong = torch.stack([phong[:, 0].clamp(0.0, 1.0), phong[:, 1].clamp(0.0, 1.0),
                         phong[:, 2].clamp(min=1.0)], dim=-1)
    textures = (state.textures + dx[off_tex:off_light]).clamp(0.0, 1.0)
    d_l = dx[off_light:]
    light = lie.unit_vector_retract(state.light, d_l) if directional else state.light + d_l
    return PhongState(poses, points, normals, phong, textures, light)


def solve_phong_ba(problem: PhongBAProblem, state0: PhongState,
                   config: lm.SolveConfig = lm.SolveConfig(), use_light: bool = True,
                   directional: bool = False, freeze_geometry: bool = False,
                   linear_solver: str = "dense", layout=None):
    """One LM solve of the Phong BA problem at the given stage flags.
    ``linear_solver``: ``dense`` (the ``[D, D]`` Cholesky, window scale) or
    ``schur`` (vertex-block elimination, ``solver/phong_schur.py``; pass
    ``layout`` from ``phong_schur.build_phong_layout``, else it is built
    here). Returns ``(state, SolveSummary)``."""
    if linear_solver == "schur":
        from ceres_slam_tpu_torch.solver import phong_schur

        step = phong_schur.phong_schur_step(problem, use_light, directional, freeze_geometry,
                                            layout=layout)
    elif linear_solver == "dense":
        tables = {}
        step = lm.dense_cholesky_step(lambda s: phong_normal_equations(
            problem, s, use_light, directional, freeze_geometry, tables))
    else:
        raise ValueError(f"unknown linear solver: {linear_solver!r}")
    return lm.lm_solve(state0, config, lambda s: phong_cost(problem, s, use_light, directional),
                       step, lambda s, dx: phong_retract(problem, s, dx, use_light, directional,
                                                         freeze_geometry))


def auto_linear_solver(state: PhongState) -> str:
    """The dense ``[D, D]`` factorization at window scale; the vertex-Schur
    reduction past ~1k dof (its big cost scales with ``6K + 4M + 3``)."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    return "schur" if 6 * K + 6 * J + 4 * M + 3 > 1024 else "dense"


def solve_phong_staged(problem: PhongBAProblem, state: PhongState,
                       config: lm.SolveConfig = lm.SolveConfig(), use_light: bool = True,
                       directional: bool = False, multistage: bool = False,
                       linear_solver: str = "auto"):
    """The reference's schedule: with ``multistage``, stage 1 (geometry
    only) and stage 2 (lighting only, geometry frozen), then the joint
    solve. Returns ``(state, [SolveSummary per stage])``."""
    if linear_solver == "auto":
        linear_solver = auto_linear_solver(state)
    layout = None
    if linear_solver == "schur":
        from ceres_slam_tpu_torch.solver import phong_schur

        layout = phong_schur.build_phong_layout(problem)
    kw = dict(directional=directional, linear_solver=linear_solver, layout=layout)
    summaries = []
    if multistage:
        state, s1 = solve_phong_ba(problem, state, config, use_light=False, **kw)
        summaries.append(s1)
        if use_light:
            state, s2 = solve_phong_ba(problem, state, config, use_light=True,
                                       freeze_geometry=True, **kw)
            summaries.append(s2)
    state, s3 = solve_phong_ba(problem, state, config, use_light=use_light, **kw)
    summaries.append(s3)
    return state, summaries
