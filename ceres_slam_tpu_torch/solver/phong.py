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
their target block (``dense.gather_sum`` through tables built on the host
before the solve, ``build_tables``: a gather and a sum over a fixed axis,
so the card gives the same bits every run); ``solver/phong_schur.py`` is
the vertex-Schur solver for full batches. Masks are ``torch.where``.

The LM loop (JAX's ``lax.while_loop``, ``ceres_slam_tpu/solver/lm.py:182``)
runs on the card by default there: ``solve_phong_ba(lm_loop="device")``
captures one LM iteration (the factor pass, the step, the retraction, the
trial cost, the control) and runs it in a conditional WHILE node
(``lm.device_loop``), one graph launch a stage. Nothing in that body reads
the device from the host: the free vector and the gather tables are built
once per solve, before the loop, and ``phong_loop_inputs`` lists every
tensor it reads, which a later solve of the same shape copies into the
captured ones (``lm.LMGraph``). ``lm_loop="host"`` (the CPU's form)
iterates the same body on the host: the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors, graph_loop, lie
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.window import gather_table
from ceres_slam_tpu_torch.utils import telemetry


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


# the gather tables of a solve: the dense path's by index kind and by each
# pair of kinds that meet in a factor (the intensity factor's blocks, in
# their order); the vertex-Schur layout's by vertex, pose and (vertex, pose)
KINDS = ("pose", "vertex", "material", "light")
PAIRS = (("pose", "vertex"), ("pose", "material"), ("pose", "light"),
         ("vertex", "material"), ("vertex", "light"), ("material", "light"))
SCHUR_KEYS = ("vertex", "pose", ("vertex", "pose"))
ALL_KEYS = KINDS + PAIRS + SCHUR_KEYS[2:]


def table_ids(pose_idx: np.ndarray, vertex_idx: np.ndarray, material_idx: np.ndarray,
              valid: np.ndarray, K: int, J: int, M: int | None,
              keys=ALL_KEYS) -> dict:
    """Host-side: the bins of the gather tables ``keys``, ``key -> (ids
    [N], bins)``, an invalid observation's id -1 (in no bin): by a kind
    (the light is one bin), or by a pair of kinds ``(a, b)``, bin ``ia nb
    + ib``. ``M``, the material count, is needed by the material keys."""
    base = {"pose": (pose_idx, K), "vertex": (vertex_idx, J), "material": (material_idx, M),
            "light": (np.zeros_like(pose_idx), 1)}

    def bins(key):
        if isinstance(key, str):
            return base[key]
        (ia, na), (ib, nb) = base[key[0]], base[key[1]]
        return ia * nb + ib, na * nb

    return {k: (np.where(valid, i, -1), n) for k in keys for i, n in [bins(k)]}


def table_widths(ids: dict) -> dict:
    """The width each table of ``table_ids`` needs: its largest bin (at
    least 1). A pass takes the largest over its windows, so that every
    window's tables have one shape, and its LM loops one capture."""
    return {k: max(1, int(np.bincount(i[i >= 0], minlength=n).max(initial=0)))
            for k, (i, n) in ids.items()}


def build_tables(problem: PhongBAProblem, M: int | None, keys=KINDS + PAIRS,
                 widths: dict | None = None) -> dict:
    """The gather tables ``keys`` of the problem's valid observations, on
    its device (``window.gather_table``: row b lists bin b's observations
    in increasing order, padded with ``N``, the index of the zero row a sum
    appends), each ``widths[key]`` wide where given (a pass's), else as
    wide as its largest bin. A host round trip: a solve builds them before
    its loop, and under a capture this raises."""
    graph_loop.not_in_capture("building the Phong gather tables", "solve_phong_ba")
    o = problem.obs
    K, J = problem.fixed_pose_mask.shape[0], problem.vertex_valid.shape[0]
    ids = table_ids(o.pose_idx.cpu().numpy(), o.vertex_idx.cpu().numpy(),
                    o.material_idx.cpu().numpy(), obs_valid(problem).cpu().numpy(), K, J, M,
                    keys)
    return {k: telemetry.to_device(gather_table(i, n, None if widths is None else widths[k]),
                                   o.uvd.device) for k, (i, n) in ids.items()}


def _accumulate(H, g, r, blocks, valid, tables: dict):
    """Add one factor batch's normal equations to ``(H, g)`` in place.
    ``blocks`` lists ``(offset, count, kind, J [N, r, d])`` per parameter
    group (group member i at ``offset + d i``; ``kind`` names its index:
    pose, vertex, material, light). Each block pair's
    per-observation products are summed by target block in a fixed order,
    through ``tables`` (``build_tables``) by index kind or pair of kinds:
    two groups of one kind meet on block diagonals (an indexed write of
    distinct entries), two kinds in a dense sub-matrix. The lower triangle
    is the upper one transposed, the same products summed in the same
    order. Invalid observations are in no table."""
    r = torch.where(valid[:, None], r, 0.0)
    blocks = [(off, n, kind, torch.where(valid[:, None, None], J, 0.0))
              for off, n, kind, J in blocks]
    N = r.shape[0]
    for a, (off_a, n_a, kind_a, Ja) in enumerate(blocks):
        da = Ja.shape[-1]
        t_a = tables[kind_a]
        g[off_a:off_a + n_a * da] += dense.gather_sum(
            t_a, torch.einsum("nri,nr->ni", Ja, r)).reshape(-1)
        for off_b, n_b, kind_b, Jb in blocks[a:]:
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
            blk = dense.gather_sum(tables[(kind_a, kind_b)], prod).reshape(n_a, n_b, da, db)
            blk = blk.permute(0, 2, 1, 3).reshape(n_a * da, n_b * db)
            H[off_a:off_a + n_a * da, off_b:off_b + n_b * db] += blk
            H[off_b:off_b + n_b * db, off_a:off_a + n_a * da] += blk.T


def phong_normal_equations(problem: PhongBAProblem, state: PhongState, use_light: bool,
                           directional: bool, freeze_geometry: bool, tables: dict | None = None,
                           free: torch.Tensor | None = None):
    """The masked dense normal equations ``(H [D, D], g [D])``. ``tables``:
    ``build_tables``' (built here where not given); ``free``: the stage's
    ``free_vector`` (likewise)."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    off_pt, off_n, off_ph, off_tex, off_light, D = _offsets(state)
    tables = build_tables(problem, M) if tables is None else tables
    free = free_vector(problem, state, use_light, freeze_geometry) if free is None else free
    H = state.poses.new_zeros((D, D))
    g = state.poses.new_zeros((D,))
    st, nr, it, valid = _gathered_terms(problem, state, directional)
    pose = (0, K, "pose")
    vertex = (J, "vertex")
    r_st, Jp_st, Jpt_st = st
    _accumulate(H, g, r_st, [(*pose, Jp_st), (off_pt, *vertex, Jpt_st)], valid, tables)
    if use_light:
        r_n, Jp_n, Jn_n = nr
        _accumulate(H, g, r_n, [(*pose, Jp_n), (off_n, *vertex, Jn_n)], valid, tables)
        r_i, Jp_i, Jpt_i, Jn_i, Jph_i, Jtex_i, Jl_i = it
        material = (M, "material")
        _accumulate(H, g, r_i[:, None], [
            (*pose, Jp_i[:, None, :]),
            (off_pt, *vertex, Jpt_i[:, None, :]),
            (off_n, *vertex, Jn_i[:, None, :]),
            (off_ph, *material, Jph_i[:, None, :]),
            (off_tex, *material, Jtex_i[:, None, None]),
            (off_light, 1, "light", Jl_i[:, None, :]),
        ], valid, tables)
    H = torch.where(free[:, None] & free[None, :], H, 0.0)
    H = H + torch.diag((torch.diagonal(H) == 0.0).to(H.dtype))
    return H, torch.where(free, g, 0.0)


def free_vector(problem: PhongBAProblem, state: PhongState, use_light: bool,
                freeze_geometry: bool) -> torch.Tensor:
    """``[D]`` bool: the tangent dimensions the stage may move. It depends
    on the problem and the stage alone: a solve builds it once, before its
    loop."""
    M = state.phong.shape[0]
    geom = not freeze_geometry
    free_pose = (~problem.fixed_pose_mask) & geom
    free_pt = problem.vertex_valid & geom
    free_n = problem.vertex_valid & bool(use_light)
    light = torch.full((4 * M + 3,), bool(use_light), device=free_pose.device)
    return torch.cat([free_pose.repeat_interleave(6), free_pt.repeat_interleave(3),
                      free_n.repeat_interleave(3), light])


def phong_retract(problem: PhongBAProblem, state: PhongState, dx: torch.Tensor, use_light: bool,
                  directional: bool, freeze_geometry: bool,
                  free: torch.Tensor | None = None) -> PhongState:
    """Apply a full-layout step: poses by the left SE(3) retraction, normals
    (and a light direction) by the unit-vector retraction, the Phong
    parameters and textures projected onto their boxes. ``free``: the
    stage's ``free_vector`` (built here where not given)."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    off_pt, off_n, off_ph, off_tex, off_light, _ = _offsets(state)
    free = free_vector(problem, state, use_light, freeze_geometry) if free is None else free
    dx = torch.where(free, dx, 0.0)
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


resolve_lm_loop = lm.resolve_loop


def solve_tables(problem: PhongBAProblem, state: PhongState, linear_solver: str,
                 widths: dict | None = None):
    """What a solve's body sums through, built on the host before its loop:
    the vertex-Schur layout (``phong_schur.build_phong_layout``) or the
    dense path's tables (``build_tables``), ``widths`` wide where given."""
    with telemetry.span("phong.tables"):
        if linear_solver == "schur":
            from ceres_slam_tpu_torch.solver import phong_schur

            return phong_schur.build_phong_layout(problem, widths)
        if linear_solver == "dense":
            return build_tables(problem, state.phong.shape[0], widths=widths)
    raise ValueError(f"unknown linear solver: {linear_solver!r}")


def phong_functions(problem: PhongBAProblem, tables, free: torch.Tensor, use_light: bool,
                    directional: bool, freeze_geometry: bool, linear_solver: str):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of one stage, over
    the solve's ``tables`` (``solve_tables``) and ``free`` vector: none of
    them reads the device from the host, so the device loop can capture
    them."""
    if linear_solver == "schur":
        from ceres_slam_tpu_torch.solver import phong_schur

        step = phong_schur.phong_schur_step(problem, use_light, directional, freeze_geometry,
                                            layout=tables, free=free)
    elif linear_solver == "dense":
        step = lm.dense_cholesky_step(lambda s: phong_normal_equations(
            problem, s, use_light, directional, freeze_geometry, tables, free))
    else:
        raise ValueError(f"unknown linear solver: {linear_solver!r}")

    def cost(s):
        return phong_cost(problem, s, use_light, directional)

    def retract(s, dx):
        return phong_retract(problem, s, dx, use_light, directional, freeze_geometry, free)

    return cost, step, retract


def phong_loop_inputs(problem: PhongBAProblem, state0: PhongState, free: torch.Tensor,
                      tables) -> tuple:
    """Every tensor the LM loop of ``solve_phong_ba`` reads that can differ
    between two solves of one shape: the observations, the stiffnesses,
    the gauge and vertex masks, the stage's free vector, the gather tables
    (the dense path's or the vertex-Schur layout's) and the initial state.
    A later solve of an ``lm.LMGraph`` copies them into the captured ones."""
    tabs = tuple(tables.values()) if isinstance(tables, dict) else lm.leaves(tables)
    return (*lm.leaves(problem.obs), problem.stereo_stiffness, problem.normal_stiffness,
            problem.int_stiffness, problem.fixed_pose_mask, problem.vertex_valid, free, *tabs,
            *lm.leaves(state0))


def _phong_key(problem: PhongBAProblem, use_light: bool, directional: bool,
               freeze_geometry: bool, linear_solver: str) -> tuple:
    """What the device LM loop's body holds as Python values (beside the
    inputs' shapes): the stage flags, the light model, the linear solver
    and the camera's floats."""
    return (use_light, directional, freeze_geometry, linear_solver, tuple(problem.camera))


def solve_phong_ba(problem: PhongBAProblem, state0: PhongState,
                   config: lm.SolveConfig = lm.SolveConfig(), use_light: bool = True,
                   directional: bool = False, freeze_geometry: bool = False,
                   linear_solver: str = "dense", layout=None, tables: dict | None = None,
                   lm_loop: str | None = None, graph: lm.LMGraph | None = None):
    """One LM solve of the Phong BA problem at the given stage flags.
    ``linear_solver``: ``dense`` (the ``[D, D]`` Cholesky, window scale;
    ``tables`` from ``build_tables``) or ``schur`` (vertex-block
    elimination, ``solver/phong_schur.py``; ``layout`` from
    ``phong_schur.build_phong_layout``); what is not given is built here,
    before the loop. ``lm_loop``: ``"device"`` (the default on CUDA) runs
    the loop as one WHILE node on the card (``lm.device_loop``), kept in
    ``graph`` (an ``lm.LMGraph``) for the next solve of the same shape and
    stage, which copies its ``phong_loop_inputs`` into this one's tensors
    (they are overwritten) and restarts it; ``"host"`` (the default
    elsewhere) iterates on the host and takes no ``graph``. Both give the
    same bits. Returns ``(state, SolveSummary)``."""
    lm_loop = resolve_lm_loop(state0.poses.device, lm_loop)
    given = layout if linear_solver == "schur" else tables
    tables = given if given is not None else solve_tables(problem, state0, linear_solver)
    if lm_loop == "host" and graph is not None:
        raise ValueError("an LMGraph keeps the device LM loop: lm_loop='host' takes none")
    if lm_loop == "device":
        state0 = lm.tree_map(torch.clone, state0)  # the loop's own: a restart copies into it
    free = free_vector(problem, state0, use_light, freeze_geometry)
    fns = phong_functions(problem, tables, free, use_light, directional, freeze_geometry,
                          linear_solver)
    if lm_loop == "device":
        return lm.lm_solve(state0, config, *fns, loop="device", graph=graph,
                           inputs=phong_loop_inputs(problem, state0, free, tables),
                           key=_phong_key(problem, use_light, directional, freeze_geometry,
                                          linear_solver))
    return lm.lm_solve(state0, config, *fns, loop="host")


def auto_linear_solver(state: PhongState) -> str:
    """The dense ``[D, D]`` factorization at window scale; the vertex-Schur
    reduction past ~1k dof (its big cost scales with ``6K + 4M + 3``)."""
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    return "schur" if 6 * K + 6 * J + 4 * M + 3 > 1024 else "dense"


def solve_phong_staged(problem: PhongBAProblem, state: PhongState,
                       config: lm.SolveConfig = lm.SolveConfig(), use_light: bool = True,
                       directional: bool = False, multistage: bool = False,
                       linear_solver: str = "auto", lm_loop: str | None = None,
                       graph: lm.LMGraph | None = None, widths: dict | None = None):
    """The reference's schedule: with ``multistage``, stage 1 (geometry
    only) and stage 2 (lighting only, geometry frozen), then the joint
    solve. The gather tables are built once, ``widths`` wide where given
    (a pass's ``table_widths``). ``lm_loop``: ``solve_phong_ba``'s; with
    the device loop every stage is one WHILE node, kept in ``graph`` (one
    capture per stage, at most three; a graph of this call's own when none
    is given, closed at its end). Each stage is a span ``phong.stage``, the
    first holding the tables' build. Returns ``(state, [SolveSummary per
    stage])``."""
    if linear_solver == "auto":
        linear_solver = auto_linear_solver(state)
    lm_loop = resolve_lm_loop(state.poses.device, lm_loop)
    # (use_light, freeze_geometry) of each stage
    stages = ([(False, False)] + ([(True, True)] if use_light else [])) if multistage else []
    stages.append((use_light, False))
    own = lm_loop == "device" and graph is None
    graph = lm.LMGraph() if own else graph
    kw = dict(directional=directional, linear_solver=linear_solver, lm_loop=lm_loop, graph=graph)
    summaries = []
    try:
        for i, (light, frozen) in enumerate(stages):
            with telemetry.span("phong.stage", stage=i, use_light=light, freeze_geometry=frozen):
                if i == 0:
                    tables = solve_tables(problem, state, linear_solver, widths)
                    kw["layout" if linear_solver == "schur" else "tables"] = tables
                state, s = solve_phong_ba(problem, state, config, use_light=light,
                                          freeze_geometry=frozen, **kw)
            summaries.append(s)
    finally:
        if own:
            graph.close()
    return state, summaries
