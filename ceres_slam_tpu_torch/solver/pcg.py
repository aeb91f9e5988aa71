"""Matrix-free Schur-complement PCG for full-batch bundle adjustment.

Port of ``ceres_slam_tpu/solver/pcg.py``. Each observation is one
(pose, landmark) pair, so the coupling block of that pair IS the
per-observation product ``U_n = J_pose(n)^T J_pt(n)``, and every product
with the reduced camera matrix

    S v = (B + lam D_B) v - U C^{-1} U^T v

is a pass over the observations with sums into the small pose and
landmark index spaces; ``W`` is never formed. The damped step is solved by
preconditioned conjugate gradients, the preconditioner being the exact
block-Jacobi of S (``schur_diag_blocks``) or the banded cyclic-reduction
factorization of ``solver/banded.py``.

Two kernels carry the path on CUDA: K2 (``ops/stereo_factor_kernel``)
evaluates every observation's factor blocks and sums them by pose and by
landmark once per LM iteration, and K3 (``ops/schur_kernel``) computes the
coupling half ``U C^{-1} U^T v`` of every CG matvec. Both read the
full-batch plan (``ops/full_batch_plan.FullBatchPlan``: the observations
grouped by landmark and by pose, the static masks, K2's records and the
kernels' scratch), which ``solve_ba_pcg`` builds once per problem on CUDA
(``build_obs_blocks`` builds one where none is given: on the card K2 and
K3 always run), beside the gather tables (``ObsTables``) that the
remaining reductions (the right-hand side, the back-substitution, the
block-Jacobi blocks) read:
every reduction by pose or by landmark is then deterministic run to run,
with no ``index_add_`` atomics. ``build_obs_blocks`` binds this LM
iteration's ``U18`` and ``Cinv`` to the plan for K3 once (``ObsBlocks.uy``).
Without a plan or tables (the CPU default, as in the JAX package off the
TPU) the reductions are ``index_add_`` segment sums; on the CPU the
kernels' wrappers run their plain versions.

The CG loop runs on the host: its stop test ``|r| > tol |rhs|`` is read
every iteration, so the iterate count equals the JAX ``while_loop``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import full_batch_plan, lie, schur_kernel, stereo_factor_kernel
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.window import _damp, _inv3x3, _pin


class ObsBlocks(NamedTuple):
    """Per-observation Gauss-Newton quantities and the small diagonal systems."""

    U18: torch.Tensor  # [N, 18] component-flat coupling, U18[n, 3a + c] = U_n[a, c]
    Hpp: torch.Tensor  # [K, 6, 6] damped pose diagonal (masked, pinned)
    Cinv: torch.Tensor  # [J, 3, 3] damped, inverted landmark diagonal
    gp: torch.Tensor  # [K, 6]
    gl: torch.Tensor  # [J, 3]
    Hll: torch.Tensor  # [J, 3, 3] undamped, pinned (for the predicted decrease)
    Hpp_undamped: torch.Tensor  # [K, 6, 6]
    pose_idx: torch.Tensor  # [N]
    point_idx: torch.Tensor  # [N]
    uy: schur_kernel.UyBinding | None = None  # K3's binding of U18 and Cinv (with a plan)


class ObsTables(NamedTuple):
    """Static gather tables: the observations grouped by landmark and by pose.

    Row j of ``by_point`` lists landmark j's observations, padded with
    observation 0 at weight 0 (likewise ``by_pose``); ``by_point_pose`` and
    ``by_pose_point`` hold each slot's pose and landmark, which the gather
    matvec reads in place of a second indirection. Built once per problem
    structure on the host. The reductions outside the kernels and the
    JAX-parity tests read them; K2 and K3 read the ``FullBatchPlan``."""

    by_point: torch.Tensor  # [J, O_l] int32 observation ids
    by_point_w: torch.Tensor  # [J, O_l] float32 1/0 slot weights
    by_pose: torch.Tensor  # [K, O_p] int32
    by_pose_w: torch.Tensor  # [K, O_p] float32
    by_point_pose: torch.Tensor  # [J, O_l] int32 pose of each slot
    by_pose_point: torch.Tensor  # [K, O_p] int32 landmark of each slot


def build_obs_tables(pose_idx, point_idx, K: int, J: int, device="cpu") -> ObsTables:
    """Host-side construction of the gather tables (numpy, once per structure)."""
    pose_idx = np.asarray(pose_idx, np.int64)
    point_idx = np.asarray(point_idx, np.int64)

    def group(ids, n):
        order = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=n)
        O = max(1, int(counts.max()))
        sorted_ids = ids[order]
        rank = np.arange(ids.size) - np.concatenate([[0], np.cumsum(counts)])[sorted_ids]
        table = np.zeros((n, O), np.int32)
        w = np.zeros((n, O), np.float32)
        table[sorted_ids, rank] = order
        w[sorted_ids, rank] = 1.0
        return table, w

    bp, bpw = group(point_idx, J)
    bk, bkw = group(pose_idx, K)

    def put(x):
        return torch.as_tensor(x).to(device)

    return ObsTables(by_point=put(bp), by_point_w=put(bpw), by_pose=put(bk), by_pose_w=put(bkw),
                     by_point_pose=put(pose_idx[bp].astype(np.int32)),
                     by_pose_point=put(point_idx[bk].astype(np.int32)))


def _gather_sum(table, w, per_obs):
    """Sum a per-observation array into bins through a gather table
    (deterministic segment sum); trailing dims are flattened for the gather."""
    flat = per_obs.reshape(per_obs.shape[0], -1)
    out = torch.einsum("gof,go->gf", flat[table.long()], w.to(per_obs.dtype))
    return out.reshape((table.shape[0],) + per_obs.shape[1:])


def _gather_sum_by_point(t: ObsTables, per_obs: torch.Tensor) -> torch.Tensor:
    return _gather_sum(t.by_point, t.by_point_w, per_obs)


def _gather_sum_by_pose(t: ObsTables, per_obs: torch.Tensor) -> torch.Tensor:
    return _gather_sum(t.by_pose, t.by_pose_w, per_obs)


def _sum_by_pose(b: ObsBlocks, tables, per_obs):
    if tables is not None:
        return _gather_sum_by_pose(tables, per_obs)
    return dense.segment_sum(per_obs, b.pose_idx, b.Hpp.shape[0])


def _sum_by_point(b: ObsBlocks, tables, per_obs):
    if tables is not None:
        return _gather_sum_by_point(tables, per_obs)
    return dense.segment_sum(per_obs, b.point_idx, b.Cinv.shape[0])


def u18_t_vec(U18, v6):
    """Per-observation ``U_n^T v_n``: ``[N, 18], [N, 6] -> [N, 3]``."""
    return torch.einsum("nac,na->nc", U18.reshape(-1, 6, 3), v6)


def u18_vec(U18, y3):
    """Per-observation ``U_n y_n``: ``[N, 18], [N, 3] -> [N, 6]``."""
    return lie._mv(U18.reshape(-1, 6, 3), y3)


def build_obs_blocks(problem: dense.StereoBAProblem, state: dense.BAState, lam: float,
                     tables: ObsTables | None = None,
                     plan: full_batch_plan.FullBatchPlan | None = None) -> ObsBlocks:
    """Per-observation factor blocks and the binned Gauss-Newton diagonals:
    with a plan, K2's sums (and K3 bound to the result); else, on the CPU,
    the factor blocks summed through the gather tables or by ``index_add_``.
    On CUDA K2 always runs: without a plan, one is built here (a host round
    trip of the observation tables; ``solve_ba_pcg`` builds it once)."""
    if plan is None and state.poses.device.type == "cuda":
        plan = full_batch_plan.plan_for_problem(problem)
    if plan is not None:
        return _blocks_from_plan(problem, state, lam, plan)
    p, st = problem, problem.stereo
    K, J = state.poses.shape[0], state.points.shape[0]
    dtype = state.poses.dtype
    valid = dense.stereo_valid(p)
    # Invalid rows must contribute exact zeros, but their landmark can be
    # garbage: an uninitialized point at the origin seen from a pose at the
    # origin has z = 0. Evaluate invalid rows against a point 10 m ahead of
    # their camera instead, so that they stay finite.
    T_obs = state.poses[st.pose_idx]
    p_obs = state.points[st.point_idx]
    ahead = torch.tensor([0.0, 0.0, 10.0], dtype=dtype, device=p_obs.device)
    safe_pt = lie.se3_transform_point(lie.se3_inverse(T_obs), ahead.expand_as(p_obs))
    p_obs = torch.where(valid[:, None], p_obs, safe_pt)
    _, hpp36, hll9, U18, gp6, gl3 = stereo_factor_kernel.stereo_factor_blocks_plain(
        p.camera, T_obs, p_obs, st.uvd, st.stiffness, valid)
    if tables is not None:
        Hpp = _gather_sum_by_pose(tables, hpp36).reshape(K, 6, 6)
        gp = _gather_sum_by_pose(tables, gp6)
        Hll = _gather_sum_by_point(tables, hll9).reshape(J, 3, 3)
        gl = _gather_sum_by_point(tables, gl3)
    else:
        Hpp = dense.segment_sum(hpp36, st.pose_idx, K).reshape(K, 6, 6)
        gp = dense.segment_sum(gp6, st.pose_idx, K)
        Hll = dense.segment_sum(hll9, st.point_idx, J).reshape(J, 3, 3)
        gl = dense.segment_sum(gl3, st.point_idx, J)

    # sun + prior touch only pose blocks
    Hpp_aux, gp_aux = dense.aux_pose_blocks(problem, state)
    # gauge / validity masks at block level
    free_pose = (~p.fixed_pose_mask).to(dtype)
    free_pt = p.point_valid.to(dtype)
    Hpp = (Hpp + Hpp_aux) * free_pose[:, None, None]
    gp = (gp + gp_aux) * free_pose[:, None]
    Hll = Hll * free_pt[:, None, None]
    gl = gl * free_pt[:, None]
    U18 = U18 * (free_pose[st.pose_idx] * free_pt[st.point_idx])[:, None]
    return _finish(U18, Hpp, gp, Hll, gl, lam, st)


def _blocks_from_plan(problem, state, lam, plan):
    """K2's sums come masked; the sun and prior blocks are added under the
    gauge mask, then pinned and damped as on the other paths."""
    K, J = plan.K, plan.J
    U18, hpp36, gp, hll9, gl = stereo_factor_kernel.stereo_factor_sums(plan, state.poses,
                                                                       state.points)
    Hpp_aux, gp_aux = dense.aux_pose_blocks(problem, state)
    zero = Hpp_aux.new_zeros(())
    free = plan.free_pose
    Hpp = hpp36.view(K, 6, 6) + torch.where(free[:, None, None], Hpp_aux, zero)
    gp = gp + torch.where(free[:, None], gp_aux, zero)
    b = _finish(U18, Hpp, gp, hll9.view(J, 3, 3), gl, lam, problem.stereo)
    return b._replace(uy=schur_kernel.bind(plan, b.U18, b.Cinv))


def _finish(U18, Hpp, gp, Hll, gl, lam, st) -> ObsBlocks:
    Hpp = _pin(Hpp)
    Hll_pinned = _pin(Hll)
    return ObsBlocks(U18=U18, Hpp=_damp(Hpp, lam), Cinv=_inv3x3(_damp(Hll_pinned, lam)), gp=gp,
                     gl=gl, Hll=Hll_pinned, Hpp_undamped=Hpp, pose_idx=st.pose_idx,
                     point_idx=st.point_idx)


def schur_matvec(b: ObsBlocks, v: torch.Tensor) -> torch.Tensor:
    """``S v`` for ``v [K, 6]`` with ``index_add_`` segment sums."""
    K, J = b.Hpp.shape[0], b.Cinv.shape[0]
    Utv = dense.segment_sum(u18_t_vec(b.U18, v[b.pose_idx]), b.point_idx, J)
    y = lie._mv(b.Cinv, Utv)
    Uy = dense.segment_sum(u18_vec(b.U18, y[b.point_idx]), b.pose_idx, K)
    return lie._mv(b.Hpp, v) - Uy


def _uy_gather(b: ObsBlocks, t: ObsTables, v: torch.Tensor) -> torch.Tensor:
    """``U C^{-1} U^T v`` through the gather tables (the JAX gather matvec's
    coupling half)."""
    J, O_l = t.by_point.shape
    K, O_p = t.by_pose.shape
    dtype = b.U18.dtype
    U_l = (b.U18[t.by_point.long()] * t.by_point_w.to(dtype)[..., None]).reshape(J, O_l, 6, 3)
    y = lie._mv(b.Cinv, torch.einsum("joac,joa->jc", U_l, v[t.by_point_pose.long()]))
    U_p = (b.U18[t.by_pose.long()] * t.by_pose_w.to(dtype)[..., None]).reshape(K, O_p, 6, 3)
    return torch.einsum("koac,koc->ka", U_p, y[t.by_pose_point.long()])


def schur_matvec_gather(b: ObsBlocks, t: ObsTables, v: torch.Tensor) -> torch.Tensor:
    """``S v`` through the gather tables."""
    return lie._mv(b.Hpp, v) - _uy_gather(b, t, v)


def schur_matvec_plan(b: ObsBlocks, v: torch.Tensor) -> torch.Tensor:
    """``S v`` with the coupling half by K3 (``b.uy``, bound by
    ``build_obs_blocks`` with a plan; the kernel on CUDA, its plain version
    on the CPU)."""
    return lie._mv(b.Hpp, v) - schur_kernel.schur_uy(b.uy, v)


def whitened_u18(b: ObsBlocks) -> torch.Tensor:
    """``UL = U chol(C^{-1})`` per observation, component-flat ``[N, 18]``,
    so that ``U C^{-1} U^T = UL UL^T``."""
    Lc = lm._cholesky_or_nan(b.Cinv)
    return (b.U18.reshape(-1, 6, 3) @ Lc[b.point_idx]).reshape(-1, 18)


def schur_diag_blocks(b: ObsBlocks, tables: ObsTables | None = None) -> torch.Tensor:
    """Exact diagonal blocks ``S_kk = Hpp_k - sum_{n in k} U_n C^{-1} U_n^T``
    (cross terms of distinct observations never reach a diagonal block)."""
    UL = whitened_u18(b).reshape(-1, 6, 3)
    UCU = _sum_by_pose(b, tables, (UL @ UL.transpose(1, 2)).reshape(-1, 36))
    return b.Hpp - UCU.reshape(-1, 6, 6)


def _block_precond(S_diag: torch.Tensor):
    """Cholesky-based inverse application of the ``[K, 6, 6]`` diagonal blocks."""
    chol = lm._cholesky_or_nan(S_diag)

    def apply(r: torch.Tensor) -> torch.Tensor:  # [K, 6]
        return torch.cholesky_solve(r[..., None], chol)[..., 0]

    return apply


def pcg_solve(b: ObsBlocks, rhs: torch.Tensor, max_iters: int, tol: float,
              tables: ObsTables | None = None, precond=None):
    """Preconditioned CG on the reduced camera system; returns ``(x,
    iterations)``. The default preconditioner is the exact block-Jacobi;
    ``precond`` (a callable ``r -> M^{-1} r``, e.g.
    ``banded.make_banded_precond``) overrides it. Whatever the
    preconditioner, the matvec is ``Hpp v - K3(v)`` when ``b`` carries K3's
    binding (always on CUDA: ``b`` must come from ``build_obs_blocks``),
    else the gather matvec with ``tables``, else segment sums."""
    if b.uy is None and b.U18.device.type == "cuda":
        raise ValueError("on CUDA the matvec runs K3: take the blocks from build_obs_blocks, "
                         "which binds them to the full-batch plan")
    if precond is None:
        precond = _block_precond(schur_diag_blocks(b, tables))

    def matvec(v):
        if b.uy is not None:
            return schur_matvec_plan(b, v)
        if tables is not None:
            return schur_matvec_gather(b, tables, v)
        return schur_matvec(b, v)

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    pv = z
    rz = torch.sum(r * z)
    bound = tol * torch.sqrt(torch.sum(rhs * rhs))
    it = 0
    while it < max_iters and bool(torch.sqrt(torch.sum(r * r)) > bound):
        Sp = matvec(pv)
        denom = torch.sum(pv * Sp)
        alpha = rz / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        x = x + alpha * pv
        r = r - alpha * Sp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz == 0.0, torch.ones_like(rz), rz)
        pv = z + beta * pv
        rz = rz_new
        it += 1
    return x, it


def pcg_step(problem, state, lam: float, max_cg_iters: int = 100, cg_tol: float = 1e-6,
             tables: ObsTables | None = None, tracks=None,
             plan: full_batch_plan.FullBatchPlan | None = None):
    """One damped LM linear solve via Schur + PCG. Returns ``(dx, grad_norm,
    pred_decrease, cg_iterations)``; the first three are the LM core's
    step contract. With ``tracks`` (a ``banded.TrackInfo``) the
    preconditioner is the banded cyclic-reduction factorization; with
    ``plan``, and always on CUDA, K2 and K3 carry the assembly and the
    matvecs (``build_obs_blocks`` builds the plan where none is given)."""
    b = build_obs_blocks(problem, state, lam, tables=tables, plan=plan)
    precond = None
    if tracks is not None:
        from ceres_slam_tpu_torch.solver import banded

        precond = banded.make_banded_precond(b, tracks, b.Hpp.shape[0])

    # rhs = -(gp - U C^{-1} gl)
    y = lie._mv(b.Cinv, b.gl)
    rhs = -(b.gp - _sum_by_pose(b, tables, u18_vec(b.U18, y[b.point_idx])))
    dp, iters = pcg_solve(b, rhs, max_cg_iters, cg_tol, tables=tables, precond=precond)

    # back-substitute landmarks: dl = -C^{-1}(gl + U^T dp)
    Utdp = _sum_by_point(b, tables, u18_t_vec(b.U18, dp[b.pose_idx]))
    dl = -lie._mv(b.Cinv, b.gl + Utdp)
    dx = torch.cat([dp.reshape(-1), dl.reshape(-1)])
    grad_norm = torch.maximum(b.gp.abs().max(), b.gl.abs().max())
    # predicted decrease with the undamped blocks
    Udl = _sum_by_pose(b, tables, u18_vec(b.U18, dl[b.point_idx]))
    g_dot_dx = torch.sum(b.gp * dp) + torch.sum(b.gl * dl)
    dxHdx = (torch.einsum("ka,kab,kb->", dp, b.Hpp_undamped, dp) + 2.0 * torch.sum(dp * Udl)
             + torch.einsum("ja,jab,jb->", dl, b.Hll, dl))
    return dx, grad_norm, -(g_dot_dx + 0.5 * dxHdx), iters


def solve_ba_pcg(problem: dense.StereoBAProblem, state0: dense.BAState,
                 config: lm.SolveConfig = lm.SolveConfig(), max_cg_iters: int = 100,
                 cg_tol: float = 1e-6, tables: ObsTables | None = None, precond: str = "auto",
                 plan: full_batch_plan.FullBatchPlan | None = None):
    """LM with the matrix-free Schur-PCG linear solver (the role of Ceres'
    ITERATIVE_SCHUR). Returns ``(state, SolveSummary)`` with the CG
    iterations of the whole solve in ``linear_iterations``.

    On CUDA the full-batch plan and the gather tables are built here
    whenever none are given, so K2 runs every LM iteration and K3 every
    matvec; on the CPU they are used only if given.

    ``precond``: ``'jacobi'`` (exact block-Jacobi), ``'banded'`` (the
    cyclic-reduction factorization of the banded part of S,
    ``solver/banded.py``) or ``'auto'``: banded when at least half of the
    landmarks form contiguous tracks short enough for the band. The 50%
    rule is the JAX package's; on the card it is not yet decided from
    measurements (ROADMAP)."""
    K, J = state0.poses.shape[0], state0.points.shape[0]
    st = problem.stereo
    if state0.poses.device.type == "cuda":
        if tables is None:
            tables = build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), K, J,
                                      device=state0.poses.device)
        if plan is None:
            plan = full_batch_plan.plan_for_problem(problem)
    tracks = None
    if precond in ("banded", "auto"):
        from ceres_slam_tpu_torch.solver import banded

        tracks = banded.build_track_info(st.pose_idx.cpu(), st.point_idx.cpu(), K, J,
                                         valid=dense.stereo_valid(problem).cpu(),
                                         device=state0.poses.device)
        if precond == "auto" and tracks.eligible_frac < 0.5:
            tracks = None
    elif precond != "jacobi":
        raise ValueError(f"unknown preconditioner: {precond!r}")

    cg_iters = []

    def step(s, lam):
        dx, grad_norm, pred, iters = pcg_step(problem, s, lam, max_cg_iters, cg_tol,
                                              tables=tables, tracks=tracks, plan=plan)
        cg_iters.append(iters)
        return dx, grad_norm, pred

    state, summary = lm.lm_solve(state0, config, lambda s: dense.ba_cost(problem, s), step,
                                 lambda s, dx: dense._retract_state(problem, s, dx))
    return state, summary._replace(linear_iterations=sum(cg_iters))
