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
On CUDA ``pcg_step`` builds the tables when none are given, and a sum by
pose or by landmark without them raises. On the CPU, without a plan or
tables (the CPU default, as in the JAX package off the TPU), the
reductions are ``dense.segment_sum``, and the kernels' wrappers run their
plain versions. Masks are ``torch.where`` (ROADMAP F15).

The loops, on CUDA, as the JAX package's ``lax.while_loop``s: by default
``solve_ba_pcg`` runs its LM loop as one conditional WHILE node
(``lm.device_loop``), whose body is one LM iteration: K2's assembly, the
right-hand side, the CG loop as a WHILE node nested in the LM node
(``inner_cg``: one iteration with K3's matvec, the preconditioner and the
updates, and the stop test ``(i < max_iters) & (|r| > tol |rhs|)``, on
fixed ``CGBuffers``), the back-substitution, the retraction, the trial
cost and the control; one graph launch and one read a solve. With the LM
loop on the host (``lm_loop="host"``), ``pcg_solve`` runs the CG loop in
a WHILE node of its own (``device_cg``), captured once per solve
(``CGGraph``: each LM iteration copies its blocks and factors,
``loop_inputs``, into the captured ones), one graph launch per LM
iteration. ``cg`` is the plain version, the same iteration and test with
the loop on the host (the test read every iteration): the CPU path, the
distributed layer's host form (``parallel/sharded_pcg.py``, whose
matvec all-reduces between iterations; on NCCL ranks it runs
``inner_cg`` in its LM node) and, on the card, ``loop="host"``. Every
form runs the same kernels in the same order, so they give the same bits
and iteration counts.

On the card ``pcg_solve``'s CG iteration with the plan's matvec and the
block-Jacobi preconditioner runs fused in every form (``fused_inputs``): K3
with ``Hpp p -`` and the first dot folded into its pose phase
(``schur_kernel.schur_sp``), then one update of two kernels for the rest of
the iteration (``cg_kernel.cg_update``) in place of ~35 PyTorch kernels.
``cg_body`` stays the plain version, which the CPU, the banded
preconditioner and the sharded matvec run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import (cg_kernel, full_batch_plan, graph_loop, lie,
                                      schur_kernel, stereo_factor_kernel)
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.window import _damp, _inv3x3, _pin
from ceres_slam_tpu_torch.utils import telemetry


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
        return telemetry.to_device(x, device)

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


def _no_tables(per_obs):
    if per_obs.device.type == "cuda":
        raise ValueError("on CUDA the sums by pose and by landmark read the gather tables: "
                         "pass tables (build_obs_tables), as solve_ba_pcg and pcg_step do")


def _sum_by_pose(b: ObsBlocks, tables, per_obs):
    if tables is not None:
        return _gather_sum_by_pose(tables, per_obs)
    _no_tables(per_obs)
    return dense.segment_sum(per_obs, b.pose_idx, b.Hpp.shape[0])


def _sum_by_point(b: ObsBlocks, tables, per_obs):
    if tables is not None:
        return _gather_sum_by_point(tables, per_obs)
    _no_tables(per_obs)
    return dense.segment_sum(per_obs, b.point_idx, b.Cinv.shape[0])


def u18_t_vec(U18, v6):
    """Per-observation ``U_n^T v_n``: ``[N, 18], [N, 6] -> [N, 3]``."""
    return torch.einsum("nac,na->nc", U18.reshape(-1, 6, 3), v6)


def u18_vec(U18, y3):
    """Per-observation ``U_n y_n``: ``[N, 18], [N, 3] -> [N, 6]``."""
    return lie._mv(U18.reshape(-1, 6, 3), y3)


def _aux_blocks(problem, state, terms):
    """The sun and prior pose blocks: through ``terms`` (``dense.AuxTerms``,
    masked, no host read) where given, else ``dense.aux_pose_blocks``."""
    if terms is None:
        return dense.aux_pose_blocks(problem, state)
    return dense.aux_blocks(terms, state)


def build_obs_blocks(problem: dense.StereoBAProblem, state: dense.BAState, lam,
                     tables: ObsTables | None = None,
                     plan: full_batch_plan.FullBatchPlan | None = None,
                     terms: dense.AuxTerms | None = None) -> ObsBlocks:
    """Per-observation factor blocks and the binned Gauss-Newton diagonals:
    with a plan, K2's sums (and K3 bound to the result); else, on the CPU,
    the factor blocks summed through the gather tables or by
    ``dense.segment_sum``. ``lam``: a float or a 0-d tensor (the LM loop's
    carry); ``terms``: the sun and prior terms as ``dense.aux_terms`` makes
    them (the LM loop's body passes them: no host read).
    On CUDA K2 always runs: without a plan, one is built here (a host round
    trip of the observation tables, refused inside a capture;
    ``solve_ba_pcg`` builds it once)."""
    if plan is None and state.poses.device.type == "cuda":
        graph_loop.not_in_capture("building the full-batch plan", "solve_ba_pcg")
        plan = full_batch_plan.plan_for_problem(problem)
    if plan is not None:
        return _blocks_from_plan(problem, state, lam, plan, terms)
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
    Hpp_aux, gp_aux = _aux_blocks(problem, state, terms)
    # gauge / validity masks at block level
    free_pose, free_pt = ~p.fixed_pose_mask, p.point_valid
    zero = Hpp.new_zeros(())
    Hpp = torch.where(free_pose[:, None, None], Hpp + Hpp_aux, zero)
    gp = torch.where(free_pose[:, None], gp + gp_aux, zero)
    Hll = torch.where(free_pt[:, None, None], Hll, zero)
    gl = torch.where(free_pt[:, None], gl, zero)
    U18 = torch.where((free_pose[st.pose_idx] & free_pt[st.point_idx])[:, None], U18, zero)
    return _finish(U18, Hpp, gp, Hll, gl, lam, st)


def _blocks_from_plan(problem, state, lam, plan, terms=None):
    """K2's sums come masked; the sun and prior blocks are added under the
    gauge mask, then pinned and damped as on the other paths."""
    K, J = plan.K, plan.J
    U18, hpp36, gp, hll9, gl = stereo_factor_kernel.stereo_factor_sums(plan, state.poses,
                                                                       state.points)
    Hpp_aux, gp_aux = _aux_blocks(problem, state, terms)
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
    """``S v`` for ``v [K, 6]`` with ``dense.segment_sum`` (the CPU path
    without tables)."""
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
    """Cholesky-based inverse application of the ``[K, 6, 6]`` diagonal
    blocks: two triangular solves (``lm.cholesky_apply``), no host sync.
    ``.chol`` marks it and holds the factors (the fused CG iteration
    applies them itself)."""
    chol = lm._cholesky_or_nan(S_diag)

    def apply(r: torch.Tensor) -> torch.Tensor:  # [K, 6]
        return lm.cholesky_apply(chol, r)

    apply.tensors = (chol,)  # what it reads (a captured CG loop copies new factors in)
    apply.chol = chol
    return apply


def fused_inputs(b: ObsBlocks, precond):
    """``(b, chol)`` where ``pcg_solve``'s CG iteration on blocks ``b`` with
    ``precond`` runs fused, else None (``cg_body``). Fused:
    ``schur_kernel.schur_sp`` (K3 with ``Hpp p -`` and the first dot in its
    pose phase), then ``cg_kernel.cg_update`` (everything after the
    matvec, two kernels). It runs where it can be observed to apply: ``b``
    is bound to K3 on the card (so the matvec is the plan's) and the
    preconditioner is ``_block_precond``'s. The banded preconditioner, the
    gather and segment matvecs and the CPU take ``cg_body``, as does every
    caller of the CG loops that passes no ``fused`` (the sharded matvec,
    which all-reduces)."""
    chol = getattr(precond, "chol", None)
    if chol is None or b.uy is None or b.uy.args is None:
        return None
    return b, chol


def random_system(N: int, J: int, K: int, dtype=torch.float64, device="cpu", seed: int = 0):
    """Seeded CG inputs ``(b, tables, rhs)`` at a full-batch shape: K3's
    ``random_inputs`` (its plan, couplings and ``Cinv``; ``rhs`` its ``v``)
    with pose blocks 1.5 times the largest eigenvalue of ``U C U^T`` (power
    iteration) plus a random SPD part, so S is SPD; ``b`` bound to K3,
    ``tables`` the plan's gather tables."""
    bound, rhs = schur_kernel.random_inputs(N, J, K, dtype, device, seed=seed)
    plan = bound.plan
    v, top = torch.ones_like(rhs), 0.0
    for _ in range(30):
        w = schur_kernel.schur_uy(bound, v)
        top = (w.norm() / v.norm()).item()
        v = w / w.norm()
    A = torch.as_tensor(np.random.default_rng(seed + 1).normal(0, 0.1, (K, 6, 6)), dtype=dtype,
                        device=device)
    Hpp = (1.5 * top * torch.eye(6, dtype=dtype, device=device) + A @ A.mT).contiguous()
    b = ObsBlocks(U18=bound.U18, Hpp=Hpp, Cinv=bound.Cinv, gp=None, gl=None, Hll=None,
                  Hpp_undamped=None, pose_idx=plan.pose_idx, point_idx=plan.point_idx, uy=bound)
    tables = build_obs_tables(plan.pose_idx.cpu(), plan.point_idx.cpu(), K, J, device=device)
    return b, tables, rhs.contiguous()


def pcg_solve(b: ObsBlocks, rhs: torch.Tensor, max_iters: int, tol: float,
              tables: ObsTables | None = None, precond=None, loop: str | None = None,
              graph: CGGraph | None = None, buffers: CGBuffers | None = None):
    """Preconditioned CG on the reduced camera system; returns ``(x,
    iterations)``. The default preconditioner is the exact block-Jacobi;
    ``precond`` (a callable ``r -> M^{-1} r``, e.g.
    ``banded.make_banded_precond``) overrides it. Whatever the
    preconditioner, the matvec is ``Hpp v - K3(v)`` when ``b`` carries K3's
    binding (always on CUDA: ``b`` must come from ``build_obs_blocks``),
    else the gather matvec with ``tables``, else segment sums.

    ``loop``: ``"device"`` (the CUDA default) runs the iterations in a
    conditional WHILE node on the card (``device_cg``), ``"host"`` (the
    CPU default) in ``cg``; the two give the same bits. ``graph`` (a
    ``CGGraph``, device loop only) keeps the captured loop for the next
    call, which copies its blocks, factors and right-hand side in.
    ``buffers`` (a ``CGBuffers``): the CG loop on those fixed buffers
    through ``graph_loop.while_loop`` (``inner_cg``), what the LM loop's
    body runs: a WHILE node nested in the LM loop's node when its body is
    captured, the same loop on the host otherwise; the iterations come
    back as an int32 0-d tensor on the device, and ``x`` is the buffer."""
    on_cuda = b.U18.device.type == "cuda"
    if b.uy is None and on_cuda:
        raise ValueError("on CUDA the matvec runs K3: take the blocks from build_obs_blocks, "
                         "which binds them to the full-batch plan")
    loop = loop or ("device" if on_cuda else "host")
    if loop not in ("device", "host"):
        raise ValueError(f"unknown CG loop: {loop!r}")
    if precond is None:
        precond = _block_precond(schur_diag_blocks(b, tables))

    def matvec(v):
        if b.uy is not None:
            return schur_matvec_plan(b, v)
        if tables is not None:
            return schur_matvec_gather(b, tables, v)
        return schur_matvec(b, v)

    fused = fused_inputs(b, precond)
    if buffers is not None:
        return inner_cg(matvec, precond, rhs, max_iters, tol, buffers, fused=fused)
    if loop == "device":
        return device_cg(matvec, precond, rhs, max_iters, tol, counted=COUNTED, graph=graph,
                         inputs=None if graph is None else loop_inputs(b, precond), fused=fused)
    return cg(matvec, precond, rhs, max_iters, tol, fused)


# the kernel wrappers a CG iteration of pcg_solve launches: K3, plain or fused
# (schur_sp counts as a K3 launch too), and, fused, cg_update
COUNTED = (schur_kernel.schur_uy, schur_kernel.schur_sp, cg_kernel.cg_update)


def loop_inputs(b: ObsBlocks, precond) -> tuple:
    """Every tensor the CG iteration of ``pcg_solve`` reads that changes
    from one LM iteration to the next: the blocks ``Hpp``, ``U18`` and
    ``Cinv`` (K3 reads the last two by address) and the preconditioner's
    factors (``precond.tensors``)."""
    return (b.Hpp, b.U18, b.Cinv, *precond.tensors)


class CGState(NamedTuple):
    """The CG iterate: solution, residual, preconditioned residual, search
    direction and ``r . z`` (a 0-d tensor)."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor


def cg_start(precond, rhs: torch.Tensor, tol: float):
    """The iterate at x = 0 and the stop bound ``tol |rhs|`` (a 0-d tensor)."""
    z = precond(rhs)
    bound = tol * torch.sqrt(torch.sum(rhs * rhs))
    return CGState(torch.zeros_like(rhs), rhs, z, z, torch.sum(rhs * z)), bound


def cg_body(matvec, precond, s: CGState) -> CGState:
    """One CG iteration (``ceres_slam_tpu/solver/pcg.py``'s ``body``); pure:
    it returns new tensors and leaves ``s`` as it was."""
    Sp = matvec(s.p)
    denom = torch.sum(s.p * Sp)
    alpha = s.rz / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    x = s.x + alpha * s.p
    r = s.r - alpha * Sp
    z = precond(r)
    rz_new = torch.sum(r * z)
    beta = rz_new / torch.where(s.rz == 0.0, torch.ones_like(s.rz), s.rz)
    return CGState(x, r, z, z + beta * s.p, rz_new)


def cg_continue(s: CGState, bound: torch.Tensor) -> torch.Tensor:
    """The residual half of the stop test, ``|r| > tol |rhs|``, on the device."""
    return torch.sqrt(torch.sum(s.r * s.r)) > bound


def cg(matvec, precond, rhs: torch.Tensor, max_iters: int, tol: float, fused=None):
    """Preconditioned conjugate gradients for ``matvec(x) = rhs`` from x = 0,
    ``precond(r) -> M^{-1} r``; stops after ``max_iters`` iterations or when
    ``|r| <= tol |rhs|`` (read on the host every iteration). Returns ``(x,
    iterations)``. The plain version of ``device_cg``: ``cg_loop``'s body
    iterated on the host (fused with ``fused``, as in the device forms)."""
    lp = cg_loop(matvec, precond, rhs, max_iters, tol, fused)
    it = 0
    while int(lp.pred):
        lp.body()
        it += 1
    return lp.s.x, it


class CGBuffers(NamedTuple):
    """Fixed buffers of a CG loop: the iterate, the stop bound ``tol
    |rhs|``, the iteration count ``i`` and the stop test ``pred`` (int32,
    1: run again)."""

    s: CGState
    bound: torch.Tensor  # 0-d
    i: torch.Tensor  # int32 [1]
    pred: torch.Tensor  # int32 [1]


def cg_buffers(like: torch.Tensor) -> CGBuffers:
    """Zeroed ``CGBuffers`` for right-hand sides shaped as ``like``."""
    z = torch.zeros_like(like)
    s = CGState(z, z.clone(), z.clone(), z.clone(), z.new_zeros(()))
    i = torch.zeros(1, dtype=torch.int32, device=like.device)
    return CGBuffers(s, z.new_zeros(()), i, i.clone())


def _cg_in_place(matvec, precond, bufs: CGBuffers, max_iters: int, tol: float, fused=None):
    """``(restart(rhs), body())`` of a CG loop on ``bufs``: ``restart``
    puts the buffers at the start for ``rhs`` (``cg_start``), ``body``
    runs one iteration in place, counts it in ``i`` and writes the stop
    test ``(i < max_iters) & (|r| > tol |rhs|)`` to ``pred``: ``cg_body``,
    or with ``fused`` (``fused_inputs``' ``(b, chol)``, whose matvec and
    factors are ``matvec``'s and ``precond``'s) ``schur_sp`` and
    ``cg_update``."""
    s, i, pred = bufs.s, bufs.i, bufs.pred

    def test():
        return (i < max_iters) & cg_continue(s, bufs.bound)

    def body():
        for buf, t in zip(s, cg_body(matvec, precond, s)):
            buf.copy_(t)
        i.add_(1)
        pred.copy_(test())

    def fused_body():
        b, chol = fused
        Sp, dots = schur_kernel.schur_sp(b.uy, s.p, b.Hpp)
        cg_kernel.cg_update(s, Sp, dots, chol, bufs.bound, i, pred, max_iters)

    def restart(rhs):
        start, bound = cg_start(precond, rhs, tol)
        for buf, t in zip((*s, bufs.bound), (*start, bound)):
            buf.copy_(t)
        i.zero_()
        pred.copy_(test())

    return restart, body if fused is None else fused_body


def inner_cg(matvec, precond, rhs: torch.Tensor, max_iters: int, tol: float, bufs: CGBuffers,
             counted=COUNTED, fused=None):
    """``cg`` on the fixed buffers ``bufs`` through ``graph_loop.while_loop``:
    inside the capture of a ``DeviceWhile`` (the LM loop's node) a WHILE
    node nested in its body, the wrappers in ``counted`` (``COUNTED`` by
    default; the sharded matvec's ``psum``) counted per CG iteration the
    card runs; elsewhere the loop on the host. Returns ``(x, iterations)``:
    the buffer ``x`` (the next call overwrites it) and an int32 0-d
    tensor."""
    restart, body = _cg_in_place(matvec, precond, bufs, max_iters, tol, fused)
    restart(rhs)
    graph_loop.while_loop(body, bufs.pred, counted=counted)
    return bufs.s.x, bufs.i[0]


class CGLoop(NamedTuple):
    """The loop ``device_cg`` captures: ``body()`` runs one CG iteration on
    the state buffers ``s`` in place, counts it in ``i`` and writes the stop
    test ``(i < max_iters) & (|r| > tol |rhs|)`` to ``pred`` (int32, 1:
    run again), which holds the test of the starting iterate.
    ``restart(rhs)`` puts the buffers at the start for a new right-hand
    side (the matvec's and the preconditioner's tensors as they are now)."""

    s: CGState
    i: torch.Tensor  # int32 [1]
    pred: torch.Tensor  # int32 [1]
    body: object
    restart: object


def cg_loop(matvec, precond, rhs: torch.Tensor, max_iters: int, tol: float,
            fused=None) -> CGLoop:
    """The state buffers and the body of the CG loop (fused with ``fused``),
    on any device (on the CPU the tests iterate ``body`` while ``pred``, as
    the WHILE node does)."""
    bufs = cg_buffers(rhs)
    restart, body = _cg_in_place(matvec, precond, bufs, max_iters, tol, fused)
    restart(rhs)
    return CGLoop(bufs.s, bufs.i, bufs.pred, body, restart)


class CGGraph:
    """A CG loop captured once and run for every LM iteration of a solve
    (``solve_ba_pcg`` on CUDA makes one): the first ``device_cg`` call
    captures its body on its own tensors (the blocks, the preconditioner's
    factors), which the graph then reads by address; a later call whose
    tensors have the same shapes copies them into those and restarts the
    loop, with no capture and no instantiation. ``close()`` frees it."""

    def __init__(self):
        self.key = self.loop = self.lp = self.inputs = None

    def close(self) -> None:
        if self.loop is not None:
            self.loop.close()
        self.key = self.loop = self.lp = self.inputs = None


def device_cg(matvec, precond, rhs: torch.Tensor, max_iters: int, tol: float, counted=(),
              graph: CGGraph | None = None, inputs=None, fused=None):
    """``cg`` with its loop on the card: ``cg_loop``'s body captured and run
    in a conditional WHILE node (``graph_loop.DeviceWhile``), one graph
    launch for all the iterations; the host reads the iteration count once,
    after the loop. ``counted``: the kernel wrappers the matvec or the
    preconditioner launch (each gets one launch per iteration). With a
    ``graph``, ``inputs`` lists every tensor the matvec and the
    preconditioner read that changes from call to call; the loop is kept
    there and reused while their shapes stay (without one, the capture is
    this call's alone). ``fused``: as ``cg``'s. Raises on the CPU, and if
    the capture fails."""
    if rhs.device.type != "cuda":
        raise ValueError(f"device_cg runs on the card, not {rhs.device}: use cg")
    own = graph is None
    graph = CGGraph() if own else graph
    key = (max_iters, tol, rhs.shape, rhs.dtype, fused is None,
           None if inputs is None else tuple((t.shape, t.dtype) for t in inputs))
    if graph.key == key and inputs is not None:
        for dst, src in zip(graph.inputs, inputs):
            dst.copy_(src)
        graph.lp.restart(rhs)
    else:
        graph.close()
        graph.lp = cg_loop(matvec, precond, rhs, max_iters, tol, fused)
        graph.loop = graph_loop.DeviceWhile(graph.lp.body, graph.lp.pred, counted=counted)
        graph.key, graph.inputs = key, inputs
    try:
        n = graph.loop.run()
        return graph.lp.s.x.clone(), n  # the buffer is the next call's
    finally:
        if own:
            graph.close()


def pcg_step(problem, state, lam, max_cg_iters: int = 100, cg_tol: float = 1e-6,
             tables: ObsTables | None = None, tracks=None,
             plan: full_batch_plan.FullBatchPlan | None = None, loop: str | None = None,
             graph: CGGraph | None = None, terms: dense.AuxTerms | None = None,
             buffers: CGBuffers | None = None):
    """One damped LM linear solve via Schur + PCG. Returns ``(dx, grad_norm,
    pred_decrease, cg_iterations)``; the first three are the LM core's
    step contract. ``lam``: a float or a 0-d tensor. With ``tracks`` (a
    ``banded.TrackInfo``) the preconditioner is the banded cyclic-reduction
    factorization; with ``plan``, and always on CUDA, K2 and K3 carry the
    assembly and the matvecs (``build_obs_blocks`` builds the plan where
    none is given). On CUDA the gather tables are built here where none are
    given (a host round trip, refused inside a capture; ``solve_ba_pcg``
    builds them once), so every sum outside the kernels has a fixed order.
    ``loop``, ``graph``, ``buffers``: ``pcg_solve``'s; ``terms``:
    ``build_obs_blocks``'."""
    if tables is None and state.poses.device.type == "cuda":
        graph_loop.not_in_capture("building the gather tables", "solve_ba_pcg")
        st = problem.stereo
        tables = build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), state.poses.shape[0],
                                  state.points.shape[0], device=state.poses.device)
    b = build_obs_blocks(problem, state, lam, tables=tables, plan=plan, terms=terms)
    precond = None
    if tracks is not None:
        from ceres_slam_tpu_torch.solver import banded

        precond = banded.make_banded_precond(b, tracks, b.Hpp.shape[0])

    # rhs = -(gp - U C^{-1} gl)
    y = lie._mv(b.Cinv, b.gl)
    rhs = -(b.gp - _sum_by_pose(b, tables, u18_vec(b.U18, y[b.point_idx])))
    dp, iters = pcg_solve(b, rhs, max_cg_iters, cg_tol, tables=tables, precond=precond, loop=loop,
                          graph=graph, buffers=buffers)

    # back-substitute landmarks: dl = -C^{-1}(gl + U^T dp)
    Utdp = _sum_by_point(b, tables, u18_t_vec(b.U18, dp[b.pose_idx]))
    dl = -lie._mv(b.Cinv, b.gl + Utdp)
    Udl = _sum_by_pose(b, tables, u18_vec(b.U18, dl[b.point_idx]))
    return (*step_result(b, dp, dl, Udl), iters)


def step_result(b: ObsBlocks, dp: torch.Tensor, dl: torch.Tensor, Udl: torch.Tensor):
    """The LM core's step contract ``(dx, grad_norm, pred_decrease)`` from the
    pose and landmark steps and ``Udl = U dl`` summed by pose; the predicted
    decrease is the undamped blocks'."""
    dx = torch.cat([dp.reshape(-1), dl.reshape(-1)])
    grad_norm = torch.maximum(b.gp.abs().max(), b.gl.abs().max())
    g_dot_dx = torch.sum(b.gp * dp) + torch.sum(b.gl * dl)
    dxHdx = (torch.einsum("ka,kab,kb->", dp, b.Hpp_undamped, dp) + 2.0 * torch.sum(dp * Udl)
             + torch.einsum("ja,jab,jb->", dl, b.Hll, dl))
    return dx, grad_norm, -(g_dot_dx + 0.5 * dxHdx)


def lm_loop_inputs(problem: dense.StereoBAProblem, state0: dense.BAState,
                   terms: dense.AuxTerms, tables: ObsTables | None, plan, tracks) -> tuple:
    """Every tensor the LM loop of ``solve_ba_pcg`` reads that changes from
    one solve to the next: the observations, the gauge and landmark masks,
    the sun and prior terms, the gather tables, the full-batch plan (K2 and
    K3 read it by address; not its scratch), the banded preconditioner's
    tracks and the initial state. A later solve of an ``lm.LMGraph`` copies
    them into the captured ones."""
    plan_tensors = () if plan is None else tuple(
        t for name, t in plan._asdict().items() if isinstance(t, torch.Tensor)
        and name not in ("y", "hg"))
    return (*lm.leaves(problem.stereo), problem.fixed_pose_mask, problem.point_valid,
            *lm.leaves(terms), *lm.leaves(tables), *plan_tensors, *lm.leaves(tracks),
            state0.poses, state0.points)


def _lm_key(problem, max_cg_iters, cg_tol, plan, tracks) -> tuple:
    """What the device LM loop's body holds as Python values (beside the
    inputs' shapes): the CG settings, the camera, the prior's pose, the
    plan's group bound (in K3's launch arguments) and the band's layout."""
    return (max_cg_iters, cg_tol, problem.camera, int(problem.prior.pose_idx),
            None if plan is None or plan.args is None else plan.args.max_group,
            None if tracks is None else (tracks.L, tracks.n_super))


def resolve_loops(device, loop: str | None, lm_loop: str | None) -> tuple:
    """The ``(CG, LM)`` loops a solve on ``device`` runs: on CUDA both on
    the card unless asked otherwise (elsewhere both on the host, unless
    asked for the device LM loop, which takes the device CG loop);
    ``loop="host"`` (the host CG loop) forces the host LM loop; the device
    LM loop with the host CG loop cannot run and raises (so does an
    unknown loop)."""
    on_card = torch.device(device).type == "cuda"
    for name, v in (("CG", loop), ("LM", lm_loop)):
        if v not in (None, "device", "host"):
            raise ValueError(f"unknown {name} loop: {v!r}")
    if lm_loop == "device" and loop == "host":
        raise ValueError("the LM loop on the card runs the CG loop as a WHILE node inside it: "
                         "lm_loop='device' needs loop='device'; the host CG loop runs under "
                         "lm_loop='host'")
    loop = loop or ("device" if on_card or lm_loop == "device" else "host")
    lm_loop = lm_loop or ("device" if loop == "device" and on_card else "host")
    return loop, lm_loop


def prepare(problem: dense.StereoBAProblem, state0: dense.BAState,
            tables: ObsTables | None = None, plan=None, precond: str = "auto"):
    """What a solve builds once, before its loop: ``(tables, plan, tracks,
    terms)``. On CUDA the gather tables and the full-batch plan are built
    where none are given (on the CPU they stay as given); ``tracks`` for
    the banded preconditioner (``precond``: ``'jacobi'``, ``'banded'`` or
    ``'auto'``: banded when at least half of the landmarks form contiguous
    tracks short enough for the band); the sun and prior ``terms``."""
    K, J = state0.poses.shape[0], state0.points.shape[0]
    st = problem.stereo
    with telemetry.span("pcg.prepare"):
        if state0.poses.device.type == "cuda":
            if tables is None:
                with telemetry.span("pcg.tables"):
                    tables = build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), K, J,
                                              device=state0.poses.device)
            if plan is None:
                with telemetry.span("pcg.plan"):
                    plan = full_batch_plan.plan_for_problem(problem)
        tracks = None
        if precond in ("banded", "auto"):
            from ceres_slam_tpu_torch.solver import banded

            with telemetry.span("pcg.tracks"):
                tracks = banded.build_track_info(st.pose_idx.cpu(), st.point_idx.cpu(), K, J,
                                                 valid=dense.stereo_valid(problem).cpu(),
                                                 device=state0.poses.device)
            if precond == "auto" and tracks.eligible_frac < 0.5:
                tracks = None
        elif precond != "jacobi":
            raise ValueError(f"unknown preconditioner: {precond!r}")
        return tables, plan, tracks, dense.aux_terms(problem)


def lm_functions(problem, tables, plan, tracks, terms, max_cg_iters: int = 100,
                 cg_tol: float = 1e-6, loop: str | None = None, graph: CGGraph | None = None,
                 buffers: CGBuffers | None = None):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of a full-batch
    solve (``prepare``'s tables, plan, tracks and terms): the step is
    ``pcg_step``, its CG loop ``loop`` (with ``graph``), or on ``buffers``
    (``inner_cg``: the device LM loop's body)."""

    def cost(s):
        return dense.ba_cost(problem, s, terms)

    def step(s, lam):
        return pcg_step(problem, s, lam, max_cg_iters, cg_tol, tables=tables, tracks=tracks,
                        plan=plan, loop=loop, graph=graph, terms=terms, buffers=buffers)

    def retract(s, dx):
        return dense._retract_state(problem, s, dx)

    return cost, step, retract


def solve_ba_pcg(problem: dense.StereoBAProblem, state0: dense.BAState,
                 config: lm.SolveConfig = lm.SolveConfig(), max_cg_iters: int = 100,
                 cg_tol: float = 1e-6, tables: ObsTables | None = None, precond: str = "auto",
                 plan: full_batch_plan.FullBatchPlan | None = None, loop: str | None = None,
                 lm_loop: str | None = None, graph: lm.LMGraph | None = None):
    """LM with the matrix-free Schur-PCG linear solver (the role of Ceres'
    ITERATIVE_SCHUR). Returns ``(state, SolveSummary)`` with the CG
    iterations of the whole solve in ``linear_iterations``.

    On CUDA the full-batch plan and the gather tables are built here
    whenever none are given, so K2 runs every LM iteration and K3 every
    matvec; on the CPU they are used only if given. The sun and prior
    terms go through ``dense.aux_terms``, made once (``prepare``).

    The loops: on CUDA, by default, the LM loop runs on the card as one
    conditional WHILE node (``lm.device_loop``; JAX's ``lax.while_loop`` at
    ``ceres_slam_tpu/solver/lm.py:182``), its body one LM iteration (K2's
    assembly, the right-hand side, the CG loop as a WHILE node nested in
    it with K3 inside, the back-substitution, the retraction, the trial
    cost and the control): one graph launch and one read a solve.
    ``lm_loop="host"`` runs the LM loop on the host (``lm.host_loop``)
    around the CG loop's own node (``loop="device"``, captured once for the
    solve in a ``CGGraph``) or around ``cg`` (``loop="host"``, which forces
    the host LM loop); ``lm_loop="device"`` with ``loop="host"`` raises.
    On the CPU both loops run on the host. Every form gives the same bits.
    ``graph`` (an ``lm.LMGraph``, device LM loop only) keeps the capture
    for the next solve of the same shape, which copies its
    ``lm_loop_inputs`` into this solve's tensors (the problem's, the
    tables', the plan's: they are overwritten) and restarts it.

    ``precond``: ``'jacobi'`` (exact block-Jacobi), ``'banded'`` (the
    cyclic-reduction factorization of the banded part of S,
    ``solver/banded.py``) or ``'auto'`` (``prepare``). The 50% rule of
    ``'auto'`` is the JAX package's; on the card it is not yet decided from
    measurements (ROADMAP)."""
    with telemetry.span("pcg.solve"):
        loop, lm_loop = resolve_loops(state0.poses.device, loop, lm_loop)
        tables, plan, tracks, terms = prepare(problem, state0, tables, plan, precond)
        if lm_loop == "device":
            state0 = lm.tree_map(torch.clone, state0)  # the loop's own: a restart copies into it
            buffers = cg_buffers(state0.poses.new_zeros((state0.poses.shape[0], 6)))
            fns = lm_functions(problem, tables, plan, tracks, terms, max_cg_iters, cg_tol,
                               buffers=buffers)
            return lm.lm_solve(state0, config, *fns, loop="device",
                               counted=(stereo_factor_kernel.stereo_factor_sums,), graph=graph,
                               tallies={"fused_cg_iterations": cg_kernel.cg_update},
                               inputs=lm_loop_inputs(problem, state0, terms, tables, plan, tracks),
                               key=_lm_key(problem, max_cg_iters, cg_tol, plan, tracks))
        if graph is not None:
            raise ValueError("an LMGraph keeps the device LM loop: lm_loop='host' takes none")
        cg_graph = CGGraph() if loop == "device" else None  # one capture of the CG loop a solve
        try:
            return lm.lm_solve(state0, config, *lm_functions(
                problem, tables, plan, tracks, terms, max_cg_iters, cg_tol, loop, cg_graph),
                loop="host")
        finally:
            if cg_graph is not None:
                cg_graph.close()
