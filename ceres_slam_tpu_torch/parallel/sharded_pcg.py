"""Distributed matrix-free Schur-PCG bundle adjustment.

Port of ``ceres_slam_tpu/parallel/sharded_pcg.py``. The observations are
sharded over the mesh's ranks; each rank keeps only its shard's coupling
blocks ``U_n``, and every PCG matvec all-reduces two small vectors:

    U^T v : [J, 3]  (the shard's sums by landmark)
    U y   : [K, 6]  (the shard's sums by pose)

The LM loop (``solver/lm.py``), the preconditioner's factorization and
solve, the CG recurrences and the retraction are replicated; the host's
decisions read only all-reduced or replicated values, so every rank takes
the same branches.

Once per LM iteration each rank's blocks come from K2
(``ops/stereo_factor_kernel.stereo_factor_sums``) on a full-batch plan of
its shard (``ops/full_batch_plan``, built once per solve; on the CPU the
plan's plain version): the shard's ``U18`` and its pose and landmark sums,
which one all-reduce then completes. K3 does not fit here: it fuses the
two halves of the coupling, and the sharded matvec must all-reduce
``U^T v`` before ``C^{-1}``. So both halves, the right-hand side, the
back-substitution and the block-Jacobi blocks are sums through the shard's
gather tables (``pcg.ObsTables``), in a fixed order (ROADMAP F14).

The banded preconditioner (``solver/banded.py``) keeps its structure under
sharding: ``banded.slot_scatter_index`` routes each observation to its slot
of the per-landmark rows ``V [J, L*18]``; each rank copies its rows that
land in a slot (each slot has one observation, so the copy is a write of
distinct rows, not a sum), one all-reduce builds ``V``, and the
cyclic-reduction factorization is replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ceres_slam_tpu_torch.ops import full_batch_plan, lie, stereo_factor_kernel
from ceres_slam_tpu_torch.parallel.sharded_ba import (local_rows, make_sharded_cost, psum,
                                                      shard_problem)
from ceres_slam_tpu_torch.solver import banded, dense, lm, pcg


class _ShardLayout(NamedTuple):
    """One shard's fixed inputs, built on the host once per solve."""

    plan: full_batch_plan.FullBatchPlan  # K2's
    tables: pcg.ObsTables  # the shard's observations grouped by landmark and by pose
    slot_rows: torch.Tensor | None  # banded: the shard's rows that land in a slot...
    slot_targets: torch.Tensor | None  # ...and the flat slot j*L + o of each


def _shard_layout(problem: dense.StereoBAProblem, slot_idx=None,
                  n_slots: int = 0) -> _ShardLayout:
    """The layout of a sharded problem (``shard_problem``); ``slot_idx`` is
    the shard's part of ``banded.slot_scatter_index`` (padded as the
    observations are), whose entries ``>= n_slots`` are the dump row."""
    st = problem.stereo
    K, J = problem.fixed_pose_mask.shape[0], problem.point_valid.shape[0]
    dev = st.uvd.device
    plan = full_batch_plan.plan_for_problem(problem)
    tables = pcg.build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), K, J, device=dev)
    rows = targets = None
    if slot_idx is not None:
        idx = np.asarray(slot_idx, np.int64)
        keep = np.nonzero(idx < n_slots)[0]
        rows, targets = torch.as_tensor(keep).to(dev), torch.as_tensor(idx[keep]).to(dev)
    return _ShardLayout(plan, tables, rows, targets)


def _local_obs_quantities(layout: _ShardLayout, state: dense.BAState):
    """The shard's factor pass (K2): ``U18 [n, 18]``, masked, and its sums
    ``Hpp [K, 36]``, ``gp [K, 6]``, ``Hll [J, 9]``, ``gl [J, 3]``."""
    return stereo_factor_kernel.stereo_factor_sums(layout.plan, state.poses, state.points)


def make_sharded_pcg_step(mesh: DeviceMesh, max_cg_iters: int = 100, cg_tol: float = 1e-6,
                          tracks: banded.TrackInfo | None = None, slot_idx=None):
    """The distributed damped solve for the LM core: ``step(problem, state,
    lam) -> (dx, grad_norm, pred_decrease, cg_iterations)`` on a sharded
    problem. The preconditioner is the exact block-Jacobi of S, or with
    ``tracks`` and ``slot_idx`` (the shard's part of its
    ``banded.slot_scatter_index``) the banded cyclic-reduction
    factorization. The step builds the shard's layout (``_shard_layout``) at
    its first call and keeps it while it is given the same observations."""
    if tracks is not None and slot_idx is None:
        raise ValueError("banded sharded PCG needs slot_idx (banded.slot_scatter_index)")
    kept = {}

    def step(problem: dense.StereoBAProblem, state: dense.BAState, lam: float):
        if kept.get("stereo") is not problem.stereo:
            n_slots = 0 if tracks is None else state.points.shape[0] * tracks.L
            kept.update(stereo=problem.stereo, layout=_shard_layout(problem, slot_idx, n_slots))
        layout = kept["layout"]
        t = layout.tables
        K, J = state.poses.shape[0], state.points.shape[0]

        # the shard's blocks by K2, all-reduced once; the replicated sun and
        # prior blocks added after the reduction, under the gauge mask
        U18, hpp36, gp, hll9, gl = _local_obs_quantities(layout, state)
        hpp36, gp, hll9, gl = psum(mesh, hpp36, gp, hll9, gl)
        Hpp_aux, gp_aux = dense.aux_pose_blocks(problem, state)
        free = layout.plan.free_pose
        zero = Hpp_aux.new_zeros(())
        Hpp = hpp36.view(K, 6, 6) + torch.where(free[:, None, None], Hpp_aux, zero)
        gp = gp + torch.where(free[:, None], gp_aux, zero)
        b = pcg._finish(U18, Hpp, gp, hll9.view(J, 3, 3), gl, lam, problem.stereo)

        def by_pose(per_obs):
            return pcg._gather_sum_by_pose(t, per_obs)

        def by_point(per_obs):
            return pcg._gather_sum_by_point(t, per_obs)

        # rhs = -(gp - U C^{-1} gl), its sum by pose reduced with the
        # preconditioner's rows in one buffer
        Uy0 = by_pose(pcg.u18_vec(U18, lie._mv(b.Cinv, b.gl)[b.point_idx]))
        UL18 = pcg.whitened_u18(b)
        if tracks is None:
            UL = UL18.view(-1, 6, 3)
            UCU, Uy0 = psum(mesh, by_pose((UL @ UL.transpose(1, 2)).reshape(-1, 36)), Uy0)
            precond = pcg._block_precond(b.Hpp - UCU.view(K, 6, 6))
        else:
            V = UL18.new_zeros((J * tracks.L, 18)).index_copy_(0, layout.slot_targets,
                                                               UL18[layout.slot_rows])
            V, Uy0 = psum(mesh, V, Uy0)
            D, E = banded.super_tridiag_from_V(V.view(J, tracks.L * 18), b.Hpp, tracks)
            precond = banded.precond_from_tridiag(D, E, tracks, K)
        rhs = -(b.gp - Uy0)

        def matvec(v):
            (Utv,) = psum(mesh, by_point(pcg.u18_t_vec(U18, v[b.pose_idx])))
            y = lie._mv(b.Cinv, Utv)
            (Uy,) = psum(mesh, by_pose(pcg.u18_vec(U18, y[b.point_idx])))
            return lie._mv(b.Hpp, v) - Uy

        dp, iters = pcg.cg(matvec, precond, rhs, max_cg_iters, cg_tol)
        (Utdp,) = psum(mesh, by_point(pcg.u18_t_vec(U18, dp[b.pose_idx])))
        dl = -lie._mv(b.Cinv, b.gl + Utdp)
        (Udl,) = psum(mesh, by_pose(pcg.u18_vec(U18, dl[b.point_idx])))
        return (*pcg.step_result(b, dp, dl, Udl), iters)

    return step


def solve_ba_pcg_sharded(problem: dense.StereoBAProblem, state0: dense.BAState, mesh: DeviceMesh,
                         config: lm.SolveConfig = lm.SolveConfig(), max_cg_iters: int = 100,
                         cg_tol: float = 1e-6, precond: str = "jacobi"):
    """Distributed LM + Schur-PCG solve. Every rank calls it with the whole
    problem and the same ``state0``, and every rank returns the same
    ``(state, SolveSummary)``, the CG iterations in ``linear_iterations``.

    ``precond``: ``'jacobi'`` (the exact block-Jacobi of S) or ``'banded'``
    (the cyclic-reduction factorization of S's banded part, for contiguous
    bounded tracks)."""
    tracks = slot_idx = None
    if precond == "banded":
        st = problem.stereo
        K, J = state0.poses.shape[0], state0.points.shape[0]
        tracks = banded.build_track_info(st.pose_idx.cpu(), st.point_idx.cpu(), K, J,
                                         valid=dense.stereo_valid(problem).cpu(),
                                         device=state0.poses.device)
        # padded to the length shard_problem pads the observations to; the
        # padding rows route to the dump row (slot indices address the rows
        # before the padding, which the padding leaves in place)
        N = st.pose_idx.shape[0]
        N_pad = -(-N // mesh.size()) * mesh.size()
        idx = np.concatenate([banded.slot_scatter_index(tracks, N),
                              np.full(N_pad - N, J * tracks.L, np.int32)])
        slot_idx = idx[local_rows(N_pad, mesh)]
    elif precond != "jacobi":
        raise ValueError(f"unknown preconditioner: {precond!r}")
    problem = shard_problem(problem, mesh)
    step = make_sharded_pcg_step(mesh, max_cg_iters, cg_tol, tracks=tracks, slot_idx=slot_idx)
    cost = make_sharded_cost(mesh)
    cg_iters = []

    def step_fn(s, lam):
        dx, grad_norm, pred, iters = step(problem, s, lam)
        cg_iters.append(iters)
        return dx, grad_norm, pred

    state, summary = lm.lm_solve(state0, config, lambda s: cost(problem, s), step_fn,
                                 lambda s, dx: dense._retract_state(problem, s, dx))
    return state, summary._replace(linear_iterations=sum(cg_iters))
