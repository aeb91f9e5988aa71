"""Distributed matrix-free Schur-PCG bundle adjustment.

Port of ``ceres_slam_tpu/parallel/sharded_pcg.py``. The observations are
sharded over the mesh's ranks; each rank keeps only its shard's coupling
blocks ``U_n``, and every PCG matvec all-reduces two small vectors:

    U^T v : [J, 3]  (the shard's sums by landmark)
    U y   : [K, 6]  (the shard's sums by pose)

The LM loop (``solver/lm.py``), the preconditioner's factorization and
solve, the CG recurrences and the retraction are replicated; the loops'
decisions read only all-reduced or replicated values, so every rank takes
the same branches and runs the same number of iterations.

The loops' forms, as JAX's ``lax.while_loop``s under ``shard_map`` in one
``jax.jit`` (``solve_ba_pcg_sharded``, ``sharded_ba.resolve_loop``): on an
NCCL mesh of one host (one rank, or the ranks of one machine's cards, 1-D
or hybrid) by default the LM loop is one conditional WHILE node on the
card (``lm.device_loop``) whose body holds the CG loop as a WHILE node of
its own (``pcg.inner_cg`` on fixed ``pcg.CGBuffers``), the peer all-reduce
kernels (``ops/allreduce_kernel``) captured in both; on gloo ranks and on
NCCL meshes that span hosts both loops run on the host (``lm.host_loop``
around ``pcg.cg``), and ``device`` raises there. ``lm_loop="host"`` with
``cg_loop="device"`` runs the CG loop's own node once per LM iteration
(``pcg.device_cg``); the device LM loop with the host CG loop raises.
Every form gives the same bits.

Once per LM iteration each rank's blocks come from K2
(``ops/stereo_factor_kernel.stereo_factor_sums``) on a full-batch plan of
its shard (``ops/full_batch_plan``; on the CPU the plan's plain version):
the shard's ``U18`` and its pose and landmark sums, which one all-reduce
then completes. K3 does not fit here: it fuses the two halves of the
coupling, and the sharded matvec must all-reduce ``U^T v`` before
``C^{-1}``. So both halves, the right-hand side, the back-substitution and
the block-Jacobi blocks are sums through the shard's gather tables
(``pcg.ObsTables``), in a fixed order (ROADMAP F14). The plan, the tables
and the banded slot rows (``_ShardLayout``) and the sun and prior terms
are built once per solve, before the loop (a host round trip, which a
captured loop cannot make).

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
from ceres_slam_tpu_torch.parallel.sharded_ba import (COUNTED, local_rows, loop_key,
                                                      make_sharded_cost, psum, reserve,
                                                      resolve_loop, shard_problem)
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


def make_sharded_pcg_step(mesh: DeviceMesh, layout: _ShardLayout, terms: dense.AuxTerms,
                          max_cg_iters: int = 100, cg_tol: float = 1e-6,
                          tracks: banded.TrackInfo | None = None, cg_loop: str = "host",
                          graph: pcg.CGGraph | None = None,
                          buffers: pcg.CGBuffers | None = None):
    """The distributed damped solve for the LM core: ``step(problem, state,
    lam) -> (dx, grad_norm, pred_decrease, cg_iterations)`` on a sharded
    problem whose ``layout`` (``_shard_layout``) and sun and prior
    ``terms`` (``dense.aux_terms``) were built before the loop. The
    preconditioner is the exact block-Jacobi of S, or with ``tracks`` (and
    the layout's slot rows) the banded cyclic-reduction factorization. The
    CG loop: on ``buffers`` through ``pcg.inner_cg`` (a WHILE node nested
    in the LM node when its body is captured, the host loop otherwise; the
    iterations an int32 on the device), else ``cg_loop``: ``"device"``
    (``pcg.device_cg``, kept in ``graph``) or ``"host"`` (``pcg.cg``)."""
    if tracks is not None and layout.slot_rows is None:
        raise ValueError("banded sharded PCG needs the slot rows (banded.slot_scatter_index)")
    t = layout.tables

    def by_pose(per_obs):
        return pcg._gather_sum_by_pose(t, per_obs)

    def by_point(per_obs):
        return pcg._gather_sum_by_point(t, per_obs)

    def step(problem: dense.StereoBAProblem, state: dense.BAState, lam):
        K, J = state.poses.shape[0], state.points.shape[0]

        # the shard's blocks by K2, all-reduced once; the replicated sun and
        # prior blocks added after the reduction, under the gauge mask
        U18, hpp36, gp, hll9, gl = _local_obs_quantities(layout, state)
        hpp36, gp, hll9, gl = psum(mesh, hpp36, gp, hll9, gl)
        Hpp_aux, gp_aux = dense.aux_blocks(terms, state)
        free = layout.plan.free_pose
        zero = Hpp_aux.new_zeros(())
        Hpp = hpp36.view(K, 6, 6) + torch.where(free[:, None, None], Hpp_aux, zero)
        gp = gp + torch.where(free[:, None], gp_aux, zero)
        b = pcg._finish(U18, Hpp, gp, hll9.view(J, 3, 3), gl, lam, problem.stereo)

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

        if buffers is not None:
            dp, iters = pcg.inner_cg(matvec, precond, rhs, max_cg_iters, cg_tol, buffers,
                                     counted=COUNTED)
        elif cg_loop == "device":
            dp, iters = pcg.device_cg(matvec, precond, rhs, max_cg_iters, cg_tol,
                                      counted=COUNTED, graph=graph,
                                      inputs=None if graph is None else pcg.loop_inputs(b, precond))
        else:
            dp, iters = pcg.cg(matvec, precond, rhs, max_cg_iters, cg_tol)
        (Utdp,) = psum(mesh, by_point(pcg.u18_t_vec(U18, dp[b.pose_idx])))
        dl = -lie._mv(b.Cinv, b.gl + Utdp)
        (Udl,) = psum(mesh, by_pose(pcg.u18_vec(U18, dl[b.point_idx])))
        return (*pcg.step_result(b, dp, dl, Udl), iters)

    return step


def resolve_loops(mesh: DeviceMesh, cg_loop: str | None, lm_loop: str | None) -> tuple:
    """The ``(CG, LM)`` loops of a sharded solve (``sharded_ba.resolve_loop``
    for each): on an NCCL mesh of one host both on the card unless asked
    otherwise, elsewhere both on the host, where ``device`` raises; the
    host CG loop takes the host LM loop, and the device LM loop with the
    host CG loop raises."""
    if lm_loop == "device" and cg_loop == "host":
        raise ValueError("the LM loop on the card runs the CG loop as a WHILE node inside it: "
                         "lm_loop='device' needs cg_loop='device'")
    cg_loop = resolve_loop(mesh, cg_loop, "CG loop", "cg_loop")
    return cg_loop, resolve_loop(mesh, "host" if lm_loop is None and cg_loop == "host"
                                 else lm_loop)


class ShardedSolve(NamedTuple):
    """What a sharded PCG solve builds once, before its loop
    (``prepare``): the shard, its layout, the sun and prior terms and the
    banded preconditioner's tracks (None for block-Jacobi)."""

    problem: dense.StereoBAProblem
    layout: _ShardLayout
    terms: dense.AuxTerms
    tracks: banded.TrackInfo | None


def prepare(problem: dense.StereoBAProblem, state0: dense.BAState, mesh: DeviceMesh,
            precond: str = "jacobi") -> ShardedSolve:
    """The shard of ``problem`` and what its loop reads, built on the host,
    and the all-reduce's workspaces reserved at the largest buffer the loop
    reduces (``precond``: ``'jacobi'``, the exact block-Jacobi of S, or
    ``'banded'``, the cyclic-reduction factorization of S's banded part,
    for contiguous bounded tracks)."""
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
    shard = shard_problem(problem, mesh)
    K, J = state0.poses.shape[0], state0.points.shape[0]
    # the step's blocks; the preconditioner's rows with the right-hand side
    reserve(mesh, max(K * 42 + J * 12, 0 if tracks is None else J * tracks.L * 18 + K * 6),
            state0.poses)
    n_slots = 0 if tracks is None else J * tracks.L
    return ShardedSolve(shard, _shard_layout(shard, slot_idx, n_slots), dense.aux_terms(shard),
                        tracks)


def lm_functions(prep: ShardedSolve, mesh: DeviceMesh, max_cg_iters: int = 100,
                 cg_tol: float = 1e-6, cg_loop: str = "host", graph: pcg.CGGraph | None = None,
                 buffers: pcg.CGBuffers | None = None):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of a sharded solve
    (``prepare``'s): the step is ``make_sharded_pcg_step``'s, its CG loop
    ``cg_loop`` (with ``graph``) or on ``buffers`` (the device LM loop's
    body)."""
    p = prep.problem
    cost = make_sharded_cost(mesh, prep.terms)
    step = make_sharded_pcg_step(mesh, prep.layout, prep.terms, max_cg_iters, cg_tol,
                                 prep.tracks, cg_loop, graph, buffers)
    return (lambda s: cost(p, s), lambda s, lam: step(p, s, lam),
            lambda s, dx: dense._retract_state(p, s, dx))


def loop_inputs(prep: ShardedSolve, state0: dense.BAState) -> tuple:
    """Every tensor the device LM loop of a sharded solve reads that changes
    from one solve to the next (``pcg.lm_loop_inputs`` of the shard, and
    the banded slot rows)."""
    lay = prep.layout
    slots = () if lay.slot_rows is None else (lay.slot_rows, lay.slot_targets)
    return (*pcg.lm_loop_inputs(prep.problem, state0, prep.terms, lay.tables, lay.plan,
                                prep.tracks), *slots)


def solve_ba_pcg_sharded(problem: dense.StereoBAProblem, state0: dense.BAState, mesh: DeviceMesh,
                         config: lm.SolveConfig = lm.SolveConfig(), max_cg_iters: int = 100,
                         cg_tol: float = 1e-6, precond: str = "jacobi",
                         lm_loop: str | None = None, cg_loop: str | None = None,
                         graph: lm.LMGraph | None = None):
    """Distributed LM + Schur-PCG solve. Every rank calls it with the whole
    problem and the same ``state0``, and every rank returns the same
    ``(state, SolveSummary)``, the CG iterations in ``linear_iterations``.

    ``precond``: ``'jacobi'`` (the exact block-Jacobi of S) or ``'banded'``
    (``prepare``). ``lm_loop``, ``cg_loop``: ``"device"`` (the defaults on
    an NCCL mesh of one host) runs the LM loop as one WHILE node with the CG
    loop's node nested in it, K2 counted per LM iteration and ``psum`` and
    its kernel per iteration the card ran; the capture is kept in ``graph``
    (an ``lm.LMGraph``) for the next solve of the same shape, which copies
    its ``loop_inputs`` in and restarts it. ``"host"`` (the defaults
    elsewhere, where ``"device"`` raises: ``sharded_ba.resolve_loop``)
    iterates on the host; ``lm_loop="host"`` with ``cg_loop="device"`` runs
    the CG node once per LM iteration. Every form gives the same bits."""
    cg_loop, lm_loop = resolve_loops(mesh, cg_loop, lm_loop)
    if lm_loop == "host" and graph is not None:
        raise ValueError("an LMGraph keeps the device LM loop: lm_loop='host' takes none")
    prep = prepare(problem, state0, mesh, precond)
    if lm_loop == "host":
        cg_graph = pcg.CGGraph() if cg_loop == "device" else None  # one capture a solve
        try:
            return lm.lm_solve(state0, config, *lm_functions(prep, mesh, max_cg_iters, cg_tol,
                                                              cg_loop, cg_graph), loop="host")
        finally:
            if cg_graph is not None:
                cg_graph.close()
    state0 = lm.tree_map(torch.clone, state0)  # the loop's own: a restart copies into it
    buffers = pcg.cg_buffers(state0.poses.new_zeros((state0.poses.shape[0], 6)))
    return lm.lm_solve(state0, config, *lm_functions(prep, mesh, max_cg_iters, cg_tol,
                                                      buffers=buffers),
                       loop="device", counted=(stereo_factor_kernel.stereo_factor_sums, *COUNTED),
                       graph=graph, inputs=loop_inputs(prep, state0),
                       key=loop_key(prep.problem, mesh, "sharded pcg", pcg._lm_key(
                           prep.problem, max_cg_iters, cg_tol, prep.layout.plan, prep.tracks)))
