"""Pose-graph optimization: priors and relative-pose factors over SE(3).

Port of ``ceres_slam_tpu/solver/pose_graph.py`` (the reference's
PoseError / RelativePoseError family outside bundle adjustment;
``tests/blowup_test.cpp`` builds this problem). The tangent system over
``6K`` unknowns is dense and solved by the LM core.

Where the JAX module adds the per-factor blocks with segment sums and
three scatters into H (two factors on one pair of poses, a repeated edge
or (i, j) beside (j, i), land on the same block), this one sums them
through gather tables built once per problem on the host
(``pose_graph_tables``): a by-pose table for the gradient and a by-block
table over the 6x6 blocks that any factor touches, whose sums are then
written to distinct blocks of H. Every sum is in a fixed order, so the
card gives the same bits every run (ROADMAP F14); masks are
``torch.where`` (F15).

Nothing in the LM iteration reads the device from the host (the tables
are built before the loop), so on the card ``solve_pose_graph`` runs the
loop as one conditional WHILE node (``lm_loop="device"``, the default
there), and ``apps/blowup.py`` nests it in its chain's node
(``lm.inner_lm`` on ``lm_functions``), rewriting the prior's tensors in
place between solves; ``pose_graph_loop_inputs`` lists what the body reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.window import gather_table


class RelPoseFactors(NamedTuple):
    idx1: torch.Tensor  # [N] int — pose T_1_0
    idx2: torch.Tensor  # [N] int — pose T_2_0
    T_ref: torch.Tensor  # [N, 12] measured T_2_1
    stiffness: torch.Tensor  # [N, 6, 6]
    valid: torch.Tensor  # [N] bool


class PriorFactors(NamedTuple):
    idx: torch.Tensor  # [P] int
    T_ref: torch.Tensor  # [P, 12]
    stiffness: torch.Tensor  # [P, 6, 6]
    valid: torch.Tensor  # [P] bool


class PoseGraphProblem(NamedTuple):
    rel: RelPoseFactors
    priors: PriorFactors
    fixed_pose_mask: torch.Tensor  # [K] bool


class PoseGraphTables(NamedTuple):
    """Gather tables of one problem's structure. The per-factor rows are
    ordered ``[J1^T J1 (N), J2^T J2 (N), Jp^T Jp (P), J1^T J2 (N), J2^T J1
    (N)]`` for the blocks and ``[J1^T r (N), J2^T r (N), Jp^T rp (P)]`` for
    the gradient."""

    by_pose: torch.Tensor  # [K, D] gradient rows of each pose
    by_block: torch.Tensor  # [B, D'] block rows of each 6x6 block that a factor touches
    block_row: torch.Tensor  # [B] the block's pose row
    block_col: torch.Tensor  # [B] and column


def pose_graph_tables(problem: PoseGraphProblem) -> PoseGraphTables:
    """The problem's gather tables (one host read of its indices), on its device."""
    K = problem.fixed_pose_mask.shape[0]
    i1, i2 = problem.rel.idx1.cpu().numpy(), problem.rel.idx2.cpu().numpy()
    ip = problem.priors.idx.cpu().numpy()
    by_pose = gather_table(np.concatenate([i1, i2, ip]), K)
    block_ids = np.concatenate([i1 * (K + 1), i2 * (K + 1), ip * (K + 1), i1 * K + i2,
                                i2 * K + i1])
    blocks, inverse = np.unique(block_ids, return_inverse=True)
    device = problem.fixed_pose_mask.device

    def put(x):
        return torch.as_tensor(x, dtype=torch.int64).to(device)

    return PoseGraphTables(put(by_pose), put(gather_table(inverse.reshape(-1), blocks.size)),
                           put(blocks // K), put(blocks % K))


def _terms(problem: PoseGraphProblem, poses: torch.Tensor):
    rel, pr = problem.rel, problem.priors
    r_rel, J1, J2 = factors.relative_pose(poses[rel.idx1], poses[rel.idx2], rel.T_ref,
                                          rel.stiffness)
    r_pr, J_pr = factors.pose_prior(poses[pr.idx], pr.T_ref, pr.stiffness)
    return (r_rel, J1, J2), (r_pr, J_pr)


def pose_graph_cost(problem: PoseGraphProblem, poses: torch.Tensor) -> torch.Tensor:
    """``1/2 sum |r|^2`` over the valid factors; the residuals alone, as
    ``relative_pose`` and ``pose_prior`` compute them (no Jacobians)."""
    rel, pr = problem.rel, problem.priors
    T_est = lie.se3_compose(poses[rel.idx1], lie.se3_inverse(poses[rel.idx2]))
    r_rel = lie._mv(rel.stiffness, lie.se3_log(lie.se3_compose(rel.T_ref, T_est)))
    r_pr = lie._mv(pr.stiffness,
                   lie.se3_log(lie.se3_compose(pr.T_ref, lie.se3_inverse(poses[pr.idx]))))
    c = torch.sum(torch.where(problem.rel.valid, torch.sum(r_rel * r_rel, dim=-1), 0.0))
    c = c + torch.sum(torch.where(problem.priors.valid, torch.sum(r_pr * r_pr, dim=-1), 0.0))
    return 0.5 * c


def pose_graph_normal_equations(problem: PoseGraphProblem, poses: torch.Tensor,
                                tables: PoseGraphTables | None = None):
    """The gauge-masked dense tangent system ``(H [6K, 6K], g [6K])``, with
    a unit diagonal wherever the diagonal is zero (fixed poses)."""
    K = poses.shape[0]
    tables = pose_graph_tables(problem) if tables is None else tables
    (r_rel, J1, J2), (r_pr, J_pr) = _terms(problem, poses)
    v_rel, v_pr = problem.rel.valid, problem.priors.valid
    r_rel = torch.where(v_rel[:, None], r_rel, 0.0)
    J1 = torch.where(v_rel[:, None, None], J1, 0.0)
    J2 = torch.where(v_rel[:, None, None], J2, 0.0)
    r_pr = torch.where(v_pr[:, None], r_pr, 0.0)
    J_pr = torch.where(v_pr[:, None, None], J_pr, 0.0)
    J1T, J2T, JpT = J1.transpose(-1, -2), J2.transpose(-1, -2), J_pr.transpose(-1, -2)
    W12 = J1T @ J2
    rows = torch.cat([J1T @ J1, J2T @ J2, JpT @ J_pr, W12, W12.transpose(-1, -2)])
    blocks = dense.gather_sum(tables.by_block, rows.reshape(-1, 36)).reshape(-1, 6, 6)
    g_rows = torch.cat([lie._mv(J1T, r_rel), lie._mv(J2T, r_rel), lie._mv(JpT, r_pr)])
    g = dense.gather_sum(tables.by_pose, g_rows).reshape(-1)

    H = poses.new_zeros((K, 6, K, 6))
    H[tables.block_row, :, tables.block_col, :] = blocks  # distinct blocks: no accumulation
    H = H.reshape(6 * K, 6 * K)
    free = (~problem.fixed_pose_mask)[:, None].expand(-1, 6).reshape(-1)
    H = torch.where(free[:, None] & free[None, :], H, 0.0)
    H = H + torch.diag((torch.diagonal(H) == 0.0).to(H.dtype))
    return H, torch.where(free, g, 0.0)


def lm_functions(problem: PoseGraphProblem, tables: PoseGraphTables):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` over the problem's
    tables: none of them reads the device from the host."""
    fixed = problem.fixed_pose_mask

    def retract(poses, dx):
        return lie.se3_retract(poses, torch.where(fixed[:, None], 0.0, dx.reshape(-1, 6)))

    return (lambda p: pose_graph_cost(problem, p),
            lm.dense_cholesky_step(lambda p: pose_graph_normal_equations(problem, p, tables)),
            retract)


def pose_graph_loop_inputs(problem: PoseGraphProblem, poses0: torch.Tensor,
                           tables: PoseGraphTables) -> tuple:
    """Every tensor the LM loop reads that can differ between two solves of
    one shape: the factors (the measurements, stiffnesses, indices and
    masks, the priors' too), the gauge mask, the tables and the initial
    poses. A later solve of an ``lm.LMGraph`` copies them into the
    captured ones."""
    return (*lm.leaves(problem), *tables, poses0)


def solve_pose_graph(problem: PoseGraphProblem, poses0: torch.Tensor,
                     config: lm.SolveConfig = lm.SolveConfig(),
                     tables: PoseGraphTables | None = None, lm_loop: str | None = None,
                     graph: lm.LMGraph | None = None):
    """LM on the dense tangent system; returns ``(poses, SolveSummary)``.
    The tables are built once here when none are given. ``lm_loop``:
    ``"device"`` (the default on CUDA) runs the loop as one WHILE node,
    kept in ``graph`` (an ``lm.LMGraph``) for the next solve of the same
    shape, which copies its ``pose_graph_loop_inputs`` into this one's
    tensors (they are overwritten); ``"host"`` (the default elsewhere)
    iterates on the host. Both give the same bits."""
    lm_loop = lm.resolve_loop(poses0.device, lm_loop)
    if lm_loop == "host" and graph is not None:
        raise ValueError("an LMGraph keeps the device LM loop: lm_loop='host' takes none")
    tables = pose_graph_tables(problem) if tables is None else tables
    if lm_loop == "host":
        return lm.lm_solve(poses0, config, *lm_functions(problem, tables), loop="host")
    poses0 = poses0.clone()  # the loop's own: a restart copies into it
    return lm.lm_solve(poses0, config, *lm_functions(problem, tables), loop="device",
                       graph=graph, inputs=pose_graph_loop_inputs(problem, poses0, tables))


def pose_graph_covariance(problem: PoseGraphProblem, poses: torch.Tensor, pose_idx: int,
                          tables: PoseGraphTables | None = None) -> torch.Tensor:
    """6x6 tangent marginal covariance of one pose at the solution."""
    H, _ = pose_graph_normal_equations(problem, poses, tables)
    return dense._marginal_block(H, 6 * int(pose_idx))
