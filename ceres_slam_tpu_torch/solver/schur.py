"""Schur-complement LM solver: landmark elimination on the block system.

Port of ``ceres_slam_tpu/solver/schur.py`` (Ceres' SPARSE_SCHUR role). The
landmark blocks ``C_j`` are inverted in closed form (batched 3x3), the
reduced camera system

    S = B - W C^-1 W^T        (6K x 6K)

is formed with two products, solved by Cholesky, and the landmark steps are
back-substituted, ``dl_j = C_j^-1 (-gl_j - W_j^T dp)``. The step equals the
dense solver's: the elimination is algebra, not an approximation. The dense
coupling ``W [K, J, 6, 3]`` is ``dense.ba_block_normal_equations``'s, a
fixed-order sum by (pose, landmark) pair; it suits windows and
medium-sized full batches (``solver/pcg.py`` covers the large ones).

Where the JAX module multiplies by the gauge masks, this one selects with
``torch.where`` (ROADMAP F15), and the damped pose blocks are added to S
through a view of its diagonal blocks, with no scatter. The reduced system
is solved by two triangular solves (``lm.cholesky_apply``), so on the card
the LM loop runs as one conditional WHILE node (``solve_ba_schur``) over
the gather tables and the sun and prior terms made before the loop, as
the dense solve's (``dense.minimize``).
"""

from __future__ import annotations

import torch

from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.window import _damp, _inv3x3, _pin


def schur_step(problem: dense.StereoBAProblem, blocks: dense.BlockNormalEq, lam):
    """Solve the damped system by landmark elimination (``lam`` a float or
    a 0-d tensor). Returns ``(dx [6K+3J], grad_norm, pred_decrease)``, the
    predicted decrease of the undamped model computed blockwise (``dx.g +
    0.5 dx.H dx``)."""
    K, J = blocks.Hpp.shape[0], blocks.Hll.shape[0]
    free_pose = ~problem.fixed_pose_mask
    free_pt = problem.point_valid
    Hpp = _pin(torch.where(free_pose[:, None, None], blocks.Hpp, 0.0))
    gp = torch.where(free_pose[:, None], blocks.gp, 0.0)
    Hll = _pin(torch.where(free_pt[:, None, None], blocks.Hll, 0.0))
    gl = torch.where(free_pt[:, None], blocks.gl, 0.0)
    W = torch.where((free_pose[:, None] & free_pt[None, :])[:, :, None, None], blocks.W, 0.0)

    Cinv = _inv3x3(_damp(Hll, lam))
    Wf = W.permute(0, 2, 1, 3).reshape(6 * K, 3 * J)
    WC = torch.einsum("kjab,jbc->kjac", W, Cinv).permute(0, 2, 1, 3).reshape(6 * K, 3 * J)
    S = -WC @ Wf.T
    torch.diagonal(S.view(K, 6, K, 6), dim1=0, dim2=2).add_(_damp(Hpp, lam).permute(1, 2, 0))

    rhs = -(gp.reshape(-1) - WC @ gl.reshape(-1))
    dp = lm.cholesky_apply(lm._cholesky_or_nan(S), rhs)
    dl = -torch.einsum("jab,jb->ja", Cinv, gl + (Wf.T @ dp).reshape(J, 3))

    grad_norm = torch.maximum(gp.abs().max(), gl.abs().max())
    dp_r = dp.reshape(K, 6)
    g_dot_dx = torch.sum(gp * dp_r) + torch.sum(gl * dl)
    dxHdx = (torch.einsum("ka,kab,kb->", dp_r, Hpp, dp_r) + 2.0 * (dp @ (Wf @ dl.reshape(-1)))
             + torch.einsum("ja,jab,jb->", dl, Hll, dl))
    return torch.cat([dp, dl.reshape(-1)]), grad_norm, -(g_dot_dx + 0.5 * dxHdx)


def lm_functions(problem: dense.StereoBAProblem, tables: dense.BlockTables,
                 terms: dense.AuxTerms):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of the Schur solve
    over the solve's gather tables and sun and prior terms: none of them
    reads the device from the host."""
    def step(state, lam):
        return schur_step(problem, dense.ba_block_normal_equations(problem, state, tables, terms),
                          lam)

    cost, _, retract = dense.lm_functions(problem, tables, terms)
    return cost, step, retract


def solve_ba_schur(problem: dense.StereoBAProblem, state0: dense.BAState,
                   config: lm.SolveConfig = lm.SolveConfig(), lm_loop: str | None = None,
                   graph: lm.LMGraph | None = None, widths: tuple | None = None):
    """LM with the Schur-complement linear solver: ``dense.solve_ba``'s
    minimum, cheaper when J >> K. ``lm_loop``, ``graph``, ``widths``:
    ``dense.lm_minimize``'s (on the card the loop is a WHILE node by
    default, elsewhere the host loop: the same bits). Returns ``(state,
    SolveSummary)``."""
    return dense.minimize(problem, state0, config, "schur",
                          lambda t, a: lm_functions(problem, t, a), lm_loop, graph, widths)
