"""Vertex-Schur linear solver for Phong bundle adjustment.

Port of ``ceres_slam_tpu/solver/phong_schur.py`` (the reference's
SPARSE_NORMAL_CHOLESKY role): each vertex's 6 dof (position, normal)
couple only to the poses, materials and light of its own observations, so
each vertex's 6x6 block is eliminated in closed form (batched Cholesky)
and only the reduced system over ``[6K poses | 3M Phong | M textures | 3
light]`` (``D_r = 6K + 4M + 3``) is factored; the ``[D, D]`` Hessian is
never formed.

The JAX package's slotted assembly reduces with one-hot matrix products
(the TPU's matrix unit). Here every reduction is a gather through a table
that ``build_phong_layout`` builds on the host once per solve, before its
loop (``phong.build_tables``, a pass's widths where given), and a sum
over the table's fixed slot axis: by vertex, by pose, and by (vertex,
pose) pair for the coupling ``W``; the Phong and texture columns of the
intensity rows are an indexed write (one material a row), and the reduced
pose blocks a block-diagonal write. So the card gives the same bits every
run (ROADMAP F14). The Schur correction ``[6J, D_r]^T [6J, D_r]`` is one
plain matrix product in the working precision (TF32 off, F2). The
factors are applied by triangular solves (``lm.cholesky_apply``): the step
never reads the device from the host, so the LM loop's WHILE node can
capture it (``phong.solve_phong_ba(lm_loop="device")``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver.dense import gather_sum
from ceres_slam_tpu_torch.solver.phong import (SCHUR_KEYS, PhongBAProblem, PhongState,
                                               _gathered_terms, build_tables, free_vector)


class PhongLayout(NamedTuple):
    """Gather tables of the valid observations (valid, vertex initialized),
    padded with ``N``, the index of a zero row a sum appends: row j of
    ``by_vertex`` lists vertex j's observations, row k of ``by_pose`` pose
    k's, row ``j K + k`` of ``by_pair`` those of vertex j at pose k."""

    by_vertex: torch.Tensor  # [J, O] int64
    by_pose: torch.Tensor  # [K, P] int64
    by_pair: torch.Tensor  # [J*K, D] int64


def build_phong_layout(problem: PhongBAProblem, widths: dict | None = None) -> PhongLayout:
    """Host-side: group the valid observations by vertex, by pose and by
    (vertex, pose) pair (``phong.build_tables``; the tables live on the
    problem's device), each ``widths[key]`` wide where given (a pass's
    ``phong.table_widths``). Under a capture this raises."""
    t = build_tables(problem, None, keys=SCHUR_KEYS, widths=widths)
    return PhongLayout(*(t[k] for k in SCHUR_KEYS))


def _pad_rows(Jv3, rows: str):
    """``[N, r, 3]`` vertex Jacobian -> ``[N, r, 6]`` at the position or the
    normal columns."""
    z = torch.zeros_like(Jv3)
    return torch.cat([Jv3, z] if rows == "pos" else [z, Jv3], dim=-1)


def _outer(a, b):
    """Per-observation ``a^T b`` of ``[N, r, p]`` and ``[N, r, q]`` -> ``[N, p*q]``."""
    return (a.transpose(1, 2) @ b).reshape(a.shape[0], -1)


def _mask_blocks(free, K, J, Hv, gv, W, Hr, gr):
    """Zero the rows and columns of the dimensions the stage holds fixed
    (``free``: its ``phong.free_vector``)."""
    off_pt = 6 * K
    free_v = torch.cat([free[off_pt:off_pt + 3 * J].reshape(J, 3),
                        free[off_pt + 3 * J:off_pt + 6 * J].reshape(J, 3)], dim=-1)
    free_r = torch.cat([free[:off_pt], free[off_pt + 6 * J:]])
    Hv = torch.where(free_v[:, :, None] & free_v[:, None, :], Hv, 0.0)
    gv = torch.where(free_v, gv, 0.0)
    W = torch.where(free_v[:, :, None] & free_r[None, None, :], W, 0.0)
    Hr = torch.where(free_r[:, None] & free_r[None, :], Hr, 0.0)
    gr = torch.where(free_r, gr, 0.0)
    return Hv, gv, W, Hr, gr


def phong_schur_blocks(problem: PhongBAProblem, state: PhongState, use_light: bool,
                       directional: bool, freeze_geometry: bool,
                       layout: PhongLayout | None = None, free: torch.Tensor | None = None):
    """The block normal equations without the dense ``[D, D]`` H:
    ``(Hv [J, 6, 6], gv [J, 6], W [J, 6, D_r], Hr [D_r, D_r], gr [D_r])``,
    the vertex block ``[position | normal]`` and the reduced vector ``[6K
    poses | 3M Phong | M textures | 3 light]``, masked (diagonal pinning
    happens in the step). Without a ``layout`` or a ``free`` vector they
    are built here (host work: a loop builds them before it)."""
    layout = layout if layout is not None else build_phong_layout(problem)
    free = free_vector(problem, state, use_light, freeze_geometry) if free is None else free
    o = problem.obs
    K, J, M = state.poses.shape[0], state.points.shape[0], state.phong.shape[0]
    N = o.uvd.shape[0]
    R = 4 * M + 3

    st, nr, it, valid = _gathered_terms(problem, state, directional)
    r_st, Jp_st, Jpt_st = st
    Jv = _pad_rows(Jpt_st, "pos")
    # per observation: the vertex block, its gradient, the vertex-pose
    # coupling, the pose block and the pose gradient
    hv, gv_n, tmp = _outer(Jv, Jv), _outer(Jv, r_st[..., None]), _outer(Jv, Jp_st)
    hpp, gp_n = _outer(Jp_st, Jp_st), _outer(Jp_st, r_st[..., None])
    w_rest, cross = [], []  # the intensity rows' [6, R] couplings per observation
    rest_H = state.poses.new_zeros((R, R))
    rest_g = state.poses.new_zeros((R,))
    if use_light:
        r_n, Jp_n, Jn_n = nr
        Jv = _pad_rows(Jn_n, "nrm")
        hv = hv + _outer(Jv, Jv)
        gv_n = gv_n + _outer(Jv, r_n[..., None])
        tmp = tmp + _outer(Jv, Jp_n)
        hpp = hpp + _outer(Jp_n, Jp_n)
        gp_n = gp_n + _outer(Jp_n, r_n[..., None])

        r_i, Jp_i, Jpt_i, Jn_i, Jph_i, Jtex_i, Jl_i = it
        Jv_i = torch.cat([Jpt_i, Jn_i], dim=-1)[:, None, :]  # [N, 1, 6]
        hv = hv + _outer(Jv_i, Jv_i)
        gv_n = gv_n + _outer(Jv_i, r_i[:, None, None])
        tmp = tmp + _outer(Jv_i, Jp_i[:, None, :])
        hpp = hpp + _outer(Jp_i[:, None, :], Jp_i[:, None, :])
        gp_n = gp_n + _outer(Jp_i[:, None, :], r_i[:, None, None])
        # the intensity row over [3M Phong | M textures | 3 light]: each
        # observation's material columns written, the rest zero
        rows = torch.arange(N, device=o.uvd.device)
        row_rest = Jph_i.new_zeros((N, R))
        cols = 3 * o.material_idx[:, None] + torch.arange(3, device=rows.device)
        row_rest[rows[:, None], cols] = Jph_i
        row_rest[rows, 3 * M + o.material_idx] = Jtex_i
        row_rest[:, 4 * M:] = Jl_i
        w_rest = [_outer(Jv_i, row_rest[:, None, :])]
        cross = [_outer(Jp_i[:, None, :], row_rest[:, None, :])]
        row_w = torch.where(valid[:, None], row_rest, 0.0)
        rest_H = row_w.T @ row_w
        rest_g = row_w.T @ torch.where(valid, r_i, 0.0)

    # fixed-order sums through the layout's tables (invalid observations
    # are in no table)
    vert = gather_sum(layout.by_vertex, torch.cat([hv, gv_n, *w_rest], dim=1))
    pose = gather_sum(layout.by_pose, torch.cat([hpp, gp_n, *cross], dim=1))
    Hv = vert[:, :36].reshape(J, 6, 6)
    gv = vert[:, 36:42]
    Hpp, gp = pose[:, :36].reshape(K, 6, 6), pose[:, 36:42]
    W_pose = gather_sum(layout.by_pair, tmp).reshape(J, K, 6, 6).permute(0, 2, 1, 3)
    W_rest = (vert[:, 42:].reshape(J, 6, R) if use_light
              else state.poses.new_zeros((J, 6, R)))
    cross_flat = (pose[:, 42:].reshape(K, 6, R) if use_light
                  else state.poses.new_zeros((K, 6, R))).reshape(6 * K, R)
    W = torch.cat([W_pose.reshape(J, 6, 6 * K), W_rest], dim=-1)

    # the pose blocks on the block diagonal: an indexed write
    Hpp_dense = state.poses.new_zeros((6 * K, 6 * K))
    idx = 6 * torch.arange(K, device=Hpp.device)[:, None] + torch.arange(6, device=Hpp.device)
    Hpp_dense[idx[:, :, None], idx[:, None, :]] = Hpp
    Hr = torch.cat([torch.cat([Hpp_dense, cross_flat], dim=1),
                    torch.cat([cross_flat.T, rest_H], dim=1)], dim=0)
    gr = torch.cat([gp.reshape(-1), rest_g])
    return _mask_blocks(free, K, J, Hv, gv, W, Hr, gr)


def phong_schur_step(problem: PhongBAProblem, use_light: bool, directional: bool,
                     freeze_geometry: bool, layout: PhongLayout | None = None,
                     free: torch.Tensor | None = None):
    """An LM ``step(state, lam) -> (dx, grad_norm, pred_decrease)`` that
    solves the damped normal equations by vertex-block Schur elimination;
    ``dx`` is in ``phong_retract``'s full layout. Without a ``layout`` one
    is built once, here; ``free``: the stage's ``phong.free_vector``
    (without one, built at each call). The factors are applied by
    triangular solves (``lm.cholesky_apply``, JAX's ``cho_solve``): no
    step reads the device from the host, so a captured loop can run it."""
    layout = layout if layout is not None else build_phong_layout(problem)

    def step(state: PhongState, lam):
        K, J = state.poses.shape[0], state.points.shape[0]
        Hv, gv, W, Hr, gr = phong_schur_blocks(problem, state, use_light, directional,
                                               freeze_geometry, layout=layout, free=free)
        Dr = Hr.shape[0]
        # LM damping on the block diagonals, then unit-pin zero diagonals
        dv = torch.diagonal(Hv, dim1=-2, dim2=-1)
        Av = Hv + torch.diag_embed(lam * dv) + torch.diag_embed((dv == 0.0).to(dv.dtype))
        dr = torch.diagonal(Hr)
        Ar = Hr + torch.diag(lam * dr) + torch.diag((dr == 0.0).to(dr.dtype))

        # eliminate the vertex blocks: X = Av^{-1} [W | gv] (Av is SPD by
        # construction; a failed factorization gives NaN, a rejected step)
        X = lm.cholesky_apply(lm._cholesky_or_nan(Av), torch.cat([W, gv[:, :, None]], dim=-1),
                              columns=True)
        Xw, xg = X[:, :, :-1], X[:, :, -1]
        Wf = W.reshape(6 * J, Dr)
        S = Ar - Wf.T @ Xw.reshape(6 * J, Dr)
        g_s = gr - Wf.T @ xg.reshape(-1)
        dxr = lm.cholesky_apply(lm._cholesky_or_nan(S), -g_s)
        dxv = -(xg + (Xw @ dxr[:, None])[..., 0])

        # predicted decrease of the undamped model
        Hdx_v = (Hv @ dxv[..., None])[..., 0] + (W @ dxr[:, None])[..., 0]
        Hdx_r = Hr @ dxr + Wf.T @ dxv.reshape(-1)
        gdx = torch.sum(gv * dxv) + gr @ dxr
        pred = -(gdx + 0.5 * (torch.sum(dxv * Hdx_v) + dxr @ Hdx_r))
        grad_norm = torch.maximum(gv.abs().max(), gr.abs().max())
        dx = torch.cat([dxr[:6 * K], dxv[:, :3].reshape(-1), dxv[:, 3:].reshape(-1),
                        dxr[6 * K:]])
        return dx, grad_norm, pred

    return step


def solve_phong_ba_schur(problem: PhongBAProblem, state0: PhongState,
                         config: lm.SolveConfig = lm.SolveConfig(), use_light: bool = True,
                         directional: bool = False, freeze_geometry: bool = False,
                         layout: PhongLayout | None = None):
    """One LM solve by vertex-Schur elimination: the minimum of
    ``phong.solve_phong_ba``, past the dense solver's size."""
    from ceres_slam_tpu_torch.solver import phong

    return phong.solve_phong_ba(problem, state0, config, use_light, directional,
                                freeze_geometry, linear_solver="schur", layout=layout)
