"""Problem containers, the BA cost and the dense Levenberg-Marquardt solve.

Port of ``ceres_slam_tpu/solver/dense.py``. Structure that is fixed for one
problem (camera, Huber parameter, sun thresholds, which pose carries the
prior and whether it is on) is held as Python scalars; everything indexed
by observation, pose or landmark is a tensor.

Every mask is a ``torch.where``, never a product with the mask: an
invalid row may hold an uninitialized landmark at the origin seen from a
pose at the origin (z = 0), whose residual is not finite, and eagerly
``NaN * 0`` is NaN (ROADMAP F9, F15). Sums by pose, landmark or pair go
through a gather table and a reduction over a fixed axis
(``segment_sum``, or ``gather_sum`` through a solve's ``BlockTables``), so
they are bit-reproducible on the card too (F14). The dense solve
(``solve_ba``, LM or Powell's dogleg) is for windows and small batches;
``solver/schur.py`` eliminates the landmarks and ``solver/pcg.py`` covers
full-batch BA. The tangent covariance of a pose is a Cholesky factor
applied to unit columns (``_marginal_block``).

On the card the LM solve runs its loop as one conditional WHILE node
(``lm_minimize(lm_loop="device")``, JAX's ``lax.while_loop``): its body
reads nothing on the host, because the gather tables (``block_tables``)
and the sun and prior terms (``aux_terms``) are made once, before the
loop, and ``dense_loop_inputs`` lists every tensor it reads, which a later
solve of one shape copies into the captured ones (``lm.LMGraph``). The
dogleg strategy (``lm.dogleg_solve``) runs the same way, over the same
tables and terms. ``lm_loop="host"`` (the CPU's form) iterates the same
body on the host: the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors, graph_loop, lie
from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver import loss as loss_mod


class StereoObs(NamedTuple):
    uvd: torch.Tensor  # [N, 3]
    stiffness: torch.Tensor  # [N, 3, 3]
    pose_idx: torch.Tensor  # [N] int
    point_idx: torch.Tensor  # [N] int
    valid: torch.Tensor  # [N] bool


class SunObs(NamedTuple):
    dir_c: torch.Tensor  # [K, 3] observed sun dir, camera frame (unit)
    dir_g: torch.Tensor  # [K, 3] ephemeris sun dir, global frame (unit)
    stiffness: torch.Tensor  # [K, 2, 2]
    valid: torch.Tensor  # [K] bool


class PosePrior(NamedTuple):
    pose_idx: int
    T_ref: torch.Tensor  # [12]
    stiffness: torch.Tensor  # [6, 6]
    valid: bool


class StereoBAProblem(NamedTuple):
    camera: StereoCamera
    stereo: StereoObs
    sun: SunObs
    prior: PosePrior
    fixed_pose_mask: torch.Tensor  # [K] bool — gauge fixing
    point_valid: torch.Tensor  # [J] bool
    sun_huber: float  # 0 => no robust loss
    az_err_thresh: float  # radians
    zen_err_thresh: float  # radians


class BAState(NamedTuple):
    poses: torch.Tensor  # [K, 12]
    points: torch.Tensor  # [J, 3]


def to_device(x, device):
    """Move every tensor of a (nested) NamedTuple to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


def _sun_terms(problem: StereoBAProblem, state: BAState):
    p = problem
    r_sun, J_sun = factors.sun_sensor(
        state.poses, p.sun.dir_c, p.sun.dir_g, p.sun.stiffness,
        az_err_thresh=p.az_err_thresh, zen_err_thresh=p.zen_err_thresh,
    )
    return r_sun, J_sun, torch.sum(r_sun * r_sun, dim=-1)


def _prior_terms(problem: StereoBAProblem, state: BAState):
    pr = problem.prior
    return factors.pose_prior(state.poses[pr.pose_idx], pr.T_ref, pr.stiffness)


def ba_cost_aux(problem: StereoBAProblem, state: BAState) -> torch.Tensor:
    """Sun + prior cost only (the stereo cost comes out of the window factor
    pass). Its gates are Python tests of the problem's settings: a setting
    held as a device tensor is read from the host here (``aux_cost`` of
    ``aux_terms`` selects on the device instead)."""
    r_sun, _, sq = _sun_terms(problem, state)
    rho = loss_mod.huber_rho(sq, problem.sun_huber) if problem.sun_huber > 0.0 else sq
    cost = torch.sum(torch.where(problem.sun.valid, rho, 0.0))
    if problem.prior.valid:
        r_pr, _ = _prior_terms(problem, state)
        cost = cost + torch.sum(r_pr * r_pr)
    return 0.5 * cost


def aux_pose_blocks(problem: StereoBAProblem, state: BAState):
    """Sun + pose-prior contributions to the pose diagonal blocks:
    ``(Hpp_add [K, 6, 6], gp_add [K, 6])``."""
    r_sun, J_sun, sq = _sun_terms(problem, state)
    if problem.sun_huber > 0.0:
        w = loss_mod.huber_weight(sq, problem.sun_huber)
        r_sun, J_sun = r_sun * w[:, None], J_sun * w[:, None, None]
    valid = problem.sun.valid
    r_sun = torch.where(valid[:, None], r_sun, 0.0)
    J_sun = torch.where(valid[:, None, None], J_sun, 0.0)
    Hpp = J_sun.transpose(-1, -2) @ J_sun
    gp = lie._mv(J_sun.transpose(-1, -2), r_sun)
    if problem.prior.valid:
        r_pr, J_pr = _prior_terms(problem, state)
        k = problem.prior.pose_idx
        Hpp[k] += J_pr.T @ J_pr
        gp[k] += J_pr.T @ r_pr
    return Hpp, gp


def _retract_state(problem, state: BAState, dx: torch.Tensor) -> BAState:
    """Apply the tangent step ``dx [..., 6K + 3J]`` (a leading batch axis
    allowed): fixed poses and invalid landmarks stay. ``problem`` is anything
    with ``fixed_pose_mask [..., K]`` and ``point_valid [..., J]``."""
    lead, K = state.poses.shape[:-2], state.poses.shape[-2]
    J = state.points.shape[-2]
    d_pose = torch.where(problem.fixed_pose_mask[..., None], 0.0,
                         dx[..., : 6 * K].reshape(*lead, K, 6))
    d_pt = torch.where(problem.point_valid[..., None], dx[..., 6 * K:].reshape(*lead, J, 3), 0.0)
    return BAState(poses=lie.se3_retract(state.poses, d_pose), points=state.points + d_pt)


class AuxTerms(NamedTuple):
    """The sun and pose-prior terms of a window problem, or of B window
    problems solved together (leading axes ``...``: none, or ``[B]``), with
    the per-problem settings as tensors: the problems of one batch may
    differ in them. Every setting is selected with ``torch.where``, so one
    problem's terms are computed the same way, to the bit, alone or in a
    batch."""

    sun: SunObs  # [..., K, 3], [..., K, 3], [..., K, 2, 2], [..., K]
    prior: PosePrior  # pose_idx int; T_ref [..., 12]; stiffness [..., 6, 6]; valid [...] bool
    fixed_pose_mask: torch.Tensor  # [..., K] bool
    point_valid: torch.Tensor  # [..., J] bool
    sun_huber: torch.Tensor  # [...], 0 = no robust loss
    az_err_thresh: torch.Tensor  # [...] radians
    zen_err_thresh: torch.Tensor  # [...] radians


def aux_terms(problem: StereoBAProblem) -> AuxTerms:
    """One problem's sun and prior terms as ``AuxTerms`` (no leading axis),
    the settings on the problem's device in its dtype. It reads the prior's
    validity on the host and copies the settings to the device: make the
    terms once, before a loop that a CUDA graph captures."""
    dt, dev = problem.sun.dir_c.dtype, problem.sun.dir_c.device
    pr = problem.prior
    valid = torch.tensor(bool(pr.valid), device=dev)
    setting = torch.tensor([problem.sun_huber, problem.az_err_thresh, problem.zen_err_thresh],
                           dtype=dt, device=dev)
    return AuxTerms(problem.sun, pr._replace(T_ref=pr.T_ref.to(dev), stiffness=pr.stiffness.to(dev),
                                             valid=valid),
                    problem.fixed_pose_mask, problem.point_valid, *setting.unbind())


def _aux_residuals(terms: AuxTerms, state: BAState):
    """Sun residuals and Jacobians ``[..., K, 2(, 6)]`` with their squared
    norms, and the prior's ``[..., 1, 6(, 6)]`` on its pose (kept on a pose
    axis of one, so that its products batch the same way with or without a
    leading axis)."""
    sun = terms.sun
    r_sun, J_sun = factors.sun_sensor(
        state.poses, sun.dir_c, sun.dir_g, sun.stiffness,
        az_err_thresh=terms.az_err_thresh[..., None], zen_err_thresh=terms.zen_err_thresh[..., None])
    k = terms.prior.pose_idx
    r_pr, J_pr = factors.pose_prior(state.poses[..., k:k + 1, :], terms.prior.T_ref[..., None, :],
                                    terms.prior.stiffness[..., None, :, :])
    return r_sun, J_sun, torch.sum(r_sun * r_sun, dim=-1), r_pr, J_pr


def aux_cost(terms: AuxTerms, state: BAState) -> torch.Tensor:
    """Sun + prior cost ``[...]`` (``ba_cost_aux`` per problem)."""
    _, _, sq, r_pr, _ = _aux_residuals(terms, state)
    h = terms.sun_huber[..., None]
    rho = torch.where(h > 0.0, loss_mod.huber_rho(sq, h), sq)
    cost = torch.sum(torch.where(terms.sun.valid, rho, 0.0), dim=-1)
    cost = cost + torch.where(terms.prior.valid, torch.sum(r_pr * r_pr, dim=(-2, -1)), 0.0)
    return 0.5 * cost


def aux_blocks(terms: AuxTerms, state: BAState):
    """Sun + prior pose blocks ``(Hpp [..., K, 6, 6], gp [..., K, 6])`` with
    the gauge mask applied: a fixed pose's blocks are exact zeros, whatever
    its sun or prior terms hold (``aux_pose_blocks`` per problem, masked)."""
    r_sun, J_sun, sq, r_pr, J_pr = _aux_residuals(terms, state)
    h = terms.sun_huber[..., None]
    w = torch.where(h > 0.0, loss_mod.huber_weight(sq, h), torch.ones_like(sq))
    r_sun, J_sun = r_sun * w[..., None], J_sun * w[..., None, None]
    valid = terms.sun.valid
    r_sun = torch.where(valid[..., None], r_sun, 0.0)
    J_sun = torch.where(valid[..., None, None], J_sun, 0.0)
    JT = J_sun.transpose(-1, -2)
    Hpp, gp = JT @ J_sun, lie._mv(JT, r_sun)
    k, on = terms.prior.pose_idx, terms.prior.valid
    JT_pr = J_pr.transpose(-1, -2)
    Hpp[..., k, :, :] += torch.where(on[..., None, None], (JT_pr @ J_pr)[..., 0, :, :], 0.0)
    gp[..., k, :] += torch.where(on[..., None], lie._mv(JT_pr, r_pr)[..., 0, :], 0.0)
    free = ~terms.fixed_pose_mask
    return (torch.where(free[..., None, None], Hpp, 0.0), torch.where(free[..., None], gp, 0.0))


def segment_table(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, O]`` gather table of ``idx [N]``: row b lists the rows of bin b
    in increasing order, padded with ``N``; ``O`` is the largest bin (one
    host read). Built on ``idx``'s device: a stable sort, integer counts
    and an indexed write of distinct targets, all deterministic."""
    N = idx.shape[0]
    order = torch.sort(idx, stable=True).indices
    counts = torch.bincount(idx, minlength=n)
    sorted_ids = idx[order]
    rank = torch.arange(N, device=idx.device) - (torch.cumsum(counts, 0) - counts)[sorted_ids]
    table = torch.full((n, max(1, int(counts.max()))), N, dtype=torch.int64, device=idx.device)
    table[sorted_ids, rank] = order
    return table


def gather_sum(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows [N, F]`` summed through a gather table ``[n, D]`` (entries
    ``N`` are padding) -> ``[n, F]``, in a fixed order: a gather (padding
    reads an appended zero row) and a sum over the table's slot axis. No
    float atomics, so the card gives the same bits every run."""
    rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return rows[table].sum(1)


def segment_sum(per_obs: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows of ``per_obs`` into ``n`` bins by ``idx``, in a fixed order
    (``gather_sum`` through ``segment_table``)."""
    rows = per_obs.reshape(per_obs.shape[0], -1)
    return gather_sum(segment_table(idx, n), rows).reshape((n,) + per_obs.shape[1:])


class BlockTables(NamedTuple):
    """The gather tables of ``stereo_block_contrib``'s sums, over the valid
    observations (``stereo_valid``) in increasing row order: by pose, by
    landmark, and by (pose, landmark) pair (bin ``k J + j``). Row b lists
    bin b's rows, padded with ``N``, which reads the zero row
    ``gather_sum`` appends."""

    pose: torch.Tensor  # [K, Dp]
    point: torch.Tensor  # [J, Dl]
    pair: torch.Tensor  # [K J, Dw]


def block_tables(problem: StereoBAProblem, widths: tuple | None = None) -> BlockTables:
    """The problem's ``BlockTables`` on its device, ``widths`` ``(pose,
    landmark, pair)`` wide where given (a pass's: every window of it one
    shape), else as wide as the largest bin. A host round trip: a solve
    builds them before its loop, and under a capture this raises."""
    from ceres_slam_tpu_torch.solver.window import gather_table

    graph_loop.not_in_capture("building the dense gather tables", "dense.solve_ba")
    st = problem.stereo
    K, J = problem.fixed_pose_mask.shape[0], problem.point_valid.shape[0]
    valid = stereo_valid(problem).cpu().numpy()
    k = np.where(valid, st.pose_idx.cpu().numpy(), -1)
    j = np.where(valid, st.point_idx.cpu().numpy(), -1)
    ids = ((k, K), (j, J), (np.where(valid, k * J + j, -1), K * J))
    widths = widths or (None,) * 3
    return BlockTables(*(torch.as_tensor(gather_table(i, n, w)).to(st.uvd.device)
                         for (i, n), w in zip(ids, widths)))


def stereo_valid(problem: StereoBAProblem) -> torch.Tensor:
    """``[N]`` bool: the observation is valid and its landmark initialized."""
    return problem.stereo.valid & problem.point_valid[problem.stereo.point_idx]


def stereo_sq_sum(problem: StereoBAProblem, state: BAState) -> torch.Tensor:
    """``sum |r|^2`` over the valid stereo rows (whitened residuals)."""
    st = problem.stereo
    p_c = lie.se3_transform_point(state.poses[st.pose_idx], state.points[st.point_idx])
    r = lie._mv(st.stiffness, problem.camera.project(p_c) - st.uvd)
    sq = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(stereo_valid(problem), sq, torch.zeros_like(sq)))


def ba_cost(problem: StereoBAProblem, state: BAState, terms: AuxTerms | None = None
            ) -> torch.Tensor:
    """Total cost ``1/2 sum rho(|r|^2)`` (stereo + sun + prior), Ceres's objective.
    With ``terms`` (``aux_terms(problem)``, made once, outside a loop) the
    sun and prior settings are tensors selected with ``torch.where``, so the
    cost never reads the device from the host, whatever the problem holds
    (a captured loop's cost, ``solver/pcg.py``)."""
    aux = ba_cost_aux(problem, state) if terms is None else aux_cost(terms, state)
    return 0.5 * stereo_sq_sum(problem, state) + aux


class BlockNormalEq(NamedTuple):
    """Block-sparse Gauss-Newton system: pose blocks, landmark blocks, the
    dense pose-landmark coupling ``W`` and the gradients."""

    Hpp: torch.Tensor  # [K, 6, 6]
    Hll: torch.Tensor  # [J, 3, 3]
    W: torch.Tensor  # [K, J, 6, 3]
    gp: torch.Tensor  # [K, 6]
    gl: torch.Tensor  # [J, 3]


def stereo_block_contrib(camera: StereoCamera, stereo: StereoObs, point_valid: torch.Tensor,
                         state: BAState, tables: BlockTables | None = None) -> BlockNormalEq:
    """Stereo-factor contribution in block form (fixed-order sums by pose,
    by landmark and by (pose, landmark) pair) through ``tables``
    (``block_tables``, built before a loop), or through tables of every
    row built here (``segment_table``, a host read) where none are given."""
    K, J = state.poses.shape[0], state.points.shape[0]
    r, J_pose, J_pt = factors.stereo_reprojection(
        camera, state.poses[stereo.pose_idx], state.points[stereo.point_idx], stereo.uvd,
        stereo.stiffness)
    valid = stereo.valid & point_valid[stereo.point_idx]
    r = torch.where(valid[:, None], r, torch.zeros_like(r))
    J_pose = torch.where(valid[:, None, None], J_pose, torch.zeros_like(J_pose))
    J_pt = torch.where(valid[:, None, None], J_pt, torch.zeros_like(J_pt))
    JpT, JlT = J_pose.transpose(1, 2), J_pt.transpose(1, 2)
    if tables is None:
        tables = BlockTables(segment_table(stereo.pose_idx, K),
                             segment_table(stereo.point_idx, J),
                             segment_table(stereo.pose_idx * J + stereo.point_idx, K * J))

    def seg(x, t):
        return gather_sum(t, x.reshape(x.shape[0], -1)).reshape((t.shape[0],) + x.shape[1:])

    return BlockNormalEq(
        Hpp=seg(JpT @ J_pose, tables.pose),
        Hll=seg(JlT @ J_pt, tables.point),
        W=seg(JpT @ J_pt, tables.pair).reshape(K, J, 6, 3),
        gp=seg(lie._mv(JpT, r), tables.pose),
        gl=seg(lie._mv(JlT, r), tables.point),
    )


def blocks_to_dense(blocks: BlockNormalEq):
    """The dense tangent ``(H [D, D], g [D])`` of the block system, pose k at
    rows ``6k..6k+5`` and landmark j at ``6K + 3j..6K + 3j + 2``. The
    diagonal blocks are written through a view of the diagonal blocks of
    ``H``: a fixed number of copies, whatever K and J."""
    K, J = blocks.Hpp.shape[0], blocks.Hll.shape[0]
    H = torch.zeros((6 * K + 3 * J, 6 * K + 3 * J), dtype=blocks.Hpp.dtype,
                    device=blocks.Hpp.device)
    torch.diagonal(H[: 6 * K, : 6 * K].view(K, 6, K, 6), dim1=0, dim2=2).copy_(
        blocks.Hpp.permute(1, 2, 0))
    torch.diagonal(H[6 * K:, 6 * K:].unflatten(0, (J, 3)).unflatten(2, (J, 3)),
                   dim1=0, dim2=2).copy_(blocks.Hll.permute(1, 2, 0))
    W = blocks.W.permute(0, 2, 1, 3).reshape(6 * K, 3 * J)
    H[: 6 * K, 6 * K:] = W
    H[6 * K:, : 6 * K] = W.T
    return H, torch.cat([blocks.gp.reshape(-1), blocks.gl.reshape(-1)])


def ba_block_normal_equations(problem: StereoBAProblem, state: BAState,
                              tables: BlockTables | None = None,
                              terms: AuxTerms | None = None) -> BlockNormalEq:
    """Full block-sparse Gauss-Newton system (stereo + sun + prior). With
    ``tables`` (``block_tables``) and ``terms`` (``aux_terms``), both made
    once before a loop, it never reads the device from the host (the
    terms' pose blocks are gauge-masked: a fixed pose's are zeros)."""
    blocks = stereo_block_contrib(problem.camera, problem.stereo, problem.point_valid, state,
                                  tables)
    Hpp_aux, gp_aux = (aux_pose_blocks(problem, state) if terms is None
                       else aux_blocks(terms, state))
    return blocks._replace(Hpp=blocks.Hpp + Hpp_aux, gp=blocks.gp + gp_aux)


def apply_gauge_mask(problem: StereoBAProblem, H: torch.Tensor, g: torch.Tensor):
    """Constant-parameter masking (zero rows and columns of fixed poses and
    invalid landmarks) and a unit diagonal wherever the diagonal is zero —
    the tangent equivalent of ``SetParameterBlockConstant``."""
    free = torch.cat([(~problem.fixed_pose_mask)[:, None].expand(-1, 6).reshape(-1),
                      problem.point_valid[:, None].expand(-1, 3).reshape(-1)])
    H = torch.where(free[:, None] & free[None, :], H, 0.0)
    diag = torch.diagonal(H)
    return H + torch.diag((diag == 0.0).to(H.dtype)), torch.where(free, g, 0.0)


def ba_normal_equations(problem: StereoBAProblem, state: BAState,
                        tables: BlockTables | None = None, terms: AuxTerms | None = None):
    """The gauge-masked dense tangent normal equations ``(H, g)``
    (``tables``, ``terms``: ``ba_block_normal_equations``')."""
    H, g = blocks_to_dense(ba_block_normal_equations(problem, state, tables, terms))
    return apply_gauge_mask(problem, H, g)


def lm_functions(problem: StereoBAProblem, tables: BlockTables, terms: AuxTerms):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of the dense solve
    over the solve's ``tables`` and ``terms``: none of them reads the device
    from the host, so the device loop can capture them."""
    def normal_eq(s):
        return ba_normal_equations(problem, s, tables, terms)

    def cost(s):
        return ba_cost(problem, s, terms)

    def retract(s, dx):
        return _retract_state(problem, s, dx)

    return cost, lm.dense_cholesky_step(normal_eq), retract


def dogleg_functions(problem: StereoBAProblem, tables: BlockTables, terms: AuxTerms):
    """The dogleg loop's ``(cost_fn, normal_eq_fn, retract_fn)`` over the
    solve's ``tables`` and ``terms`` (``lm_functions``' with the normal
    equations in the step's place)."""
    cost, _, retract = lm_functions(problem, tables, terms)
    return cost, lambda s: ba_normal_equations(problem, s, tables, terms), retract


def dense_loop_inputs(problem: StereoBAProblem, state0: BAState, terms: AuxTerms,
                      tables: BlockTables) -> tuple:
    """Every tensor the LM loop of the dense or Schur solve reads that can
    differ between two solves of one shape: the observations, the gauge
    and landmark masks, the sun and prior terms, the gather tables and the
    initial state. A later solve of an ``lm.LMGraph`` copies them into the
    captured ones."""
    return (*lm.leaves(problem.stereo), problem.fixed_pose_mask, problem.point_valid,
            *lm.leaves(terms), *tables, state0.poses, state0.points)


def loop_key(problem: StereoBAProblem, solver: str) -> tuple:
    """What the device LM loop's body holds as Python values (beside the
    inputs' shapes): the linear solver, the camera and the prior's pose."""
    return (solver, problem.camera, int(problem.prior.pose_idx))


def minimize(problem: StereoBAProblem, state0: BAState, config: lm.SolveConfig, solver: str,
             functions, lm_loop: str | None, graph: lm.LMGraph | None, widths: tuple | None,
             run=lm.lm_solve):
    """The LM solve of the dense (``solver="dense"``) or Schur solver, or
    with ``run=lm.dogleg_solve`` the dense dogleg (``solver="dogleg"``):
    ``functions(tables, terms)`` gives the loop's functions over the
    gather tables (``widths`` wide) and the sun and prior terms, both made
    here, once, before the loop. ``lm_loop``, ``graph``: ``lm_minimize``'s."""
    name = "dogleg loop" if solver == "dogleg" else "LM loop"
    lm_loop = lm.resolve_loop(state0.poses.device, lm_loop, name)
    if lm_loop == "host" and graph is not None:
        raise ValueError(f"an LMGraph keeps the device {name}: lm_loop='host' takes none")
    tables = block_tables(problem, widths)
    terms = aux_terms(problem)
    if lm_loop == "host":
        return run(state0, config, *functions(tables, terms), loop="host")
    state0 = lm.tree_map(torch.clone, state0)  # the loop's own: a restart copies into it
    return run(state0, config, *functions(tables, terms), loop="device", graph=graph,
               inputs=dense_loop_inputs(problem, state0, terms, tables),
               key=loop_key(problem, solver))


def lm_minimize(problem: StereoBAProblem, state0: BAState, config: lm.SolveConfig,
                lm_loop: str | None = None, graph: lm.LMGraph | None = None,
                widths: tuple | None = None):
    """LM with the dense damped Cholesky step of the normal equations.
    ``lm_loop``: ``"device"`` (the default on CUDA) runs the loop as one
    WHILE node on the card (``lm.device_loop``), kept in ``graph`` (an
    ``lm.LMGraph``) for the next solve of the same shape, which copies its
    ``dense_loop_inputs`` into this one's tensors (they are overwritten)
    and restarts it; ``"host"`` (the default elsewhere) iterates on the
    host and takes no ``graph``. Both give the same bits. ``widths``: the
    gather tables' (``block_tables``), a pass's."""
    return minimize(problem, state0, config, "dense", lambda t, a: lm_functions(problem, t, a),
                    lm_loop, graph, widths)


def solve_ba(problem: StereoBAProblem, state0: BAState,
             config: lm.SolveConfig = lm.SolveConfig(), strategy: str = "lm",
             lm_loop: str | None = None, graph: lm.LMGraph | None = None,
             widths: tuple | None = None):
    """Minimize the BA cost on the dense system (``ceres::Solve`` with
    DENSE_SCHUR's role at window scale): ``strategy`` ``'lm'``
    (Levenberg-Marquardt) or ``'dogleg'`` (Powell's dogleg, the reference's
    ceres::DOGLEG, ``lm.dogleg_solve``); for both, ``lm_loop``, ``graph``
    and ``widths`` are ``lm_minimize``'s: the loop runs as one WHILE node
    on the card by default, on the host with ``lm_loop="host"``. Returns
    ``(state, SolveSummary)``."""
    if strategy == "dogleg":
        return minimize(problem, state0, config, "dogleg",
                        lambda t, a: dogleg_functions(problem, t, a), lm_loop, graph, widths,
                        run=lm.dogleg_solve)
    if strategy != "lm":
        raise ValueError(f"unknown strategy: {strategy!r}")
    return lm_minimize(problem, state0, config, lm_loop=lm_loop, graph=graph, widths=widths)


def _marginal_block(H: torch.Tensor, base: int, d: int = 6) -> torch.Tensor:
    """``(H^-1)[base:base+d, base:base+d]``: the Cholesky factor applied to
    the ``d`` unit columns ``base..base+d-1`` by two triangular solves
    (``lm.cholesky_apply``, which a captured loop can run); all NaN when
    ``H`` is not positive definite."""
    E = torch.zeros((H.shape[0], d), dtype=H.dtype, device=H.device)
    E[base:base + d] = torch.eye(d, dtype=H.dtype, device=H.device)
    return lm.cholesky_apply(lm._cholesky_or_nan(H), E, columns=True)[base:base + d]


def solve_ba_with_covariance(problem: StereoBAProblem, state0: BAState, pose_idx: int,
                             config: lm.SolveConfig = lm.SolveConfig()):
    """The LM solve, then the tangent covariance of pose ``pose_idx`` at the
    solution: ``(state, SolveSummary, cov [6, 6])``."""
    sol, summary = lm_minimize(problem, state0, config)
    return sol, summary, pose_tangent_covariance(problem, sol, pose_idx)


def pose_tangent_covariance(problem: StereoBAProblem, state: BAState,
                            pose_idx: int) -> torch.Tensor:
    """6x6 tangent marginal covariance of one pose (Ceres'
    ``GetCovarianceBlockInTangentSpace``): its diagonal block of ``H^-1``,
    ``H`` the gauge-masked Gauss-Newton Hessian at ``state``."""
    H, _ = ba_normal_equations(problem, state)
    return _marginal_block(H, 6 * int(pose_idx))
