"""Scatter-free explicit-Schur window solver.

Port of ``ceres_slam_tpu/solver/window.py``. Observations are reordered
landmark-grouped and padded to ``[J, O]`` slots (``M = J*O``) on the host,
once per window; every landmark-side reduction is then a contiguous
reshape-sum. The pose side, which the TPU version reduced with one-hot MXU
matmuls, is a gather by each slot's pose, and a sum by pose goes through
the layout's by-pose gather table (``pose_slots``) and a reduction over a
fixed axis, and so does the dense coupling ``W``, through a by-pair table
(``w_idx``): no float sum on the card depends on the order of atomics
(ROADMAP F14). The damped step is

    S = Hpp_d (block diag) - W C^{-1} W^T,   dense Cholesky on S (6K x 6K),
    landmarks back-substituted,

with the Schur reduce, the Cholesky and the covariance in float64 (the
flagship's 1e-12 prior makes S span ~12 orders of magnitude).

Every trust-region iteration runs the K1 factor pass
(``ops/window_kernel.window_factor_blocks_batch``) exactly once: the
candidate state's pass is both its cost evaluation and, on acceptance, the
next iteration's normal equations.

The trust-region loops are the JAX package's ``lax.while_loop``s
(``blocks_lm_loop`` here, ``solver/dogleg.py``'s ``blocks_dogleg_loop``):
the state of B windows solved together is a ``Carry`` of ``[B, ...]``
tensors (the iterate and its blocks, the damping or radius, the cost, the
nonmonotonic buffer, the best iterate, the iteration count, the done flag,
the history), and one iteration of every window (``lm_body``,
``dogleg.dogleg_body``) is a pure function of it whose control is
``torch.where``s: a window that has stopped keeps its values. On CUDA the
loop runs on the card (``loop="device"``): the body, updating the carry in
place, is captured once per shape and run in a conditional WHILE node
(``ops/graph_loop.DeviceWhile``, ``WindowGraph``), its stop test an int32
on the card; the host reads the results once, after the loop. The plain
version (``loop="host"``, the CPU's) iterates the same body on the host
while the test holds, and gives the same bits.

Independent windows of one shape solve together (``BatchLayout``, built by
``problems/batch_scan.py`` for chains in lockstep, and by ``windows_batch``
for one window alone, B = 1): one K1 launch serves every window of the
batch. Every step of the algebra is written so that a window's arithmetic
does not depend on the leading axis (no 2-D BLAS matrix-vector product, dot
or small 2-D product, whose batched forms round differently on the CPU),
so a window gives the same bits alone and in a batch padded alike.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import graph_loop, lie, subspace_kernel, window_kernel
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.utils import device as device_mod


class WindowLayout(NamedTuple):
    """Landmark-grouped observation layout of one window problem.

    ``problem`` carries the stereo observations reordered into ``M = J*O``
    slots (padding slots: valid False, pose 0). ``plan`` holds the K1
    kernel's inputs fixed over the window (slot poses, per-slot records
    with weight = valid & point_valid and pose_free = ~fixed_pose[pose],
    the slots sorted by pose), checked once. ``pose_slots`` lists each
    pose's slots in pose order, padded with ``M`` (the index of a zero row
    that a sum appends), for the fixed-order sums by pose."""

    problem: dense.StereoBAProblem
    O: int
    slot_pose: torch.Tensor  # [M] int64, K for padding slots
    w_idx: torch.Tensor  # [K*J, D] int64: row k*J + j lists pair (k, j)'s slots, padded with M
    plan: window_kernel.WindowPlan
    pose_slots: torch.Tensor | None = None  # [K, P] int64: pose k's slots, padded with M


def gather_table(ids: np.ndarray, n: int, width: int | None = None) -> np.ndarray:
    """``[n, D]`` gather table of ``ids [M]`` for ``dense.gather_sum``, built
    on the host: row b lists the positions m with ``ids[m] == b`` in
    increasing order, padded with ``M`` (ids outside ``[0, n)`` are left
    out); ``D`` is the largest count (at least 1), or ``width`` where one is
    given (a width fixed for a pass: every window of it one shape)."""
    M = ids.size
    on = np.nonzero((ids >= 0) & (ids < n))[0]
    order = on[np.argsort(ids[on], kind="stable")]
    counts = np.bincount(ids[on], minlength=n)
    rank = np.arange(order.size) - np.concatenate([[0], np.cumsum(counts)])[ids[order]]
    D = max(1, int(counts.max(initial=0)))
    if width is not None:
        if D > width:
            raise ValueError(f"gather table width {width} < required {D}")
        D = width
    table = np.full((n, D), M, np.int64)
    table[ids[order], rank] = order
    return table


class WindowHost(NamedTuple):
    """One window's layout on the host: what its solve needs that depends
    on the window's structure alone (not on the state), at a padded shape
    ``(K, J, O)``; ``problems/batch_scan.py`` builds it once per dataset and
    window and stacks B of them (``build_batch_layout``)."""

    camera: object
    K: int
    J: int
    O: int
    plan: dict  # window_kernel.plan_arrays
    slot_pose: np.ndarray  # [M], K for padding slots
    w_idx: np.ndarray  # [K*J, D], padded with M
    pose_slots: np.ndarray  # [K, P], padded with M
    point_valid: np.ndarray  # [J] bool
    fixed_pose_mask: np.ndarray  # [K] bool


def _layout_host(problem: dense.StereoBAProblem, K: int, J: int, O_pad: int | None,
                 widths: tuple | None = None):
    """The window's ``WindowHost`` and its observations in slot order
    ``(uvd, stiffness, pose [M], landmark [M], valid [M])`` (host tensors).
    ``widths``: the by-pair and by-pose tables' widths (default: the
    window's own)."""
    w_pair, w_pose = widths if widths is not None else (None, None)
    st = problem.stereo
    pose_idx = st.pose_idx.cpu().numpy()
    point_idx = st.point_idx.cpu().numpy()
    valid = st.valid.cpu().numpy()

    vrows = np.nonzero(valid)[0]
    order = vrows[np.argsort(point_idx[vrows], kind="stable")]
    counts = np.bincount(point_idx[vrows], minlength=J)
    O = max(1, int(counts.max()))
    if O_pad is not None:
        if O > O_pad:
            raise ValueError(f"O_pad {O_pad} < required slots {O}")
        O = O_pad
    M = J * O
    landmark = point_idx[order]
    rank = np.arange(order.size) - np.concatenate([[0], np.cumsum(counts)])[landmark]
    flat = np.zeros(M, np.int64)
    wf = np.zeros(M, bool)
    flat[landmark * O + rank] = order
    wf[landmark * O + rank] = True

    slot_landmark = np.repeat(np.arange(J), O)
    p_idx = np.where(wf, pose_idx[flat], 0)
    v = wf & valid[flat]
    point_valid = problem.point_valid.cpu().numpy()
    fixed_pose = problem.fixed_pose_mask.cpu().numpy()
    idx = torch.as_tensor(flat)
    uvd = st.uvd.cpu()[idx]
    stiff = st.stiffness.cpu()[idx]
    slot_pose = np.where(wf, pose_idx[flat], K)
    host = WindowHost(
        camera=problem.camera, K=K, J=J, O=O,
        plan=window_kernel.plan_arrays(K, J, np.where(wf, pose_idx[flat], -1), uvd, stiff,
                                       v & point_valid[slot_landmark], ~fixed_pose[p_idx]),
        slot_pose=slot_pose, w_idx=gather_table(slot_pose * J + slot_landmark, K * J, w_pair),
        pose_slots=gather_table(slot_pose, K, w_pose), point_valid=point_valid,
        fixed_pose_mask=fixed_pose)
    return host, (uvd, stiff, p_idx, slot_landmark, v)


def window_host(problem: dense.StereoBAProblem, K: int, J: int, O_pad: int | None = None,
                widths: tuple | None = None) -> WindowHost:
    """The host layout of a window problem (see ``build_window_layout``)."""
    return _layout_host(problem, K, J, O_pad, widths)[0]


def build_window_layout(problem: dense.StereoBAProblem, K: int, J: int,
                        O_pad: int | None = None, device=None,
                        widths: tuple | None = None) -> WindowLayout:
    """Reorder the valid stereo observations landmark-grouped and pad to
    ``[J, O]`` (``O_pad`` fixes O to a budget; ``widths`` the gather tables'
    widths), and build K1's plan. Host-side numpy; the layout, the problem
    and the plan are placed on ``device`` (default: the problem's) in one
    host-to-device copy (``utils/device.upload``)."""
    st = problem.stereo
    device = device if device is not None else st.uvd.device
    host, (uvd, stiff, p_idx, slot_landmark, v) = _layout_host(problem, K, J, O_pad, widths)
    stereo = dense.StereoObs(uvd=uvd, stiffness=stiff, pose_idx=torch.as_tensor(p_idx),
                             point_idx=torch.as_tensor(slot_landmark), valid=torch.as_tensor(v))
    problem = problem._replace(stereo=stereo)
    leaves = [f"problem{i}" for i in range(len(_leaves(problem)))]
    arrays = dict(zip(leaves, (x.cpu().numpy() for x in _leaves(problem))),
                  slot_pose=host.slot_pose, w_idx=host.w_idx, pose_slots=host.pose_slots,
                  **window_kernel.plan_host(host.plan, J, st.uvd.dtype))
    t = device_mod.upload(arrays, device)
    on_device = iter(t[k] for k in leaves)
    return WindowLayout(
        problem=_map(lambda _: next(on_device), problem),
        O=host.O,
        slot_pose=t["slot_pose"],
        w_idx=t["w_idx"],
        plan=window_kernel.bind_plan(problem.camera, K, J, t, host.plan["start"]),
        pose_slots=t["pose_slots"],
    )


class BatchLayout(NamedTuple):
    """B window problems of one shape ``(K, J, O)`` solved together: the
    windows' layouts side by side (window b's slots are ``b*M .. b*M + M-1``),
    the gather tables offset per window (padding: ``B*M``, the zero row a
    sum appends), their sun and prior terms, and K1's batch plan (one
    window alone is a batch of one: ``windows_batch``)."""

    terms: dense.AuxTerms  # [B, ...]
    K: int
    J: int
    O: int
    slot_pose: torch.Tensor  # [B*M] int64: b*(K+1) + the slot's pose (K for padding)
    w_idx: torch.Tensor  # [B*K*J, D] int64: row (b*K + k)*J + j lists window b's pair (k, j)
    pose_slots: torch.Tensor  # [B*K, P] int64: row b*K + k lists window b's pose k's slots
    plan: window_kernel.BatchPlan


def _offset_tables(tables: list, M: int) -> np.ndarray:
    """Per-window gather tables (entries < M, padding M) as one table over
    the B windows' rows: window b's entries moved by b*M, padding B*M, all
    padded to the widest."""
    B = len(tables)
    D = max(t.shape[1] for t in tables)
    out = np.full((B, tables[0].shape[0], D), B * M, np.int64)
    for b, t in enumerate(tables):
        out[b, :, : t.shape[1]] = np.where(t < M, t + b * M, B * M)
    return out.reshape(-1, D)


def build_batch_layout(windows: list, per_window: dict, dtype, device, prior_pose: int = 0):
    """B windows of one shape as a ``BatchLayout`` and their ``BAState``,
    from the windows' ``WindowHost`` and ``per_window``'s host arrays: the
    state (``poses [B, K, 12]``, ``points [B, J, 3]``) and the sun and prior
    terms (``sun_dir_c``, ``sun_dir_g [B, K, 3]``, ``sun_stiffness [B, K, 2,
    2]``, ``sun_valid [B, K]``, ``prior_T_ref [B, 12]``, ``prior_stiffness
    [B, 6, 6]``, ``prior_valid [B]``, ``sun_huber``, ``az_err_thresh``,
    ``zen_err_thresh [B]``; the prior is on each window's pose
    ``prior_pose``, the first as the sliding window puts it). Everything goes
    to ``device`` in one host-to-device copy."""
    from ceres_slam_tpu_torch.utils import device as device_mod

    K, J, O = windows[0].K, windows[0].J, windows[0].O
    if any((w.K, w.J, w.O) != (K, J, O) for w in windows):
        raise ValueError("the windows of a batch must share one shape (K, J, O)")
    M = J * O
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    arrays = {
        **window_kernel.batch_plan_arrays([w.plan for w in windows], J,
                                          [w.camera for w in windows], dtype),
        "slot_pose": np.concatenate([b * (K + 1) + w.slot_pose for b, w in enumerate(windows)]),
        "w_idx": _offset_tables([w.w_idx for w in windows], M),
        "pose_slots": _offset_tables([w.pose_slots for w in windows], M),
        "fixed_pose_mask": np.stack([w.fixed_pose_mask for w in windows]),
        "point_valid": np.stack([w.point_valid for w in windows]),
        **{k: (np.asarray(a, np_dt) if np.asarray(a).dtype.kind == "f" else np.asarray(a))
           for k, a in per_window.items()},
    }
    t = device_mod.upload(arrays, device)
    terms = dense.AuxTerms(
        sun=dense.SunObs(t["sun_dir_c"], t["sun_dir_g"], t["sun_stiffness"], t["sun_valid"]),
        prior=dense.PosePrior(prior_pose, t["prior_T_ref"], t["prior_stiffness"],
                              t["prior_valid"]),
        fixed_pose_mask=t["fixed_pose_mask"], point_valid=t["point_valid"],
        sun_huber=t["sun_huber"], az_err_thresh=t["az_err_thresh"],
        zen_err_thresh=t["zen_err_thresh"])
    plan = window_kernel.bind_batch_plan([w.camera for w in windows], K, J, t)
    return (BatchLayout(terms, K, J, O, t["slot_pose"], t["w_idx"], t["pose_slots"], plan),
            dense.BAState(t["poses"], t["points"]))


def _first(x):
    """Window 0 of a batch of one (through NamedTuples)."""
    return type(x)(*(v[0] for v in x))


class Blocks(NamedTuple):
    """Reduced block system from one factor pass (stereo only; the sun and
    prior pose blocks are added at solve time)."""

    Hpp: torch.Tensor  # [K, 6, 6]
    Hll: torch.Tensor  # [J, 3, 3]
    U_jo: torch.Tensor  # [J, O, 18]
    gp: torch.Tensor  # [K, 6]
    gl: torch.Tensor  # [J, 3]
    stereo_cost: torch.Tensor  # []


def factor_blocks(layout: WindowLayout, state: dense.BAState) -> Blocks:
    """One K1 factor pass -> reduced block system + stereo cost, all views
    of the kernel's outputs (nothing is launched after it)."""
    K, J, O = state.poses.shape[0], state.points.shape[0], layout.O
    hll, u, gl, hppgp, cost = window_kernel.window_factor_blocks(
        layout.plan, state.poses, state.points)
    return Blocks(
        Hpp=hppgp.narrow(1, 0, 36).view(K, 6, 6),
        Hll=hll.view(J, 3, 3),
        U_jo=u.view(J, O, 18),
        gp=hppgp.narrow(1, 36, 6),
        gl=gl,
        stereo_cost=cost,
    )


def factor_blocks_batch(layout: BatchLayout, state: dense.BAState) -> Blocks:
    """One K1 pass over every window of a batch (one launch): the blocks
    with a leading B axis, views of the kernel's outputs."""
    B, K, J, O = state.poses.shape[0], layout.K, layout.J, layout.O
    hll, u, gl, hppgp, cost = window_kernel.window_factor_blocks_batch(
        layout.plan, state.poses, state.points)
    return Blocks(
        Hpp=hppgp.narrow(2, 0, 36).view(B, K, 6, 6),
        Hll=hll.view(B, J, 3, 3),
        U_jo=u.view(B, J, O, 18),
        gp=hppgp.narrow(2, 36, 6),
        gl=gl,
        stereo_cost=cost,
    )


def total_blocks(layout: BatchLayout, state: dense.BAState):
    """``(blocks, total_cost [B])``: one K1 pass plus the sun/prior cost."""
    b = factor_blocks_batch(layout, state)
    return b, b.stereo_cost + dense.aux_cost(layout.terms, state).to(b.stereo_cost.dtype)


def _masked_aux_blocks(problem, state, dtype):
    """Sun + prior pose blocks with gauge masking applied (a fixed pose's
    blocks are exact zeros, whatever its sun or prior terms hold), in
    ``dtype``. ``problem`` is a ``StereoBAProblem`` or ``AuxTerms``."""
    if isinstance(problem, dense.StereoBAProblem):
        problem = dense.aux_terms(problem)
    Hpp_aux, gp_aux = dense.aux_blocks(problem, state)
    return Hpp_aux.to(dtype), gp_aux.to(dtype)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def _pin(H: torch.Tensor) -> torch.Tensor:
    """Unit diagonal for all-zero diagonal blocks (fixed poses, invalid points)."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + torch.where(torch.all(d == 0.0, dim=-1)[..., None, None], eye, 0.0)


def _damp(H: torch.Tensor, lam) -> torch.Tensor:
    """``H + lam diag(H)`` (diagonal clamped); ``lam`` a float, or a tensor
    over ``H``'s leading batch axes (one per window)."""
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-12, 1e32)
    if isinstance(lam, torch.Tensor):
        lam = lam[..., None, None, None]
    return H + lam * torch.diag_embed(d)


def _contract(X: torch.Tensor, w_idx: torch.Tensor, K: int, J: int) -> torch.Tensor:
    """``[..., J, O, 6, 3]`` slot blocks -> dense coupling ``[..., 6K, 3J]``:
    block ``(k, j)`` is the sum of pair (k, j)'s slots, through the layout's
    by-pair table (one slot a pair but for repeated observations)."""
    lead = X.shape[:-4]
    out = dense.gather_sum(w_idx, X.reshape(-1, 18))
    return out.reshape(*lead, K, J, 6, 3).transpose(-3, -2).reshape(*lead, 6 * K, 3 * J)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A [..., m, n] x [..., n]`` as a row sum of products: the BLAS
    product of a matrix and one column rounds differently with and without
    a batch axis on the CPU."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _matvec_t(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A^T x`` for ``A [..., m, n]``, ``x [..., m]`` (as ``_matvec``)."""
    return torch.sum(A * x[..., :, None], dim=-2)


def _schur_reduce(Hpp, Hll, U_jo, w_idx, lam):
    """Pin empty diagonals, damp, eliminate the landmarks. Returns
    ``(S [..., 6K,6K], Cinv [..., J,3,3], Wf [..., 6K,3J], WCf [..., 6K,3J],
    Hpp_pinned, Hll_pinned)``."""
    lead, K, J = Hpp.shape[:-3], Hpp.shape[-3], Hll.shape[-3]
    Hpp = _pin(Hpp)
    Hll_p = _pin(Hll)
    Hpp_d = _damp(Hpp, lam)
    Cinv = _inv3x3(_damp(Hll_p, lam))
    U4 = U_jo.reshape(*lead, J, -1, 6, 3)
    Wf = _contract(U4, w_idx, K, J)
    WCf = _contract(U4 @ Cinv[..., None, :, :], w_idx, K, J)
    S = -(WCf @ Wf.transpose(-1, -2))
    eyeK = torch.eye(K, dtype=S.dtype, device=S.device)
    S = S.reshape(*lead, K, 6, K, 6) + eyeK[:, None, :, None] * Hpp_d[..., :, :, None, :]
    return S.reshape(*lead, 6 * K, 6 * K), Cinv, Wf, WCf, Hpp, Hll_p


def _equilibrated_cho(S: torch.Tensor):
    """Jacobi-equilibrated Cholesky of S ``[..., n, n]``; returns
    ``solve(b)`` = ``S^{-1} b`` for ``b [..., n]`` or, with ``columns=True``,
    ``b [..., n, m]``. A failed factorization gives NaN (as ``jax.scipy``
    does), which the loops treat as a rejected step. The factor is applied
    by two triangular solves (``lm.cholesky_apply``), as the JAX package's
    ``cho_solve`` does: no host synchronization, so a CUDA graph captures
    it."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
    L = lm._cholesky_or_nan(S * (s[..., :, None] * s[..., None, :]))

    def solve(b, columns: bool = False):
        if columns:
            return lm.cholesky_apply(L, b * s[..., :, None], columns=True) * s[..., :, None]
        return lm.cholesky_apply(L, b * s) * s

    return solve


def _quad(v: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """``sum_k v_k^T H_k v_k`` over the last block axis: ``[..., n, d]``, ``[..., n, d, d]``."""
    return torch.sum(v * lie._mv(H, v), dim=(-2, -1))


def schur_solve(Hpp, Hll, U_jo, gp, gl, w_idx, lam):
    """Damped Gauss-Newton step by Schur elimination, computed in float64
    whatever the state dtype, for one window or a batch (leading axes;
    ``lam`` a float or one per window). Returns ``(dx, grad_norm,
    pred_decrease)`` in the input dtype."""
    out_dtype = Hpp.dtype
    f64 = torch.float64
    Hpp, Hll, U_jo, gp, gl = (x.to(f64) for x in (Hpp, Hll, U_jo, gp, gl))
    lead, K, J = Hpp.shape[:-3], Hpp.shape[-3], Hll.shape[-3]
    S, Cinv, Wf, WCf, Hpp_p, Hll_p = _schur_reduce(Hpp, Hll, U_jo, w_idx, lam)
    rhs = -(gp.reshape(*lead, -1) - _matvec(WCf, gl.reshape(*lead, -1)))
    dp = _equilibrated_cho(S)(rhs)
    dl = -lie._mv(Cinv, gl + _matvec_t(Wf, dp).reshape(*lead, J, 3))
    dx = torch.cat([dp, dl.reshape(*lead, -1)], dim=-1)
    grad_norm = torch.maximum(gp.abs().amax(dim=(-2, -1)), gl.abs().amax(dim=(-2, -1)))
    dp_r = dp.reshape(*lead, K, 6)
    g_dot_dx = torch.sum(gp * dp_r, dim=(-2, -1)) + torch.sum(gl * dl, dim=(-2, -1))
    dxHdx = (_quad(dp_r, Hpp_p) + 2.0 * torch.sum(dp * _matvec(Wf, dl.reshape(*lead, -1)), dim=-1)
             + _quad(dl, Hll_p))
    pred = -(g_dot_dx + 0.5 * dxHdx)
    return dx.to(out_dtype), grad_norm.to(out_dtype), pred.to(out_dtype)


def pose_marginal_covariance(Hpp, Hll, U_jo, w_idx, pose_idx: int):
    """6x6 tangent marginal covariance of pose ``pose_idx`` (of each window
    of a batch): the block ``(S^{-1})_kk`` of the undamped reduced camera
    matrix, by two triangular solves against unit columns (no host sync)."""
    K = Hpp.shape[-3]
    S, *_ = _schur_reduce(Hpp, Hll, U_jo, w_idx, 0.0)
    E = torch.zeros((6 * K, 6), dtype=S.dtype, device=S.device)
    E[6 * pose_idx: 6 * pose_idx + 6] = torch.eye(6, dtype=S.dtype, device=S.device)
    X = _equilibrated_cho(S)(E, columns=True)
    return X[..., 6 * pose_idx: 6 * pose_idx + 6, :]


def window_step(layout: WindowLayout, state: dense.BAState, lam):
    """One damped LM linear solve of a window: its K1 pass, the sun and prior
    blocks and the Schur step (``ceres_slam_tpu/solver/window.py::
    window_step``). Returns ``(dx [6K + 3J], grad_norm, pred_decrease)``."""
    b = factor_blocks(layout, state)
    Hpp_aux, gp_aux = _masked_aux_blocks(layout.problem, state, state.poses.dtype)
    return schur_solve(b.Hpp + Hpp_aux, b.Hll, b.U_jo, b.gp + gp_aux, b.gl, layout.w_idx, lam)


def window_marginal_covariance(layout: WindowLayout, state: dense.BAState, pose_idx: int):
    """6x6 tangent marginal covariance of pose ``pose_idx`` at ``state``
    through the window's block system (``ceres_slam_tpu/solver/window.py::
    window_marginal_covariance``), in float64."""
    b = factor_blocks(layout, state)
    Hpp_aux, _ = _masked_aux_blocks(layout.problem, state, torch.float64)
    f64 = torch.float64
    return pose_marginal_covariance(b.Hpp.to(f64) + Hpp_aux, b.Hll.to(f64), b.U_jo.to(f64),
                                    layout.w_idx, pose_idx)


def _select(mask: torch.Tensor, new, old):
    """Per window (``mask [B]``): ``new``'s entries where set, else ``old``'s
    (through NamedTuples)."""
    return type(new)(*(torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                       for x, y in zip(new, old)))


# -- the trust-region loops ----------------------------------------------------

class Carry(NamedTuple):
    """The state of B trust-region loops (the JAX loops' ``Carry``, with a
    leading window axis), every number in the cost's dtype: the iterate
    and its factor blocks, the damping (LM) or trust radius (dogleg)
    ``lam``, the cost, the last gradient norm, the iteration count
    (int32), the done flag, the nonmonotonic buffer of recent accepted
    costs, the best iterate (kept under nonmonotonic steps), the initial
    cost, and with ``record_history`` the per-iteration cost, ``lam``,
    gradient norm and accept flag (``[B, max_iters]``; NaN, False past the
    last iteration)."""

    state: dense.BAState
    blocks: Blocks
    lam: torch.Tensor  # [B]
    cost: torch.Tensor  # [B]
    grad_norm: torch.Tensor  # [B]
    it: torch.Tensor  # [B] int32
    done: torch.Tensor  # [B] bool
    cost_buf: torch.Tensor  # [B, nonmonotonic_window]
    best_state: dense.BAState
    best_blocks: Blocks
    best_cost: torch.Tensor  # [B]
    cost0: torch.Tensor  # [B]
    history: tuple  # ([B, max_iters] x 3, bool [B, max_iters]) or ()


_leaves, _map = lm.leaves, lm.tree_map  # the tensors of a (nested) tuple; fn on each


def loop_start(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
               lam0: float) -> Carry:
    """The carry before the first iteration: one K1 pass on ``state0`` (its
    blocks and cost), ``lam0`` the initial damping or radius."""
    blocks, cost = total_blocks(layout, state0)
    B, dt, dev = cost.shape[0], cost.dtype, cost.device
    history = ()
    if config.record_history:
        nan = torch.full((B, config.max_iters), math.nan, dtype=dt, device=dev)
        history = (nan, nan.clone(), nan.clone(),
                   torch.zeros((B, config.max_iters), dtype=torch.bool, device=dev))
    return Carry(
        state=state0, blocks=blocks, lam=torch.full((B,), lam0, dtype=dt, device=dev),
        cost=cost, grad_norm=torch.full((B,), math.inf, dtype=dt, device=dev),
        it=torch.zeros(B, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        cost_buf=cost[:, None].expand(B, config.nonmonotonic_window).contiguous(),
        best_state=state0, best_blocks=blocks, best_cost=cost, cost0=cost, history=history)


def active(c: Carry, config: lm.SolveConfig) -> torch.Tensor:
    """``[B]`` bool: the windows whose loop goes on (JAX's ``cond``)."""
    return ~c.done & (c.it < config.max_iters)


def advance(c: Carry, config: lm.SolveConfig, on: torch.Tensor, accept: torch.Tensor,
            new_state, new_blocks, new_cost, lam, grad_norm, done) -> Carry:
    """The end of an iteration of the windows ``on`` (the others keep every
    value): take the accepted steps, keep the best iterate, write the
    nonmonotonic buffer and the history at each window's iteration index
    (one-hot ``torch.where``s, no host index), count the iteration."""
    accept = accept & on
    cost = torch.where(accept, new_cost, c.cost)
    W = config.nonmonotonic_window
    slot = torch.arange(W, device=cost.device) == torch.remainder(c.it, W)[:, None]
    best = (c.best_state, c.best_blocks, c.best_cost)
    if config.nonmonotonic:
        better = accept & (new_cost < c.best_cost)
        best = (_select(better, new_state, c.best_state),
                _select(better, new_blocks, c.best_blocks),
                torch.where(better, new_cost, c.best_cost))
    lam = torch.where(on, lam, c.lam)
    history = c.history
    if config.record_history:
        at = on[:, None] & (torch.arange(config.max_iters, device=cost.device)
                            == c.it[:, None].long())
        history = tuple(torch.where(at, v[:, None], h)
                        for h, v in zip(c.history, (cost, lam, grad_norm, accept)))
    return Carry(
        state=_select(accept, new_state, c.state), blocks=_select(accept, new_blocks, c.blocks),
        lam=lam, cost=cost, grad_norm=torch.where(on, grad_norm, c.grad_norm),
        it=c.it + on.to(torch.int32), done=torch.where(on, done, c.done),
        cost_buf=torch.where(accept[:, None] & slot, new_cost[:, None], c.cost_buf),
        best_state=best[0], best_blocks=best[1], best_cost=best[2], cost0=c.cost0,
        history=history)


def accept_test(c: Carry, config: lm.SolveConfig, new_cost, pred):
    """``(accept, actual, rho, small)``: the step's acceptance (against the
    worst recent accepted cost under nonmonotonic steps), the actual and
    relative decrease, and the ftol test, which fires only on a real
    decrease (an accepted uphill step does not end the solve)."""
    actual = c.cost - new_cost
    rho = actual / torch.clamp(pred, min=1e-30)
    ref = c.cost_buf.amax(dim=-1) if config.nonmonotonic else c.cost
    accept = torch.isfinite(new_cost) & (new_cost < ref)
    small = accept & (actual >= 0.0) & (actual <= config.ftol * torch.clamp(c.cost, min=1e-30))
    return accept, actual, rho, small


def lm_body(layout: BatchLayout, config: lm.SolveConfig, c: Carry) -> Carry:
    """One Levenberg-Marquardt iteration of every window still running
    (``ceres_slam_tpu/solver/window.py::blocks_lm_loop``'s body): the damped
    Schur step, one K1 pass on the candidate, the accept test and the
    damping rule. A non-finite step (a failed factorization) is a rejected
    step, not convergence. Pure: ``c`` is left as it was."""
    on = active(c, config)
    Hpp_aux, gp_aux = _masked_aux_blocks(layout.terms, c.state, c.cost.dtype)
    b = c.blocks
    dx, grad_norm, pred = schur_solve(b.Hpp + Hpp_aux, b.Hll, b.U_jo, b.gp + gp_aux, b.gl,
                                      layout.w_idx, c.lam)
    dx_ok = torch.all(torch.isfinite(dx), dim=-1)
    dx = torch.where(dx_ok[:, None], dx, 0.0)
    new_state = dense._retract_state(layout.terms, c.state, dx)
    new_blocks, new_cost = total_blocks(layout, new_state)
    accept, _, rho, small = accept_test(c, config, new_cost, pred)
    lam_down = c.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, torch.clamp(lam_down, min=config.min_lambda),
                      torch.clamp(c.lam * 4.0, max=config.max_lambda))
    done = (small | (grad_norm <= config.gtol) | (dx_ok & (dx.abs().amax(dim=-1) <= 1e-14))
            | (c.lam >= config.max_lambda))
    if config.run_full_budget:
        done = torch.zeros_like(done)
    return advance(c, config, on, accept, new_state, new_blocks, new_cost, lam, grad_norm, done)


def _strategy(strategy: str, config: lm.SolveConfig, init_radius: float):
    """``(body, lam0)`` of a trust-region strategy."""
    if strategy == "dogleg":
        from ceres_slam_tpu_torch.solver import dogleg

        return dogleg.dogleg_body, init_radius
    if strategy != "lm":
        raise ValueError(f"unknown trust-region strategy: {strategy!r}")
    return lm_body, config.init_lambda


def finish(c: Carry, config: lm.SolveConfig):
    """``(state, stats, blocks)`` of a finished loop: under nonmonotonic steps
    each window's best iterate (Ceres returns the best minimizer) with its
    blocks; ``stats [B, 5 (+ 4 max_iters)]`` float64 on the device, the
    per-window summary (``summaries`` reads it)."""
    state, blocks, cost = c.state, c.blocks, c.cost
    if config.nonmonotonic:
        state, blocks, cost = c.best_state, c.best_blocks, c.best_cost
    f64 = torch.float64
    cols = [c.it.to(f64)[:, None], *(x.to(f64)[:, None] for x in (c.cost0, cost, c.grad_norm,
                                                                   c.lam))]
    cols += [h.to(f64) for h in c.history]
    return state, torch.cat(cols, dim=-1), blocks


def summaries(stats, config: lm.SolveConfig) -> list:
    """The ``SolveSummary`` of each window from ``finish``'s stats (a host
    array): iterations, costs, final gradient norm and damping or radius,
    and with ``record_history`` the per-iteration history."""
    stats = np.asarray(stats, dtype=np.float64)
    n = config.max_iters
    out = []
    for row in stats:
        s = lm.SolveSummary(int(row[0]), *(float(x) for x in row[1:5]))
        if config.record_history:
            h = row[5:].reshape(4, n)
            s = s._replace(cost_history=h[0], lambda_history=h[1], grad_norm_history=h[2],
                           step_accepted=h[3] != 0.0)
        out.append(s)
    return out


def host_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
              strategy: str = "lm", init_radius: float = 1e4) -> Carry:
    """The plain version of the loop on the card: the body iterated on the
    host while any window runs (the test read every iteration)."""
    body, lam0 = _strategy(strategy, config, init_radius)
    c = loop_start(layout, state0, config, lam0)
    while bool(torch.any(active(c, config))):
        c = body(layout, config, c)
    return c


class WindowLoop(NamedTuple):
    """What ``DeviceWhile`` captures: ``body()`` runs one iteration of every
    window on the carry buffers ``carry`` in place and writes the stop
    test (``any`` window running) to ``pred`` (int32, 1: run again).
    ``restart()`` puts the buffers at the start of a new solve, from the
    layout's and the initial state's tensors as they are now."""

    carry: Carry
    pred: torch.Tensor  # int32 [1]
    body: object
    restart: object


def window_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
                strategy: str = "lm", init_radius: float = 1e4) -> WindowLoop:
    """The carry buffers and the body of the window loop, on any device (on
    the CPU the tests iterate ``body`` while ``pred``, as the WHILE node
    does)."""
    step, lam0 = _strategy(strategy, config, init_radius)
    carry = _map(torch.clone, loop_start(layout, state0, config, lam0))  # own buffers
    bufs = _leaves(carry)
    pred = torch.any(active(carry, config)).reshape(1).to(torch.int32)

    def copy_in(new):
        for buf, t in zip(bufs, _leaves(new)):
            if t is not buf:
                buf.copy_(t)
        pred.copy_(torch.any(active(carry, config)).reshape(1))

    def body():
        copy_in(step(layout, config, carry))

    def restart():
        copy_in(loop_start(layout, state0, config, lam0))

    return WindowLoop(carry, pred, body, restart)


def loop_inputs(layout: BatchLayout, state0: dense.BAState) -> tuple:
    """Every tensor the window loop reads that changes from one solve to the
    next: the sun and prior terms, the masks, the gather tables, K1's batch
    plan (the kernel reads it by address) and the initial state. A later
    solve copies them into the captured ones (``WindowGraph``)."""
    p = layout.plan
    return (*_leaves(layout.terms), layout.slot_pose, layout.w_idx, layout.pose_slots, p.obs,
            p.pose_idx, p.pose_start, p.obs_by_pose, p.point_by_pose, p.ticket, p.cams,
            state0.poses, state0.points)


def _counted() -> tuple:
    """The kernel wrappers a window loop's body launches."""
    return (window_kernel.window_factor_blocks, window_kernel.window_factor_blocks_batch,
            subspace_kernel.subspace_step)


# the captures and restarts of every WindowGraph of the process, and their host seconds
GRAPH_STATS = {"captures": 0, "capture_s": 0.0, "build_s": 0.0, "restarts": 0, "restart_s": 0.0}


class WindowGraph:
    """Window loops captured once per shape and run for every solve of a
    pass (``problems/batch_scan.BatchSolve`` and ``solve_sliding_window``
    hold one): the first solve of a shape (strategy, configuration, B, K,
    J, O, the tables' widths, dtype) captures its body on its own tensors,
    which the graph then reads by address; a later solve of that shape
    copies its ``loop_inputs`` into those and restarts the loop, with no
    capture and no instantiation (the restart itself is a captured graph,
    replayed). ``close()`` frees every capture. ``GRAPH_STATS`` counts the
    captures and restarts."""

    def __init__(self):
        self.loops: dict = {}

    def close(self) -> None:
        for _, _, node, restart in self.loops.values():
            node.close()
            restart.close()
        self.loops = {}


def _count(**kv) -> None:
    for k, v in kv.items():
        GRAPH_STATS[k] += v


def _copy_inputs(dst: tuple, src: tuple) -> None:
    """A later solve's ``loop_inputs`` into the captured ones: one copy of
    the whole buffer where each side is views of one buffer at the same
    offsets (``build_batch_layout``'s one upload), else tensor by tensor."""
    store_d = {t.untyped_storage().data_ptr() for t in dst}
    store_s = {t.untyped_storage().data_ptr() for t in src}
    if store_d == store_s:
        return
    whole = (len(store_d) == len(store_s) == 1
             and dst[0].untyped_storage().nbytes() == src[0].untyped_storage().nbytes()
             and all(a.storage_offset() * a.element_size() == b.storage_offset() * b.element_size()
                     for a, b in zip(dst, src)))
    if whole:
        def raw(t):
            return torch.empty(0, dtype=torch.uint8, device=t.device).set_(t.untyped_storage())

        raw(dst[0]).copy_(raw(src[0]))
        return
    for d, t in zip(dst, src):
        d.copy_(t)


def _warm_up(step, layout, config, carry) -> None:
    """One iteration of the body, eagerly and discarded, on the capture
    stream before its capture: the libraries it calls (cuBLAS, cuSOLVER)
    make their handles and workspaces there, outside the capture."""
    stream = graph_loop.capture_stream(carry.cost.get_device())
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step(layout, config, carry)
    torch.cuda.current_stream().wait_stream(stream)


def device_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
                strategy: str = "lm", init_radius: float = 1e4,
                graph: WindowGraph | None = None):
    """``host_loop`` on the card: ``window_loop``'s body captured and run in a
    conditional WHILE node, one graph launch for every iteration of every
    window. With a ``graph``, the capture is kept there for the next solve
    of the same shape; without one it is this solve's alone. Returns
    ``finish``'s ``(state, stats, blocks)`` (new tensors). Raises on the
    CPU, and if the capture fails."""
    if state0.poses.device.type != "cuda":
        raise ValueError(f"the device window loop runs on the card, not "
                         f"{state0.poses.device}: use loop='host'")
    own = graph is None
    graph = WindowGraph() if own else graph
    inputs = loop_inputs(layout, state0)
    key = (strategy, config, init_radius, layout.terms.prior.pose_idx,
           tuple((t.shape, t.dtype) for t in inputs))
    try:
        entry = graph.loops.get(key)
        if entry is None:
            lp = window_loop(layout, state0, config, strategy, init_radius)
            _warm_up(_strategy(strategy, config, init_radius)[0], layout, config, lp.carry)
            node = graph_loop.DeviceWhile(lp.body, lp.pred, counted=_counted())
            t0 = time.perf_counter()
            restart = graph_loop.DeviceGraph(lp.restart, node.device, counted=_counted())
            graph.loops[key] = entry = (inputs, lp, node, restart)
            _count(captures=1, capture_s=node.capture_s + time.perf_counter() - t0,
                   build_s=node.build_s)
        else:
            t0 = time.perf_counter()
            _copy_inputs(entry[0], inputs)
            entry[3].replay()
            _count(restarts=1, restart_s=time.perf_counter() - t0)
        entry[2].run()
        state, stats, blocks = finish(entry[1].carry, config)
        return _map(torch.clone, state), stats, _map(torch.clone, blocks)
    finally:
        if own:
            graph.close()


def run_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
             strategy: str = "lm", loop: str | None = None, graph: WindowGraph | None = None,
             init_radius: float = 1e4):
    """The trust-region loops of B windows (``strategy``: ``"lm"`` or
    ``"dogleg"``). ``loop``: ``"device"`` (the CUDA default) runs them in a
    WHILE node on the card (``device_loop``, with ``graph``), ``"host"``
    (the CPU's) in ``host_loop``; the two give the same bits. Returns
    ``(state, stats, blocks_at_state)``, ``stats`` as ``finish`` gives it."""
    loop = loop or ("device" if state0.poses.device.type == "cuda" else "host")
    if loop == "device":
        return device_loop(layout, state0, config, strategy, init_radius, graph)
    if loop != "host":
        raise ValueError(f"unknown trust-region loop: {loop!r}")
    return finish(host_loop(layout, state0, config, strategy, init_radius), config)


def blocks_lm_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig,
                   loop: str | None = None, graph: WindowGraph | None = None):
    """Block-carrying Levenberg-Marquardt loops of B windows in lockstep (one
    K1 launch per iteration for all of them), each window with its own
    damping and stopping rule (``run_loop``). Returns ``(state, stats,
    blocks_at_state)``."""
    return run_loop(layout, state0, config, "lm", loop, graph)


def windows_batch(windows: list, O_pad: int | None = None, widths: tuple | None = None,
                  device=None):
    """Window problems ``[(problem, state)]`` of one shape as one batch
    through ``build_batch_layout``: the layouts, the sun and prior terms and
    the states go to ``device`` (default: the first state's) in one
    host-to-device copy, and a captured loop can take them (K1's batch
    plan). ``O_pad`` and ``widths`` fix the shape for a pass."""
    hosts, per = [], {}
    for problem, state in windows:
        problem = dense.to_device(problem, "cpu")
        t = dense.aux_terms(problem)
        hosts.append(window_host(problem, state.poses.shape[-2], state.points.shape[-2], O_pad,
                                 widths))
        for name, x in (("poses", state.poses), ("points", state.points),
                        ("sun_dir_c", t.sun.dir_c), ("sun_dir_g", t.sun.dir_g),
                        ("sun_stiffness", t.sun.stiffness), ("sun_valid", t.sun.valid),
                        ("prior_T_ref", t.prior.T_ref), ("prior_stiffness", t.prior.stiffness),
                        ("prior_valid", t.prior.valid), ("sun_huber", t.sun_huber),
                        ("az_err_thresh", t.az_err_thresh), ("zen_err_thresh", t.zen_err_thresh)):
            per.setdefault(name, []).append(x.cpu().numpy())
    state = windows[0][1]
    return build_batch_layout(hosts, {k: np.stack(v) for k, v in per.items()},
                              state.poses.dtype, device or state.poses.device,
                              prior_pose=t.prior.pose_idx)


def solve_batch_with_covariance(layout: BatchLayout, state0: dense.BAState, pose_idx: int,
                                config: lm.SolveConfig = lm.SolveConfig(), strategy: str = "lm",
                                loop: str | None = None, graph: WindowGraph | None = None):
    """Solve B windows together (``run_loop``), then each window's 6x6
    tangent marginal covariance of pose ``pose_idx`` from its final
    iterate's blocks (float64, after the loop and outside it, cast back to
    the state dtype). Returns ``(state, stats, cov [B, 6, 6])``, all on the
    device: the caller reads them once (``summaries`` turns ``stats`` into
    ``SolveSummary``s)."""
    state, stats, blocks = run_loop(layout, state0, config, strategy, loop, graph)
    f64 = torch.float64
    Hpp_aux, _ = _masked_aux_blocks(layout.terms, state, f64)
    cov = pose_marginal_covariance(
        blocks.Hpp.to(f64) + Hpp_aux, blocks.Hll.to(f64), blocks.U_jo.to(f64),
        layout.w_idx, pose_idx)
    return state, stats, cov.to(state.poses.dtype)


def solve_ba_window_with_covariance(problem, state0, pose_idx: int,
                                    config: lm.SolveConfig = lm.SolveConfig(),
                                    strategy: str = "lm", O_pad: int | None = None,
                                    loop: str | None = None, graph: WindowGraph | None = None,
                                    widths: tuple | None = None, device=None):
    """Window solve + the 6x6 tangent marginal covariance of pose
    ``pose_idx`` from the final iterate's blocks (float64, cast back to
    the state dtype): the batch of one (``windows_batch``, on ``device``).
    Returns ``(state, summary, cov)``."""
    layout, state = windows_batch([(problem, state0)], O_pad, widths, device)
    state, stats, cov = solve_batch_with_covariance(layout, state, pose_idx, config, strategy,
                                                    loop, graph)
    return _first(state), summaries(stats.cpu(), config)[0], cov[0]


def solve_ba_window(problem, state0, config: lm.SolveConfig = lm.SolveConfig(),
                    strategy: str = "lm", O_pad: int | None = None, loop: str | None = None,
                    graph: WindowGraph | None = None, widths: tuple | None = None,
                    device=None):
    """Trust-region solve of one window with the explicit-Schur window step
    (``ceres_slam_tpu/solver/window.py::solve_ba_window``): ``strategy``
    ``"lm"`` or ``"dogleg"`` (SUBSPACE_DOGLEG); ``loop`` and ``graph`` as
    ``run_loop``'s; on ``device`` (default: the state's). Returns
    ``(state, summary)``."""
    layout, state = windows_batch([(problem, state0)], O_pad, widths, device)
    state, stats, _ = run_loop(layout, state, config, strategy, loop, graph)
    return _first(state), summaries(stats.cpu(), config)[0]
