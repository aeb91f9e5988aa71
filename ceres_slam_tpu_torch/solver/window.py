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
(``ops/window_kernel.window_factor_blocks``) exactly once: the candidate
state's pass is both its cost evaluation and, on acceptance, the next
iteration's normal equations.

The loops are Python loops whose trust-region control (accept test,
damping or radius, termination) runs on the host in float64 on a few
scalars read from the device: one read per LM iteration, two per dogleg
iteration (``solver/dogleg.py``), plus one for the initial cost.

Independent windows of one shape solve together (``BatchLayout``, built by
``problems/batch_scan.py`` for chains in lockstep): the algebra takes a
leading batch axis, one K1 launch serves every window of the batch, and
each window keeps its own trust-region control on the host (a window that
has converged is held fixed with ``torch.where`` while the others go on).
One window alone is the batch of one, so the two give the same bits: every
step of the algebra is written so that a window's arithmetic does not
depend on the leading axis (no 2-D BLAS matrix-vector product, dot or
small 2-D product, whose batched forms round differently on the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import lie, window_kernel
from ceres_slam_tpu_torch.solver import dense, lm


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


def gather_table(ids: np.ndarray, n: int) -> np.ndarray:
    """``[n, D]`` gather table of ``ids [M]`` for ``dense.gather_sum``, built
    on the host: row b lists the positions m with ``ids[m] == b`` in
    increasing order, padded with ``M`` (ids outside ``[0, n)`` are left
    out); ``D`` is the largest count (at least 1)."""
    M = ids.size
    on = np.nonzero((ids >= 0) & (ids < n))[0]
    order = on[np.argsort(ids[on], kind="stable")]
    counts = np.bincount(ids[on], minlength=n)
    rank = np.arange(order.size) - np.concatenate([[0], np.cumsum(counts)])[ids[order]]
    table = np.full((n, max(1, int(counts.max(initial=0)))), M, np.int64)
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


def _layout_host(problem: dense.StereoBAProblem, K: int, J: int, O_pad: int | None):
    """The window's ``WindowHost`` and its observations in slot order
    ``(uvd, stiffness, pose [M], landmark [M], valid [M])`` (host tensors)."""
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
        slot_pose=slot_pose, w_idx=gather_table(slot_pose * J + slot_landmark, K * J),
        pose_slots=gather_table(slot_pose, K), point_valid=point_valid,
        fixed_pose_mask=fixed_pose)
    return host, (uvd, stiff, p_idx, slot_landmark, v)


def window_host(problem: dense.StereoBAProblem, K: int, J: int,
                O_pad: int | None = None) -> WindowHost:
    """The host layout of a window problem (see ``build_window_layout``)."""
    return _layout_host(problem, K, J, O_pad)[0]


def build_window_layout(problem: dense.StereoBAProblem, K: int, J: int,
                        O_pad: int | None = None, device=None) -> WindowLayout:
    """Reorder the valid stereo observations landmark-grouped and pad to
    ``[J, O]`` (``O_pad`` fixes O to a budget), and build K1's plan.
    Host-side numpy; the layout is placed on ``device`` (default: the
    problem's)."""
    st = problem.stereo
    device = device if device is not None else st.uvd.device
    host, (uvd, stiff, p_idx, slot_landmark, v) = _layout_host(problem, K, J, O_pad)

    def put(x, dt=None):
        return torch.as_tensor(x, dtype=dt).to(device)

    stereo = dense.StereoObs(
        uvd=uvd.to(device), stiffness=stiff.to(device), pose_idx=put(p_idx, torch.int64),
        point_idx=put(slot_landmark, torch.int64), valid=put(v),
    )
    return WindowLayout(
        problem=dense.to_device(problem._replace(stereo=stereo), device),
        O=host.O,
        slot_pose=put(host.slot_pose, torch.int64),
        w_idx=put(host.w_idx, torch.int64),
        plan=window_kernel.plan_from_arrays(problem.camera, K, J, host.plan, st.uvd.dtype, device),
        pose_slots=put(host.pose_slots, torch.int64),
    )


class BatchLayout(NamedTuple):
    """B window problems of one shape ``(K, J, O)`` solved together: the
    windows' layouts side by side (window b's slots are ``b*M .. b*M + M-1``),
    the gather tables offset per window (padding: ``B*M``, the zero row a
    sum appends), their sun and prior terms, and K1's plan: a ``BatchPlan``,
    or for one window alone (``as_batch``) its ``WindowPlan``."""

    terms: dense.AuxTerms  # [B, ...]
    K: int
    J: int
    O: int
    slot_pose: torch.Tensor  # [B*M] int64: b*(K+1) + the slot's pose (K for padding)
    w_idx: torch.Tensor  # [B*K*J, D] int64: row (b*K + k)*J + j lists window b's pair (k, j)
    pose_slots: torch.Tensor  # [B*K, P] int64: row b*K + k lists window b's pose k's slots
    plan: object  # window_kernel.BatchPlan, or WindowPlan for one window


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


def build_batch_layout(windows: list, per_window: dict, dtype, device):
    """B windows of one shape as a ``BatchLayout`` and their ``BAState``,
    from the windows' ``WindowHost`` and ``per_window``'s host arrays: the
    state (``poses [B, K, 12]``, ``points [B, J, 3]``) and the sun and prior
    terms (``sun_dir_c``, ``sun_dir_g [B, K, 3]``, ``sun_stiffness [B, K, 2,
    2]``, ``sun_valid [B, K]``, ``prior_T_ref [B, 12]``, ``prior_stiffness
    [B, 6, 6]``, ``prior_valid [B]``, ``sun_huber``, ``az_err_thresh``,
    ``zen_err_thresh [B]``; the prior is on each window's first pose, as the
    sliding window puts it). Everything goes to ``device`` in one
    host-to-device copy."""
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
        prior=dense.PosePrior(0, t["prior_T_ref"], t["prior_stiffness"], t["prior_valid"]),
        fixed_pose_mask=t["fixed_pose_mask"], point_valid=t["point_valid"],
        sun_huber=t["sun_huber"], az_err_thresh=t["az_err_thresh"],
        zen_err_thresh=t["zen_err_thresh"])
    plan = window_kernel.bind_batch_plan([w.camera for w in windows], K, J, t)
    return (BatchLayout(terms, K, J, O, t["slot_pose"], t["w_idx"], t["pose_slots"], plan),
            dense.BAState(t["poses"], t["points"]))


def as_batch(layout: WindowLayout) -> BatchLayout:
    """One window's layout as a batch of one (its tables need no offset)."""
    plan = layout.plan
    return BatchLayout(_lead(dense.aux_terms(layout.problem)), plan.K, plan.J, layout.O,
                       layout.slot_pose, layout.w_idx, layout.pose_slots, plan)


def _lead(x):
    """``x`` with a leading axis of one (through NamedTuples; ints stay)."""
    if isinstance(x, torch.Tensor):
        return x[None]
    if isinstance(x, tuple):
        vals = [_lead(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


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
    plan = layout.plan
    if isinstance(plan, window_kernel.BatchPlan):
        hll, u, gl, hppgp, cost = window_kernel.window_factor_blocks_batch(
            plan, state.poses, state.points)
    else:  # one window alone
        hll, u, gl, hppgp, cost = _lead(window_kernel.window_factor_blocks(
            plan, state.poses[0], state.points[0]))
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
    does), which the loops treat as a rejected step — and no host
    synchronization."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=1e-30))
    L = lm._cholesky_or_nan(S * (s[..., :, None] * s[..., None, :]))

    def solve(b, columns: bool = False):
        if columns:
            return torch.cholesky_solve(b * s[..., :, None], L) * s[..., :, None]
        return torch.cholesky_solve((b * s)[..., None], L)[..., 0] * s

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
    matrix."""
    K = Hpp.shape[-3]
    S, *_ = _schur_reduce(Hpp, Hll, U_jo, w_idx, 0.0)
    E = torch.zeros((6 * K, 6), dtype=S.dtype, device=S.device)
    E[6 * pose_idx: 6 * pose_idx + 6] = torch.eye(6, dtype=S.dtype, device=S.device)
    X = _equilibrated_cho(S)(E, columns=True)
    return X[..., 6 * pose_idx: 6 * pose_idx + 6, :]


def _select(mask: torch.Tensor, new, old):
    """Per window (``mask [B]``): ``new``'s entries where set, else ``old``'s
    (through NamedTuples)."""
    return type(new)(*(torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)
                       for x, y in zip(new, old)))


class _Chains:
    """The host side of B trust-region loops in lockstep: each window's cost,
    nonmonotonic buffer, iteration count, history and done flag (float64
    host scalars, as one window's loop keeps them), and on the device the
    current and the best iterate with their blocks, updated per window
    with ``torch.where``."""

    def __init__(self, config: lm.SolveConfig, state, blocks, cost_t):
        self.config = config
        self.B = cost_t.shape[0]
        self.dtype, self.device = cost_t.dtype, cost_t.device
        self.cost0 = cost_t.tolist()
        self.cost = list(self.cost0)
        self.cost_buf = [[c] * config.nonmonotonic_window for c in self.cost0]
        self.best_cost = list(self.cost0)
        self.it = [0] * self.B
        self.grad_norm = [math.inf] * self.B
        self.active = [config.max_iters > 0] * self.B
        self.histories = [lm.History(config) for _ in range(self.B)]
        self.state, self.blocks = state, blocks
        self.best = (state, blocks)
        self._accept, self._better = [False] * self.B, [False] * self.B

    def accept_test(self, b: int, new_cost: float):
        """Window b's accept decision on ``new_cost``; returns ``(accept, actual)``."""
        cfg = self.config
        actual = self.cost[b] - new_cost
        accept_ref = max(self.cost_buf[b]) if cfg.nonmonotonic else self.cost[b]
        accept = math.isfinite(new_cost) and new_cost < accept_ref
        return accept, actual

    def record(self, b: int, accept: bool, new_cost: float, lam: float, done: bool):
        """Window b's iteration ends: take the step if accepted, keep the
        best, write the history, stop the window if ``done`` or at the
        iteration budget."""
        cfg = self.config
        if accept:
            self.cost[b] = new_cost
            self.cost_buf[b][self.it[b] % cfg.nonmonotonic_window] = new_cost
            self._accept[b] = True
            if new_cost < self.best_cost[b]:
                self.best_cost[b] = new_cost
                self._better[b] = True
        self.histories[b].add(self.it[b], self.cost[b], lam, self.grad_norm[b], accept)
        self.it[b] += 1
        if done or self.it[b] >= cfg.max_iters:
            self.active[b] = False

    def _pick(self, flags: list, new, old):
        if all(flags):
            return new
        if not any(flags):
            return old
        return _select(torch.tensor(flags, device=self.device), new, old)

    def advance(self, new_state, new_blocks):
        """Move every window whose step was accepted to its new iterate."""
        self.state = self._pick(self._accept, new_state, self.state)
        self.blocks = self._pick(self._accept, new_blocks, self.blocks)
        if self.config.nonmonotonic:
            self.best = (self._pick(self._better, new_state, self.best[0]),
                         self._pick(self._better, new_blocks, self.best[1]))
        self._accept, self._better = [False] * self.B, [False] * self.B

    def finish(self, lam: list):
        """``(state, summaries, blocks)``: under nonmonotonic steps each
        window's best iterate (Ceres returns the best minimizer)."""
        state, blocks, cost = self.state, self.blocks, self.cost
        if self.config.nonmonotonic:
            (state, blocks), cost = self.best, self.best_cost
        summaries = [h.summary(it, c0, c, gn, lm_)
                     for h, it, c0, c, gn, lm_ in zip(self.histories, self.it, self.cost0, cost,
                                                      self.grad_norm, lam)]
        return state, summaries, blocks


def blocks_lm_loop(layout: BatchLayout, state0: dense.BAState, config: lm.SolveConfig):
    """Block-carrying Levenberg-Marquardt loops of B windows in lockstep
    (one K1 launch per iteration for all of them; one window alone:
    ``as_batch``), each window with its own damping and stopping rule.
    Returns ``(state, summaries, blocks_at_state)``."""
    terms = layout.terms
    blocks, cost_t = total_blocks(layout, state0)
    ch = _Chains(config, state0, blocks, cost_t)
    lam = [config.init_lambda] * ch.B
    while any(ch.active):
        state, blocks = ch.state, ch.blocks
        Hpp_aux, gp_aux = _masked_aux_blocks(terms, state, ch.dtype)
        lam_t = torch.tensor(lam, dtype=torch.float64).to(ch.device)
        dx, grad_norm_t, pred_t = schur_solve(
            blocks.Hpp + Hpp_aux, blocks.Hll, blocks.U_jo, blocks.gp + gp_aux, blocks.gl,
            layout.w_idx, lam_t)
        dx_ok_t = torch.all(torch.isfinite(dx), dim=-1)
        dx = torch.where(dx_ok_t[:, None], dx, torch.zeros_like(dx))
        new_state = dense._retract_state(terms, state, dx)
        new_blocks, new_cost_t = total_blocks(layout, new_state)
        stats = torch.stack([grad_norm_t, pred_t, new_cost_t, dx_ok_t.to(ch.dtype),
                             dx.abs().amax(dim=-1)], dim=-1).tolist()
        for b, (grad_norm, pred, new_cost, dx_ok, dx_max) in enumerate(stats):
            if not ch.active[b]:
                continue
            ch.grad_norm[b] = grad_norm
            accept, actual = ch.accept_test(b, new_cost)
            rho = actual / max(pred, 1e-30)
            small = accept and actual >= 0.0 and actual <= config.ftol * max(ch.cost[b], 1e-30)
            done = (small or grad_norm <= config.gtol or (dx_ok and dx_max <= 1e-14)
                    or lam[b] >= config.max_lambda)
            if accept:
                lam[b] = max(lam[b] * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
                             config.min_lambda)
            else:
                lam[b] = min(lam[b] * 4.0, config.max_lambda)
            ch.record(b, accept, new_cost, lam[b], done)
        ch.advance(new_state, new_blocks)
    return ch.finish(lam)


def _run_loop_batch(layout: BatchLayout, state0, config, strategy):
    if strategy == "dogleg":
        from ceres_slam_tpu_torch.solver import dogleg

        return dogleg.blocks_dogleg_loop(layout, state0, config)
    if strategy != "lm":
        raise ValueError(f"unknown trust-region strategy: {strategy!r}")
    return blocks_lm_loop(layout, state0, config)


def _run_loop(layout, state0, config, strategy):
    state, summaries, blocks = _run_loop_batch(as_batch(layout), _lead(state0), config, strategy)
    return _first(state), summaries[0], _first(blocks)


def solve_batch_with_covariance(layout: BatchLayout, state0: dense.BAState, pose_idx: int,
                                config: lm.SolveConfig = lm.SolveConfig(), strategy: str = "lm"):
    """Solve B windows together, then each window's 6x6 tangent marginal
    covariance of pose ``pose_idx`` from its final iterate's blocks (float64,
    cast back to the state dtype). Returns ``(state, summaries, cov [B, 6, 6])``."""
    state, summaries, blocks = _run_loop_batch(layout, state0, config, strategy)
    f64 = torch.float64
    Hpp_aux, _ = _masked_aux_blocks(layout.terms, state, f64)
    cov = pose_marginal_covariance(
        blocks.Hpp.to(f64) + Hpp_aux, blocks.Hll.to(f64), blocks.U_jo.to(f64),
        layout.w_idx, pose_idx)
    return state, summaries, cov.to(state.poses.dtype)


def solve_ba_window_with_covariance(problem, state0, pose_idx: int,
                                    config: lm.SolveConfig = lm.SolveConfig(),
                                    strategy: str = "lm", O_pad: int | None = None):
    """Window solve + the 6x6 tangent marginal covariance of pose
    ``pose_idx`` from the final iterate's blocks (float64, cast back to
    the state dtype): the batch of one. Returns ``(state, summary, cov)``."""
    K, J = state0.poses.shape[0], state0.points.shape[0]
    layout = build_window_layout(problem, K, J, O_pad, device=state0.poses.device)
    state, summaries, cov = solve_batch_with_covariance(as_batch(layout), _lead(state0),
                                                        pose_idx, config, strategy)
    return _first(state), summaries[0], cov[0]
