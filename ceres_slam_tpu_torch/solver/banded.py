"""Banded Schur-complement preconditioner via block cyclic reduction.

Port of ``ceres_slam_tpu/solver/banded.py``. When feature tracks are
contiguous and bounded (length <= L frames), a landmark couples only poses
within L-1 frames of each other, so the reduced camera matrix
``S = Hpp_damped - U C^{-1} U^T`` is block-banded with block bandwidth L-1.
Grouping L consecutive poses into super-blocks of size m = 6L makes S
block-tridiagonal in super-blocks, which block cyclic reduction factors
and solves in log2(K/L) levels of batched dense [m, m] Cholesky,
triangular-solve and matmul steps.

Landmarks whose observations are not contiguous and bounded are left out
of the banded matrix (their ``-U C^{-1} U^T`` term is negative
semidefinite, so omitting it keeps the preconditioner SPD) and CG makes up
the difference; with every landmark eligible the preconditioner is the
exact inverse and CG converges in one iteration. The factorization is
plain torch (plain XLA in the JAX package) with no host read, so the LM
loop's captured body holds it; a factor that is not positive definite
comes out NaN, as ``jnp.linalg.cholesky`` does, and the LM loop rejects
the step. ``slot_scatter_index`` routes each observation to its
slot for the distributed layer (``parallel/sharded_pcg.py``), which
builds the slot rows from every rank's shard.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.utils import telemetry


class TrackInfo(NamedTuple):
    """Host-built static structure for the banded preconditioner.

    Slot tables address landmarks' observations sorted by pose; ineligible
    landmarks carry zero weights throughout. Landmarks sharing a start pose
    are split into bins of <= BIN_CAP, so the per-bin Gram tensors scale
    with the mean group size, not the largest."""

    L: int  # track-length bound (block bandwidth + 1)
    n_super: int  # number of super-blocks (ceil(K / L), padded even)
    slots: torch.Tensor  # [J, L] observation index of slot o (pose-ascending)
    slot_w: torch.Tensor  # [J, L] 1/0 slot validity (0 for ineligible j)
    start: torch.Tensor  # [J] first pose of the track (0 for ineligible)
    by_bin: torch.Tensor  # [B, BIN_CAP] landmark ids, bin -> one start pose
    by_bin_w: torch.Tensor  # [B, BIN_CAP]
    start_bins: torch.Tensor  # [K, R] bin ids of each start pose
    start_bins_w: torch.Tensor  # [K, R]
    eligible_frac: float  # fraction of landmarks in the band


BIN_CAP = 32


def _track_arrays(pose_idx, point_idx, K: int, J: int, L, L_cap: int):
    """The numpy arrays of ``TrackInfo`` (see ``build_track_info``)."""
    N = pose_idx.shape[0]
    # one composite sort: observations grouped by landmark, pose-ascending
    order = np.argsort(point_idx * K + pose_idx, kind="stable")
    ps = pose_idx[order]
    counts = np.bincount(point_idx, minlength=J)
    starts_csr = np.concatenate([[0], np.cumsum(counts)])
    nonempty = counts > 0

    # contiguity: within a landmark, consecutive sorted poses step by 1
    adj = np.ones(N, bool)
    if N > 1:
        same_j = point_idx[order][1:] == point_idx[order][:-1]
        adj[1:] = ~same_j | (ps[1:] == ps[:-1] + 1)
    eligible = np.zeros(J, bool)
    if N:
        red = np.minimum.reduceat(adj, np.minimum(starts_csr[:-1], N - 1))
        eligible = nonempty & red
    start = np.zeros(J, np.int64)
    start[nonempty] = ps[starts_csr[:-1][nonempty]]
    if L is None:
        el = counts[eligible]
        L = int(min(L_cap, el.max())) if el.size else 1
    eligible &= counts <= L

    # slot table: slots[j, o] = sorted obs o of landmark j (o < counts_j)
    slots = np.zeros((J, L), np.int64)
    slot_w = np.zeros((J, L), np.float32)
    oo = np.arange(L)[None, :]
    valid_slot = eligible[:, None] & (oo < counts[:, None])
    idx = np.minimum(starts_csr[:-1][:, None] + oo, max(0, N - 1))
    slots[valid_slot] = order[idx[valid_slot]]
    slot_w[valid_slot] = 1.0

    # eligible landmarks grouped by start pose, bucketed into bins of <= BIN_CAP
    el_idx = np.nonzero(eligible)[0]
    s_order = el_idx[np.argsort(start[el_idx], kind="stable")]
    cnt_s = np.bincount(start[el_idx], minlength=K)
    s_csr = np.concatenate([[0], np.cumsum(cnt_s)])
    nbins_s = np.maximum(1, -(-cnt_s // BIN_CAP))  # >= 1 bin per pose
    B, R = int(nbins_s.sum()), int(nbins_s.max())
    by_bin = np.zeros((B, BIN_CAP), np.int64)
    by_bin_w = np.zeros((B, BIN_CAP), np.float32)
    start_bins = np.zeros((K, R), np.int64)
    start_bins_w = np.zeros((K, R), np.float32)
    bin_id = 0
    for s in range(K):
        c, base = int(cnt_s[s]), s_csr[s]
        for rbin in range(int(nbins_s[s])):
            lo = rbin * BIN_CAP
            n_here = max(0, min(BIN_CAP, c - lo))
            if n_here:
                by_bin[bin_id, :n_here] = s_order[base + lo: base + lo + n_here]
                by_bin_w[bin_id, :n_here] = 1.0
            start_bins[s, rbin] = bin_id
            start_bins_w[s, rbin] = 1.0
            bin_id += 1

    n_super = -(-K // L)
    if n_super % 2 and n_super > 1:
        n_super += 1  # keep the first reduction level simple
    return (L, n_super, slots, slot_w, start, by_bin, by_bin_w, start_bins, start_bins_w,
            float(eligible.mean() if J else 0.0))


def build_track_info(pose_idx, point_idx, K: int, J: int, L: int | None = None,
                     L_cap: int = 16, valid=None, device="cpu") -> TrackInfo:
    """Analyze the observation structure on the host (numpy, once).

    A landmark is eligible iff its observed poses are distinct, consecutive
    integers (a contiguous track) of length <= L; ``L`` defaults to the
    longest eligible track (capped at ``L_cap``). ``valid`` (the solver's
    observation mask) leaves padding and masked observations out of the
    analysis; the slot table still addresses the original observation array."""
    pose_idx = np.asarray(pose_idx, np.int64)
    point_idx = np.asarray(point_idx, np.int64)
    keep = np.arange(pose_idx.shape[0]) if valid is None else np.nonzero(np.asarray(valid))[0]
    arrays = list(_track_arrays(pose_idx[keep], point_idx[keep], K, J, L, L_cap))
    arrays[2] = keep[arrays[2]] * (arrays[3] > 0)  # slots -> original observation ids
    L, n_super, *tensors, frac = arrays
    return TrackInfo(L, n_super, *(telemetry.to_device(x, device) for x in tensors), frac)


def slot_scatter_index(t: TrackInfo, N: int) -> np.ndarray:
    """Host: each observation's flat slot ``j*L + o``, or the dump row ``J*L``
    for an observation outside every eligible track: the scatter-side dual
    of the ``slots`` gather table, which the distributed preconditioner
    reads (each shard writes its whitened rows to their slots, and one
    all-reduce builds V). Every eligible slot has one observation, so no
    two observations share a slot."""
    slots = t.slots.cpu().numpy()
    w = t.slot_w.cpu().numpy()
    J, L = slots.shape
    out = np.full(N, J * L, np.int32)
    jj, oo = np.nonzero(w > 0)
    out[slots[jj, oo]] = (jj * L + oo).astype(np.int32)
    return out


def build_super_tridiag(b, t: TrackInfo):
    """The super-block tridiagonal of the banded part of S from a
    ``pcg.ObsBlocks``: ``D [n_super, m, m]``, ``E [n_super - 1, m, m]``, m = 6L."""
    from ceres_slam_tpu_torch.solver import pcg

    J = b.Cinv.shape[0]
    # per-landmark whitened slot rows V_j [6L, 3]: slot o's U block times
    # Lc_j (C^{-1} = Lc Lc^T), so the banded part of -U C^{-1} U^T restricted
    # to the track is -V_j V_j^T
    UL18 = pcg.whitened_u18(b)
    V = (UL18[t.slots] * t.slot_w.to(UL18.dtype)[..., None]).reshape(J, t.L * 18)
    return super_tridiag_from_V(V, b.Hpp, t)


def super_tridiag_from_V(V: torch.Tensor, Hpp: torch.Tensor, t: TrackInfo):
    """D/E assembly from the whitened per-landmark slot rows ``V [J, L*18]``
    and the damped pose diagonal ``Hpp [K, 6, 6]``."""
    dtype, device = V.dtype, V.device
    K = Hpp.shape[0]
    L, n_super = t.L, t.n_super
    m = 6 * L

    # bucketed Gram: per bin A = [members*3, m] whitened columns and
    # M_bin = A^T A; bins sum into their start pose
    B, cap = t.by_bin.shape
    Gf = V[t.by_bin] * t.by_bin_w.to(dtype)[..., None]  # [B, cap, L*18]
    A = Gf.reshape(B, cap, m, 3).transpose(2, 3).reshape(B, cap * 3, m)
    M_bin = A.transpose(1, 2) @ A  # [B, m, m]
    M = torch.einsum("krf,kr->kf", M_bin.reshape(B, m * m)[t.start_bins],
                     t.start_bins_w.to(dtype)).reshape(K, m, m)

    # embed each M_s (poses s..s+L-1) into the 2m-wide window of its
    # super-block at offset 6r, r = s mod L, then fold into D/E
    pad_rows = n_super * L - K
    if pad_rows:
        M = torch.cat([M, torch.zeros((pad_rows, m, m), dtype=dtype, device=device)])
        eye = torch.eye(6, dtype=dtype, device=device).expand(pad_rows, 6, 6)
        Hpp = torch.cat([Hpp, eye])
    Mq = M.reshape(n_super, L, m, m)
    win = torch.zeros((n_super, 2 * m, 2 * m), dtype=dtype, device=device)
    for r in range(L):
        win = win + F.pad(Mq[:, r], (6 * r, m - 6 * r, 6 * r, m - 6 * r))

    D = -win[:, :m, :m]
    E = -win[:, :m, m:]
    # straddle: the lower-right quadrant of window q belongs to D_{q+1}
    D[1:] -= win[:-1, m:, m:]
    # pose-diagonal part of S (damped Hpp, with the sun and prior blocks)
    Hq = Hpp.reshape(n_super, L, 6, 6)
    for r in range(L):
        D[:, 6 * r: 6 * r + 6, 6 * r: 6 * r + 6] += Hq[:, r]
    return D, E[:-1]


def ctridiag_factor(D, E):
    """Factor an SPD block-tridiagonal system by cyclic reduction.

    ``D [n, m, m]`` diagonal blocks, ``E [n-1, m, m]`` with row i carrying
    ``E[i] x_{i+1}`` (and row i+1 its transpose). Returns the per-level
    data that ``ctridiag_solve`` takes. No host sync on CUDA (the factors
    applied by triangular solves, as the JAX package's ``cho_solve``
    does): it runs inside the LM loop's CUDA graph."""
    m = D.shape[-1]
    opts = dict(dtype=D.dtype, device=D.device)
    levels = []
    while D.shape[0] > 1:
        n = D.shape[0]
        if n % 2:  # pad to even with an identity block (decoupled)
            D = torch.cat([D, torch.eye(m, **opts)[None]])
            n += 1
        if E.shape[0] < n - 1:  # pad couplings with zeros
            E = torch.cat([E, torch.zeros((n - 1 - E.shape[0], m, m), **opts)])
        Dev, Dod = D[0::2], D[1::2]
        E_eo = E[0::2]  # E_{2i}: even 2i -> odd 2i+1
        E_oe = E[1::2]  # E_{2i+1}: odd 2i+1 -> even 2i+2 (may be short)
        if E_oe.shape[0] < n // 2:
            E_oe = torch.cat([E_oe, torch.zeros((n // 2 - E_oe.shape[0], m, m), **opts)])
        ch = lm._cholesky_or_nan(Dod)
        Y1 = lm.cholesky_apply(ch, E_oe, columns=True)  # D_od^{-1} E_{2i+1}
        Y2 = lm.cholesky_apply(ch, E_eo.transpose(1, 2), columns=True)  # D_od^{-1} E_{2i}^T
        Dnew = Dev - E_eo @ Y2
        Dnew[1:] -= (E_oe.transpose(1, 2) @ Y1)[:-1]
        Enew = -(E_eo @ Y1)[:-1]
        levels.append((ch, E_eo, E_oe, Y1, Y2))
        D, E = Dnew, Enew
    levels.append((lm._cholesky_or_nan(D), None, None, None, None))
    return levels


def ctridiag_solve(levels, b):
    """Solve with a ``ctridiag_factor`` result; ``b [n, m]``. No host sync
    on CUDA (triangular solves, no ``cholesky_solve``): it runs inside the
    CG loop's CUDA graph."""
    m = b.shape[-1]
    opts = dict(dtype=b.dtype, device=b.device)
    # forward reduction: fold odd rows into even rows
    stack = []
    for ch, E_eo, E_oe, _, _ in levels[:-1]:
        if b.shape[0] % 2:
            b = torch.cat([b, torch.zeros((1, m), **opts)])
        b_ev, b_od = b[0::2], b[1::2]
        z = lm.cholesky_apply(ch, b_od)  # D_od^{-1} b_od
        bnew = b_ev - (E_eo @ z[..., None])[..., 0]
        bnew[1:] -= (E_oe.transpose(1, 2) @ z[..., None])[:-1, :, 0]
        stack.append(z)
        b = bnew
    x = lm.cholesky_apply(levels[-1][0], b)
    # back-substitution
    for (_, _, _, Y1, Y2), z in zip(reversed(levels[:-1]), reversed(stack)):
        n2 = z.shape[0]
        x_ev = x
        if x_ev.shape[0] < n2:
            x_ev = torch.cat([x_ev, torch.zeros((n2 - x_ev.shape[0], m), **opts)])
        x_next = torch.cat([x_ev[1:], torch.zeros((1, m), **opts)])
        x_od = z - (Y2 @ x_ev[:n2, :, None])[..., 0] - (Y1 @ x_next[:n2, :, None])[..., 0]
        x = torch.stack([x_ev[:n2], x_od], dim=1).reshape(2 * n2, m)
    return x


def make_banded_precond(b, t: TrackInfo, K: int):
    """Factor the banded part of S; returns ``apply(r) -> M^{-1} r`` for ``r [K, 6]``."""
    return precond_from_tridiag(*build_super_tridiag(b, t), t, K)


def precond_from_tridiag(D, E, t: TrackInfo, K: int):
    """``apply(r) -> M^{-1} r`` for ``r [K, 6]`` from the super-block
    tridiagonal ``D``, ``E`` of ``build_super_tridiag``/``super_tridiag_from_V``."""
    levels = ctridiag_factor(D, E)
    m = 6 * t.L
    n_pad = t.n_super * t.L

    def apply(r: torch.Tensor) -> torch.Tensor:
        rf = F.pad(r.reshape(-1), (0, n_pad * 6 - 6 * K))
        return ctridiag_solve(levels, rf.reshape(t.n_super, m)).reshape(-1)[: K * 6].reshape(K, 6)

    apply.tensors = tuple(x for level in levels for x in level if x is not None)  # what it reads
    return apply
