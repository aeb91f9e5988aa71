"""Plain reference of the RANSAC VO initial guess: of a stereo track, as
``dataset_vo`` starts its full batch, and of a Phong track.

For every consecutive pair of states the landmarks (vertices) seen in both
are matched by id and triangulated in each camera; 3-point hypotheses (for
Phong ``draw``, a frozen copy of the JAX package's threefry draw, so that
both sides get the same hypotheses; for a stereo track the benchmark's own
draw, injected into the program) are fitted by the closed-form rigid
alignment (Kabsch / Umeyama, the proper rotation of the SVD of the
cross-covariance), each scored by the matches whose squared reprojected (u,
v, d) error is below the threshold, and the first hypothesis with the most
inliers is kept as it is. The pose chain compounds them from the first
pose. A stereo chain stops at the first pair with fewer than three matches
or inliers (the later poses stay the identity); in a Phong chain such a pair
keeps the previous pose. A landmark is initialized by the first pair whose
inliers hold it, from its triangulation (and, Phong, its observed normal) in
the pair's first camera; a material starts at ``(0, 0, 1)``, its texture at
the upper median of its observed intensities. Plain torch and numpy, in
float64.
"""

from __future__ import annotations


import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (x[0] + x[1]) & _MASK
            b = ((x[1] << r) | (x[1] >> (32 - r))) & _MASK
            x = [a, a ^ b]
        x = [(x[0] + ks[(i + 1) % 3]) & _MASK, (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK]
    return x


def draw(valid: torch.Tensor, num_iters: int, seeds: torch.Tensor) -> torch.Tensor:
    """``[B, P]`` validity and ``[B]`` seeds -> ``[B, num_iters, 3]``: the
    three valid entries with the largest high 23 bits of
    ``jax.random.bits(PRNGKey(seed), (num_iters, P))`` (the first on ties),
    the picks of the JAX package's Gumbel top three."""
    B, P = valid.shape
    n = num_iters * P
    seeds = seeds.to(torch.int64).to(valid.device)
    k1, k2 = (seeds >> 32)[:, None], (seeds & _MASK)[:, None]
    counts = torch.arange(n, dtype=torch.int64, device=valid.device)[None, :]
    y1, y2 = _threefry(k1, k2, torch.zeros_like(counts), counts)
    keys = ((y1 ^ y2) >> 9).reshape(B, num_iters, P)
    keys = torch.where(valid[:, None, :], keys, -1)
    picks = []
    for _ in range(3):
        i = keys.argmax(-1, keepdim=True)
        picks.append(i)
        keys = keys.scatter(-1, i, -1)
    return torch.cat(picks, -1)


def triangulate(camera, uvd):
    fu, fv, cu, cv, b = camera
    z = fu * b / uvd[..., 2]
    return np.stack([(uvd[..., 0] - cu) * z / fu, (uvd[..., 1] - cv) * z / fv, z], -1)


def _project(camera, p):
    fu, fv, cu, cv, b = camera
    return torch.stack([fu * p[..., 0] / p[..., 2] + cu, fv * p[..., 1] / p[..., 2] + cv,
                        fu * b / p[..., 2]], -1)


def ransac(camera, pts0, pts1, valid, hyp, thresh: float):
    """``[B, P, 3]`` matched points of each pair in its two cameras, ``[B,
    P]`` validity, ``[B, H, 3]`` hypotheses -> ``(R [B, 3, 3], t [B, 3],
    inliers [B, P])`` of the first best hypothesis."""
    B, H = hyp.shape[:2]
    idx = hyp.reshape(B, H * 3, 1).expand(B, H * 3, 3)
    a = torch.gather(pts0, 1, idx).reshape(B, H, 3, 3)
    b = torch.gather(pts1, 1, idx).reshape(B, H, 3, 3)
    ca, cb = a.mean(2), b.mean(2)
    W = (b - cb[:, :, None]).transpose(-1, -2) @ (a - ca[:, :, None]) / 3.0
    U, _, Vh = torch.linalg.svd(W)
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vh
    t = cb - (R @ ca[..., None])[..., 0]
    moved = torch.einsum("bhij,bpj->bhpi", R, pts0) + t[:, :, None, :]
    err = ((_project(camera, pts1)[:, None] - _project(camera, moved)) ** 2).sum(-1)
    inl = (err < thresh) & valid[:, None, :]
    best = inl.sum(-1).argmax(-1)
    rows = torch.arange(B, device=hyp.device)
    return R[rows, best], t[rows, best], inl[rows, best]


def ransac_pairs(camera, pts_c, pairs, hyp, thresh: float, device, block: int = 128):
    """RANSAC of every pair ``pairs[k] = (rows at k-1, rows at k)`` (index 0
    unused) on ``hyp [K, H, 3]``, in blocks of pairs, in the precision of
    ``pts_c``: numpy ``(R [K, 3, 3], t [K, 3], inliers [K, P])``."""
    K = len(pairs)
    width = max([1] + [p[0].size for p in pairs[1:]])
    P = max(64, -(-width // 64) * 64)
    p0, p1 = np.zeros((K, P, 3), pts_c.dtype), np.zeros((K, P, 3), pts_c.dtype)
    ok = np.zeros((K, P), bool)
    for k in range(1, K):
        ia, ib = pairs[k]
        p0[k, :ia.size], p1[k, :ia.size], ok[k, :ia.size] = pts_c[ia], pts_c[ib], True
    dev = torch.device(device)
    out = []
    for s in range(0, K, block):
        put = lambda x: torch.as_tensor(x[s:s + block], device=dev)  # noqa: E731
        out.append([x.cpu().numpy() for x in ransac(camera, put(p0), put(p1), put(ok),
                                                    put(np.asarray(hyp)), thresh)])
    return tuple(np.concatenate(x) for x in zip(*out))


def chain(pairs, R, t, inl, T0, ids, J: int, stop_short: bool):
    """Compound the pairs' alignments from ``T0 [12]``: ``(poses [K, 12],
    row [J], prev [J])``, for each landmark the observation row (in the
    pair's first camera) and the pose before the pair whose inliers first
    hold it (-1: never). ``stop_short``: stop at the first pair with fewer
    than three matches or inliers (else such a pair keeps the pose). In the
    precision of ``R``."""
    K = len(pairs)
    poses = np.tile(np.concatenate([np.zeros(3), np.eye(3).ravel()]), (K, 1)).astype(R.dtype)
    poses[0] = T0
    T0 = poses[0]
    row, prev = np.full(J, -1), np.full(J, -1)
    Rk, tk = T0[3:].reshape(3, 3), T0[:3]
    for k in range(1, K):
        ia = pairs[k][0]
        n = ia.size
        if n < 3 or (stop_short and int(inl[k, :n].sum()) < 3):
            if stop_short:
                break
            poses[k] = poses[k - 1]
            continue
        Rk, tk = R[k] @ Rk, R[k] @ tk + t[k]
        poses[k] = np.concatenate([tk, Rk.reshape(9)])
        rows = ia[inl[k, :n]]
        new = row[ids[rows]] < 0
        row[ids[rows][new]] = rows[new]
        prev[ids[rows][new]] = k - 1
    return poses, row, prev


def _in_world(poses, prev, v):
    """``v`` of each row in the camera ``prev`` into the world frame's axes,
    without the translation: ``v R``."""
    return np.einsum("na,nab->nb", v, poses[prev, 3:].reshape(-1, 3, 3))


def stereo_guess(camera, uvd, state_ids, point_ids, pairs, hyp, thresh: float, T0, J: int,
                 device, dtype=np.float64):
    """The VO initial guess of a stereo track on the hypotheses ``hyp [K, H,
    3]``, computed in ``dtype`` (float32: the control): ``(poses [K, 12],
    points [J, 3], initialized [J])``."""
    pts_c = triangulate(camera, np.asarray(uvd, dtype))
    R, t, inl = ransac_pairs(camera, pts_c, pairs, hyp, thresh, device)
    poses, row, prev = chain(pairs, R, t, inl, T0, point_ids, J, stop_short=True)
    done = row >= 0
    points = np.zeros((J, 3), dtype)
    points[done] = _in_world(poses, prev[done], pts_c[row[done]] - poses[prev[done], :3])
    return poses, points, done


def initial_guess(track: dict, camera, thresh: float, iters: int, rng_seed: int, device):
    """The initial state of a Phong track (numpy arrays of the track:
    ``state_ids``, ``vertex_ids``, ``material_ids``, ``uvd``, ``ints``,
    ``nobs``, the sizes ``K``, ``J``, ``M`` and the first pose ``T0 [12]``):
    ``dict(poses [K, 12], points [J, 3], normals [J, 3], initialized [J],
    phong [M, 3], textures [M])``."""
    K, J, M = track["K"], track["J"], track["M"]
    sid, vid = track["state_ids"], track["vertex_ids"]
    pts_c = triangulate(camera, track["uvd"])
    of_state = [np.nonzero(sid == k)[0] for k in range(K)]
    pairs = [None]
    for k in range(1, K):
        a, b = of_state[k - 1], of_state[k]
        common, ia, ib = np.intersect1d(vid[a], vid[b], return_indices=True)
        pairs.append((a[ia], b[ib]))
    width = max([1] + [p[0].size for p in pairs[1:]])
    P = max(64, -(-width // 64) * 64)
    valid = torch.zeros((K, P), dtype=torch.bool, device=torch.device(device))
    for k in range(1, K):
        valid[k, :pairs[k][0].size] = True
    hyp = draw(valid, iters, rng_seed + torch.arange(K)).cpu().numpy()
    R, t, inl = ransac_pairs(camera, pts_c, pairs, hyp, thresh, device)
    poses, row, prev = chain(pairs, R, t, inl, track["T0"], vid, J, stop_short=False)

    phong = np.tile([0.0, 0.0, 1.0], (M, 1))
    textures = np.full(M, 0.5)
    for m in range(M):
        ints = track["ints"][track["material_ids"] == m]
        if ints.size:
            textures[m] = np.sort(ints)[ints.size // 2]
    done = row >= 0
    points, normals = np.zeros((J, 3)), np.tile([0.0, 0.0, 1.0], (J, 1))
    r, k = row[done], prev[done]
    points[done] = _in_world(poses, k, pts_c[r] - poses[k, :3])
    nrm = _in_world(poses, k, track["nobs"][r])
    normals[done] = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return dict(poses=poses, points=points, normals=normals, initialized=done, phong=phong,
                textures=textures)
