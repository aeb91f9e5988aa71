"""A frozen copy of the port's sim generators (``ceres_slam_tpu_torch/utils/sim.py``:
``generate``, ``generate_kitti``, ``generate_phong`` and the track and sun
CSV writers), part of the benchmark's
yardstick: the program may change its generators, the benchmark's inputs stay.
Same seed, same bytes as the port's at the time of the copy
(``benchmark/tests/test_bench_generators.py`` holds them equal)."""
from __future__ import annotations

import dataclasses

import numpy as np

_POLY_SIDES = {"triangle": 3, "square": 4, "penta": 5, "circle": 64}


@dataclasses.dataclass
class SimDataset:
    """Host-side (numpy) simulated dataset."""

    # camera intrinsics
    fu: float
    fv: float
    cu: float
    cv: float
    b: float
    # ground truth
    poses_gt: np.ndarray  # [K, 12] T_k_g flat (t | R row-major)
    points_gt: np.ndarray  # [J, 3] global frame
    # stereo observations
    state_ids: np.ndarray  # [N]
    point_ids: np.ndarray  # [N]
    uvd: np.ndarray  # [N, 3]
    uvd_covar: np.ndarray  # [N, 3, 3]
    stereo_var: np.ndarray  # [3] shared diagonal variance
    # sun observations
    sun_dir_g: np.ndarray  # [K, 3] ephemeris ENU sun direction
    sun_obs_c: np.ndarray  # [K, 3] observed camera-frame sun direction
    sun_covar: np.ndarray  # [K, 2, 2] az/zen covariance
    has_sun: np.ndarray  # [K] bool

    @property
    def num_states(self):
        return self.poses_gt.shape[0]

    @property
    def num_points(self):
        return self.points_gt.shape[0]


def _se3_flat(t, R):
    return np.concatenate([t, R.reshape(9)])


def _polygon_trajectory(kind: str, num_states: int, radius: float):
    """Camera centers + forward directions along a closed polygon.

    Headings are smoothed over a few frames so corner turns are gradual
    (a rover pivots over several frames; instantaneous 120-degree turns
    would leave zero feature overlap between consecutive frames)."""
    n = _POLY_SIDES[kind]
    corners = np.stack(
        [
            radius * np.cos(2 * np.pi * np.arange(n + 1) / n),
            radius * np.sin(2 * np.pi * np.arange(n + 1) / n),
            np.zeros(n + 1),
        ],
        axis=-1,
    )
    seg_len = np.linalg.norm(np.diff(corners, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    s = np.linspace(0.0, cum[-1], num_states, endpoint=False)
    seg = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, n - 1)
    alpha = (s - cum[seg]) / seg_len[seg]
    centers = corners[seg] + alpha[:, None] * (corners[seg + 1] - corners[seg])
    forward = corners[seg + 1] - corners[seg]
    forward /= np.linalg.norm(forward, axis=-1, keepdims=True)
    # Circular moving-average smoothing of the heading.
    w = max(3, num_states // 16)
    smooth = np.copy(forward)
    for _ in range(2):
        acc = np.copy(smooth)
        for off in range(1, w + 1):
            acc += np.roll(smooth, off, axis=0) + np.roll(smooth, -off, axis=0)
        smooth = acc / (2 * w + 1)
        smooth /= np.linalg.norm(smooth, axis=-1, keepdims=True)
    return centers, smooth


def generate(
    kind: str = "triangle",
    num_states: int = 200,
    num_points: int = 400,
    radius: float = 10.0,
    seed: int = 0,
    stereo_noise: tuple = (0.5, 0.5, 0.7),  # std-dev in px (u, v, d)
    sun_noise_deg: float = 0.0,
    sun_elevation_deg: float = 40.0,
    sun_azimuth_deg: float = 120.0,
    img_w: int = 640,
    img_h: int = 480,
    max_range: float = 40.0,
) -> SimDataset:
    """Generate a sim sequence in the style of the reference's sims."""
    rng = np.random.default_rng(seed)
    fu = fv = 500.0
    cu, cv = img_w / 2.0, img_h / 2.0
    b = 0.5

    centers, forward = _polygon_trajectory(kind, num_states, radius)
    up = np.array([0.0, 0.0, 1.0])
    poses = np.zeros((num_states, 12))
    for k in range(num_states):
        z = forward[k]
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)  # points downwards (z x x)
        R = np.stack([x, y, z], axis=0)  # rows = camera axes in global coords
        t = -R @ centers[k]
        poses[k] = _se3_flat(t, R)

    # Landmarks: scattered across the whole arena (inside and outside the
    # path) at varying heights so every viewing direction sees features.
    ang = rng.uniform(0, 2 * np.pi, num_points)
    rad = np.sqrt(rng.uniform(0.0, 1.0, num_points)) * (radius + 10.0)
    height = rng.uniform(-1.5, 4.0, num_points)
    points = np.stack([rad * np.cos(ang), rad * np.sin(ang), height], axis=-1)

    # Observations with visibility culling.
    state_ids, point_ids, uvds = [], [], []
    for k in range(num_states):
        R = poses[k, 3:].reshape(3, 3)
        t = poses[k, :3]
        p_c = points @ R.T + t
        z = p_c[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fu * p_c[:, 0] / z + cu
            v = fv * p_c[:, 1] / z + cv
            d = fu * b / z
        vis = (
            (z > 0.8)
            & (z < max_range)
            & (u >= 5)
            & (u < img_w - 5)
            & (v >= 5)
            & (v < img_h - 5)
            & (d > 0.5)
        )
        idx = np.nonzero(vis)[0]
        state_ids.append(np.full(idx.size, k))
        point_ids.append(idx)
        noise = rng.normal(0.0, stereo_noise, (idx.size, 3))
        uvds.append(np.stack([u[idx], v[idx], d[idx]], axis=-1) + noise)

    state_ids = np.concatenate(state_ids).astype(np.int64)
    point_ids = np.concatenate(point_ids).astype(np.int64)
    uvd = np.concatenate(uvds)
    stereo_var = np.asarray(stereo_noise, dtype=float) ** 2
    uvd_covar = np.broadcast_to(np.diag(stereo_var), (uvd.shape[0], 3, 3)).copy()

    # Sun: fixed ENU direction (pointing FROM the scene TOWARD the sun).
    el = np.deg2rad(sun_elevation_deg)
    az = np.deg2rad(sun_azimuth_deg)
    sun_g = np.array([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az), np.sin(el)])
    sun_dir_g = np.broadcast_to(sun_g, (num_states, 3)).copy()

    sun_obs_c = np.zeros((num_states, 3))
    sig = np.deg2rad(sun_noise_deg) if sun_noise_deg > 0 else 0.0
    for k in range(num_states):
        R = poses[k, 3:].reshape(3, 3)
        s_c = R @ sun_g
        if sig > 0:
            # small random rotation of the observed direction
            w = rng.normal(0.0, sig, 3)
            th = np.linalg.norm(w)
            if th > 0:
                K_ = np.array(
                    [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
                ) / th
                Rw = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
                s_c = Rw @ s_c
        sun_obs_c[k] = s_c
    var = max(sig, np.deg2rad(0.5)) ** 2
    sun_covar = np.broadcast_to(np.diag([var, var]), (num_states, 2, 2)).copy()

    return SimDataset(
        fu=fu,
        fv=fv,
        cu=cu,
        cv=cv,
        b=b,
        poses_gt=poses,
        points_gt=points,
        state_ids=state_ids,
        point_ids=point_ids,
        uvd=uvd,
        uvd_covar=uvd_covar,
        stereo_var=stereo_var,
        sun_dir_g=sun_dir_g,
        sun_obs_c=sun_obs_c,
        sun_covar=sun_covar,
        has_sun=np.ones(num_states, bool),
    )


def _drive_trajectory(num_states: int, rng, speed: float = 1.0):
    """KITTI-style street drive: straight blocks joined by smooth 90-deg
    corner turns (a city drive at ~10 m/s, ~1 m/frame at 10 Hz)."""
    centers = np.zeros((num_states, 3))
    fwd = np.zeros((num_states, 3))
    pos = np.zeros(3)
    heading = 0.0
    k = 0
    while k < num_states:
        for _ in range(min(int(rng.integers(60, 220)), num_states - k)):
            d = np.array([np.cos(heading), np.sin(heading), 0.0])
            centers[k], fwd[k] = pos, d
            pos = pos + speed * d
            k += 1
        if k >= num_states:
            break
        turn = float(rng.choice([-1.0, 1.0])) * np.pi / 2
        steps = 20
        for _ in range(min(steps, num_states - k)):
            heading += turn / steps
            d = np.array([np.cos(heading), np.sin(heading), 0.0])
            centers[k], fwd[k] = pos, d
            pos = pos + 0.7 * speed * d  # slower through the corner
            k += 1
    return centers, fwd


def generate_kitti(
    num_states: int = 1100,
    num_points: int = 18000,
    seed: int = 0,
    stereo_noise: tuple = (0.5, 0.5, 0.7),
    sun_noise_deg: float = 0.0,
    mean_track_len: int = 12,
    dropout: float = 0.1,
    max_range: float = 40.0,
    img_w: int = 613,
    img_h: int = 185,
) -> SimDataset:
    """KITTI-*shaped* drive: the validation surface the real
    `ba_all_icra/iser/kitti` harnesses need before real data exists
    (reference sequence lists: scripts/ba_all_icra.sh:19-56). Differs
    from the polygon sims in exactly the statistics that stress the
    static-shape padding budgets:

    - K >= 1000 poses on an open street-drive trajectory (not a loop);
    - landmarks spawned along the corridor (buildings/ground left+right
      of the road) rather than one arena;
    - feature-TRACK observation structure: each landmark is tracked from
      its first visible frame for a geometric-tail track length (mean
      ``mean_track_len``, the 5-20 frame range real trackers produce)
      with per-observation dropout — so per-window landmark counts and
      per-landmark observation counts follow realistic distributions;
    - KITTI-like intrinsics/image size (dense_stereo_test.cpp:22-26).
    """
    # half-resolution KITTI intrinsics (one pyrDown of
    # dense_stereo_test.cpp:22-26; image size scales with them)
    rng = np.random.default_rng(seed)
    fu = fv = 721.5377 / 2
    cu, cv = img_w / 2.0, img_h / 2.0
    b = 0.53715

    centers, forward = _drive_trajectory(num_states, rng)
    up = np.array([0.0, 0.0, 1.0])
    poses = np.zeros((num_states, 12))
    for k in range(num_states):
        z = forward[k]
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)
        poses[k] = _se3_flat(-R @ centers[k], R)

    # Landmarks along the corridor: anchored ahead of a random frame,
    # offset laterally (building facades, road furniture) and in height.
    anchor = rng.integers(0, num_states, num_points)
    ahead = rng.uniform(5.0, 0.9 * max_range, num_points)
    lateral = rng.uniform(-15.0, 15.0, num_points)
    height = rng.uniform(-1.5, 4.0, num_points)
    perp = np.stack([-forward[anchor, 1], forward[anchor, 0],
                     np.zeros(num_points)], axis=-1)
    points = (centers[anchor] + ahead[:, None] * forward[anchor]
              + lateral[:, None] * perp)
    points[:, 2] = height

    # Vectorized visibility [K, J], then track-structure masking.
    R_all = poses[:, 3:].reshape(num_states, 3, 3)
    t_all = poses[:, :3]
    p_c = np.einsum("kab,jb->kja", R_all, points) + t_all[:, None, :]
    z = p_c[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fu * p_c[..., 0] / z + cu
        v = fv * p_c[..., 1] / z + cv
        d = fu * b / z
    vis = ((z > 0.8) & (z < max_range) & (u >= 5) & (u < img_w - 5)
           & (v >= 5) & (v < img_h - 5) & (d > 0.5))
    # tracker semantics: the track begins at a RANDOM visible frame (a
    # tracker detects features continuously, not only at first physical
    # visibility — anchoring at first-visibility leaves mid-block frames
    # with no track starts at all) and survives ~geometric(1/mean)
    # frames; individual detections inside the track drop out i.i.d.
    any_vis = vis.any(axis=0)
    track_len = 2 + rng.geometric(1.0 / max(mean_track_len - 2, 1),
                                  num_points)
    # start at a uniformly-random VISIBLE frame (visibility episodes are
    # non-contiguous — a street corner can expose a landmark twice — so
    # uniform-over-[first,last] starts would land in invisible gaps and
    # leave post-turn frames with no live tracks at all)
    counts = vis.sum(axis=0)
    r = np.floor(rng.random(num_points) * np.maximum(counts, 1))
    start = (np.cumsum(vis, axis=0) <= r[None, :]).sum(axis=0)
    k_idx = np.arange(num_states)[:, None]
    in_track = (k_idx >= start[None, :]) & (
        k_idx < (start + track_len)[None, :]) & any_vis[None, :]
    vis &= in_track & (rng.random(vis.shape) >= dropout)
    # drop landmarks never observed twice (un-triangulatable tracks)
    keep = vis.sum(axis=0) >= 2
    vis[:, ~keep] = False

    ks, js = np.nonzero(vis)
    order = np.argsort(ks, kind="stable")
    ks, js = ks[order], js[order]
    uvd = np.stack([u[ks, js], v[ks, js], d[ks, js]], axis=-1)
    uvd = uvd + rng.normal(0.0, stereo_noise, uvd.shape)
    stereo_var = np.asarray(stereo_noise, dtype=float) ** 2
    uvd_covar = np.broadcast_to(
        np.diag(stereo_var), (uvd.shape[0], 3, 3)).copy()

    el, az = np.deg2rad(40.0), np.deg2rad(120.0)
    sun_g = np.array([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                      np.sin(el)])
    sun_dir_g = np.broadcast_to(sun_g, (num_states, 3)).copy()
    sig = np.deg2rad(sun_noise_deg) if sun_noise_deg > 0 else 0.0
    sun_obs_c = np.einsum("kab,b->ka", R_all, sun_g)
    if sig > 0:
        w = rng.normal(0.0, sig, (num_states, 3))
        th = np.linalg.norm(w, axis=-1, keepdims=True)
        axis = w / np.maximum(th, 1e-12)
        cross = np.cross(axis, sun_obs_c)
        dot = np.sum(axis * sun_obs_c, axis=-1, keepdims=True)
        sun_obs_c = (np.cos(th) * sun_obs_c + np.sin(th) * cross
                     + (1 - np.cos(th)) * dot * axis)
    var = max(sig, np.deg2rad(0.5)) ** 2
    sun_covar = np.broadcast_to(
        np.diag([var, var]), (num_states, 2, 2)).copy()

    return SimDataset(
        fu=fu, fv=fv, cu=cu, cv=cv, b=b,
        poses_gt=poses, points_gt=points,
        state_ids=ks.astype(np.int64), point_ids=js.astype(np.int64),
        uvd=uvd, uvd_covar=uvd_covar, stereo_var=stereo_var,
        sun_dir_g=sun_dir_g, sun_obs_c=sun_obs_c, sun_covar=sun_covar,
        has_sun=np.ones(num_states, bool),
    )


@dataclasses.dataclass
class PhongSimDataset:
    """Simulated Phong-shaded scene (dataset_ba_phong workload)."""

    fu: float
    fv: float
    cu: float
    cv: float
    b: float
    poses_gt: np.ndarray  # [K, 12]
    points_gt: np.ndarray  # [J, 3]
    normals_gt: np.ndarray  # [J, 3]
    material_of_vertex: np.ndarray  # [J]
    phong_gt: np.ndarray  # [M, 3]
    textures_gt: np.ndarray  # [M]
    light_gt: np.ndarray  # [3] position or unit direction
    directional: bool
    state_ids: np.ndarray  # [N] (written as the timestamp column)
    vertex_ids: np.ndarray  # [N]
    material_ids: np.ndarray  # [N]
    uvd: np.ndarray  # [N, 3]
    intensities: np.ndarray  # [N]
    normal_obs: np.ndarray  # [N, 3] camera-frame observed normals
    stereo_var: np.ndarray  # [3]
    normal_var: np.ndarray  # [3]
    int_var: float

    @property
    def num_states(self):
        return self.poses_gt.shape[0]


def generate_phong(
    kind: str = "triangle",
    num_states: int = 30,
    num_points: int = 200,
    num_materials: int = 3,
    radius: float = 10.0,
    seed: int = 0,
    stereo_noise: tuple = (0.4, 0.4, 0.4),
    normal_noise: float = 0.02,
    int_noise: float = 0.01,
    directional: bool = False,
) -> PhongSimDataset:
    """Generate a Phong-shaded sim scene with the same trajectory model as
    `generate` plus per-vertex normals, shared materials, and a light."""
    base = generate(
        kind=kind,
        num_states=num_states,
        num_points=num_points,
        radius=radius,
        seed=seed,
        stereo_noise=stereo_noise,
    )
    rng = np.random.default_rng(seed + 1)
    J = num_points
    K = num_states

    # Normals: point from each landmark roughly toward the arena center.
    to_center = -base.points_gt
    normals = to_center + rng.normal(0, 0.5, (J, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mat = rng.integers(0, num_materials, J)
    phong_gt = np.stack(
        [
            np.zeros(num_materials),  # ambient (disabled in the model)
            rng.uniform(0.1, 0.4, num_materials),  # specular
            rng.uniform(4.0, 12.0, num_materials),  # exponent
        ],
        axis=-1,
    )
    tex_gt = rng.uniform(0.3, 0.9, num_materials)
    if directional:
        light = np.array([0.4, -0.3, -0.85])
        light /= np.linalg.norm(light)
    else:
        light = np.array([0.0, 0.0, 15.0])

    # Shade each observation in the camera frame with the same equations as
    # the factor kernels (ambient off, clamp [0,1]).
    N = base.uvd.shape[0]
    I = np.zeros(N)
    n_obs = np.zeros((N, 3))
    for n in range(N):
        k, j = base.state_ids[n], base.point_ids[n]
        R = base.poses_gt[k, 3:].reshape(3, 3)
        t = base.poses_gt[k, :3]
        p_c = R @ base.points_gt[j] + t
        nc = R @ normals[j]
        if directional:
            l_c = R @ light
            lv = l_c / np.linalg.norm(l_c)
        else:
            l_c = R @ light + t
            lv = l_c - p_c
            lv = lv / np.linalg.norm(lv)
        cv_ = -p_c / np.linalg.norm(p_c)
        diffuse = tex_gt[mat[j]] * max(0.0, float(lv @ nc))
        mirror = 2.0 * (nc @ lv) * nc - lv
        mn = np.linalg.norm(mirror)
        spec = 0.0
        if mn > 0:
            md = float((mirror / mn) @ cv_)
            if md > 0:
                spec = phong_gt[mat[j], 1] * md ** phong_gt[mat[j], 2]
        I[n] = min(1.0, max(0.0, diffuse + spec)) + rng.normal(0, int_noise)
        n_obs[n] = nc + rng.normal(0, normal_noise, 3)

    return PhongSimDataset(
        fu=base.fu, fv=base.fv, cu=base.cu, cv=base.cv, b=base.b,
        poses_gt=base.poses_gt,
        points_gt=base.points_gt,
        normals_gt=normals,
        material_of_vertex=mat,
        phong_gt=phong_gt,
        textures_gt=tex_gt,
        light_gt=light,
        directional=directional,
        state_ids=base.state_ids,
        vertex_ids=base.point_ids,
        material_ids=mat[base.point_ids],
        uvd=base.uvd,
        intensities=np.clip(I, 0.0, 1.0),
        normal_obs=n_obs,
        stereo_var=base.stereo_var,
        normal_var=np.full(3, max(normal_noise, 1e-3) ** 2),
        int_var=max(int_noise, 1e-3) ** 2,
    )


def write_phong_track_csv(ds: PhongSimDataset, path: str):
    """DatasetProblemPhong track format (dataset_problem_phong.cpp:16-117):
    header K,J,M; intrinsics; stereo+normal+intensity variances; initial
    light pos/dir; first GT pose; rows [t,j,m,u,v,d,I,nx,ny,nz]."""
    with open(path, "w") as f:
        f.write(f"{ds.num_states},{ds.points_gt.shape[0]},{ds.textures_gt.shape[0]}\n")
        f.write(f"{ds.fu!r},{ds.fv!r},{ds.cu!r},{ds.cv!r},{ds.b!r}\n")
        f.write(
            ",".join(repr(float(x)) for x in ds.stereo_var)
            + ","
            + ",".join(repr(float(x)) for x in ds.normal_var)
            + f",{ds.int_var!r}\n"
        )
        f.write(",".join(repr(float(x)) for x in ds.light_gt) + "\n")
        f.write(_pose_to_matrix_row(ds.poses_gt[0]) + "\n")
        for n in range(ds.uvd.shape[0]):
            row = (
                [str(ds.state_ids[n]), str(ds.vertex_ids[n]), str(ds.material_ids[n])]
                + [repr(float(x)) for x in ds.uvd[n]]
                + [repr(float(ds.intensities[n]))]
                + [repr(float(x)) for x in ds.normal_obs[n]]
            )
            f.write(",".join(row) + "\n")


def _pose_to_matrix_row(T_flat):
    R = T_flat[3:].reshape(3, 3)
    t = T_flat[:3]
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = t
    return ",".join(repr(float(x)) for x in M.reshape(16))


def write_track_csv(ds: SimDataset, path: str, with_covar: bool = False):
    """Write the track file.

    ``with_covar=False`` -> DatasetProblem format (dataset_problem.cpp:16-121):
    header K,J; intrinsics; shared variances; first GT pose; rows [k,j,u,v,d].
    ``with_covar=True`` -> DatasetProblemSun format
    (dataset_problem_sun.cpp:16-120): no variance line, per-row 3x3 covariance.
    """
    with open(path, "w") as f:
        f.write(f"{ds.num_states},{ds.num_points}\n")
        f.write(f"{ds.fu!r},{ds.fv!r},{ds.cu!r},{ds.cv!r},{ds.b!r}\n")
        if not with_covar:
            f.write(",".join(repr(float(x)) for x in ds.stereo_var) + "\n")
        f.write(_pose_to_matrix_row(ds.poses_gt[0]) + "\n")
        for n in range(ds.uvd.shape[0]):
            row = [str(ds.state_ids[n]), str(ds.point_ids[n])] + [
                repr(float(x)) for x in ds.uvd[n]
            ]
            if with_covar:
                row += [repr(float(x)) for x in ds.uvd_covar[n].reshape(9)]
            f.write(",".join(row) + "\n")


def write_ref_sun_csv(ds: SimDataset, path: str):
    """Ephemeris ENU sun directions, rows [k, e, n, u]
    (dataset_problem_sun.cpp:127-147)."""
    with open(path, "w") as f:
        for k in range(ds.num_states):
            f.write(f"{k}," + ",".join(repr(float(x)) for x in ds.sun_dir_g[k]) + "\n")


def write_obs_sun_csv(ds: SimDataset, path: str):
    """Camera-frame sun observations, rows [k, x, y, z, c00, c01, c10, c11]
    (dataset_problem_sun.cpp:152-175)."""
    with open(path, "w") as f:
        for k in range(ds.num_states):
            if not ds.has_sun[k]:
                continue
            f.write(
                f"{k},"
                + ",".join(repr(float(x)) for x in ds.sun_obs_c[k])
                + ","
                + ",".join(repr(float(x)) for x in ds.sun_covar[k].reshape(4))
                + "\n"
            )
