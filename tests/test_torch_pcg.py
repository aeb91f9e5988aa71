"""Port parity: K2 and K3 (plain versions), the full-batch plan, the PCG
assembly, the Schur matvecs, the PCG step and the banded preconditioner.

Inputs come from ``__graft_entry__._build_example`` (seeded numpy) and
reach both packages as the same numpy arrays (``ceres_slam_tpu_torch.convert``).
On the CPU the K2 and K3 wrappers run their plain PyTorch versions; the
CUDA kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.models.stereo_camera import StereoCamera as JStereoCamera
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.ops import pallas_kernels
from ceres_slam_tpu.solver import banded as jbanded
from ceres_slam_tpu.solver import pcg as jpcg
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import cuda_build, full_batch_plan, schur_kernel, stereo_factor_kernel
from ceres_slam_tpu_torch.solver import banded, dense, lm, pcg

torch.set_num_threads(1)

K, J, N_OBS = 8, 64, 320
LAM = 1e-3
JCAM = JStereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _poisoned(problem, state):
    """Half the landmarks invalid and at the origin, pose 0 at the origin:
    their rows from pose 0 have z = 0 (uninitialized map points)."""
    bad = np.zeros(J, bool)
    bad[::2] = True
    pts = np.array(state.points)
    pts[bad] = 0.0
    poses = np.array(state.poses)
    poses[0, :3] = 0.0
    return (problem._replace(point_valid=jnp.asarray(~bad),
                             fixed_pose_mask=jnp.zeros(K, bool).at[0].set(True)),
            state._replace(points=jnp.asarray(pts), poses=jnp.asarray(poses)))


@pytest.fixture(scope="module", params=["plain", "poisoned"])
def case(request):
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
    if request.param == "poisoned":
        problem, state = _poisoned(problem, state)
    tables = jpcg.build_obs_tables(problem.stereo.pose_idx, problem.stereo.point_idx, K, J)
    return problem, state, tables


def _ported(problem, state, tables=None):
    p = convert.problem_from_numpy(_np(problem))
    t = None if tables is None else convert.obs_tables_from_numpy(
        _np(tables), problem.stereo.pose_idx, problem.stereo.point_idx)
    return p, convert.state_from_numpy(_np(state)), t


@jax.jit
def _jax_blocks(problem, state, tables=None):
    """JAX's XLA assembly, jitted (op-by-op dispatch would dominate the test)."""
    return jpcg.build_obs_blocks(problem, state, jnp.asarray(LAM), tables=tables, fused=False)


def _close(a, ref, scale):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    np.testing.assert_allclose(a, ref, rtol=0, atol=scale * max(np.abs(ref).max(), 1e-300))


# -- K2 ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k2_plain_matches_pallas(dtype):
    """K2's plain version against the Pallas kernel in interpret mode
    (``flat=True``), on the random inputs of tests/test_pallas.py. float64:
    atol 1e-12 x the largest entry (rounding only); float32: the 1e-4 x
    max(1, max|ref|) that tests/test_pallas.py holds the blocks to, for r
    too (both sides round a ~1e3 px projection at float32's 6e-8 before
    subtracting the measurement, in different orders), and 5e-3 on the
    gradients, as for K1 (that rounding of r, times Jacobian entries of
    ~1e3, in a sum that cancels)."""
    N = pallas_kernels.TILE
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    T = jlie.se3_exp(0.3 * jax.random.normal(k[0], (N, 6), dtype=jnp.float64))
    p = jax.random.normal(k[1], (N, 3), dtype=jnp.float64) + jnp.array([0.0, 0.0, 10.0])
    uvd = JCAM.project(jlie.se3_transform_point(T, p)) + jax.random.normal(
        k[2], (N, 3), dtype=jnp.float64)
    A = np.random.default_rng(0).normal(0, 0.1, (N, 3, 3))
    stiff = jnp.asarray(2.0 * np.eye(3) + A + A.transpose(0, 2, 1))
    valid = jax.random.bernoulli(k[3], 0.8, (N,))
    args = [x.astype(getattr(jnp, dtype)) for x in (T, p, uvd, stiff)]
    ref = pallas_kernels.stereo_factor_blocks(JCAM, *args, valid, interpret=True, flat=True)
    got = stereo_factor_kernel.stereo_factor_blocks_plain(
        StereoCamera.create(*JCAM), *(torch.as_tensor(np.asarray(x)) for x in args),
        torch.as_tensor(np.asarray(valid)))
    for name, g, r, tol32 in zip(("r", "hpp", "hll", "u", "gp", "gl"), got, ref,
                                 (1e-4, 1e-4, 1e-4, 1e-4, 5e-3, 5e-3)):
        r = np.asarray(r)
        if dtype == "float64":
            _close(g, r, 1e-12)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=tol32 * max(1.0, np.abs(r).max()), err_msg=name)


def test_k2_wrapper_checks_and_dispatch():
    """On the CPU the fused wrapper is its plain version (no launch);
    masked rows, row 0 at depth 0 among them, add exact zeros; bad
    per-call tensors raise."""
    plan, poses, points = stereo_factor_kernel.random_inputs(300, 40, 9, seed=2)
    launches = stereo_factor_kernel.stereo_factor_sums.launches
    got = stereo_factor_kernel.stereo_factor_sums(plan, poses, points)
    for a, b in zip(got, stereo_factor_kernel.stereo_factor_sums_plain(plan, poses, points)):
        assert torch.equal(a, b) and torch.isfinite(a).all()
    assert stereo_factor_kernel.stereo_factor_sums.launches == launches
    U18, Hpp, gp, Hll, gl = got
    assert torch.all(U18[~plan.valid] == 0) and torch.all(U18[plan.pose_idx == 0] == 0)
    assert torch.all(Hpp[0] == 0) and torch.all(gp[0] == 0)  # pose 0 is fixed
    assert torch.all(Hll[~plan.point_valid] == 0) and torch.all(gl[~plan.point_valid] == 0)
    # the sums are the per-observation blocks of the valid rows, summed by bin
    _, hpp, hll, u, _, _ = stereo_factor_kernel.stereo_factor_blocks_plain(
        plan.camera, poses[plan.pose_idx], points[plan.point_idx], plan.uvd, plan.stiffness,
        plan.valid)
    on = plan.valid
    for k in range(1, plan.K):
        _close(Hpp[k], hpp[on & (plan.pose_idx == k)].sum(0), 1e-12)
    for j in torch.nonzero(plan.point_valid).flatten()[:10]:
        _close(Hll[j], hll[on & (plan.point_idx == j)].sum(0), 1e-12)
    _close(U18[on], torch.where((plan.pose_idx != 0)[:, None], u, 0.0)[on], 1e-12)
    bad = {"poses": poses.float(), "points": points[:, :2].contiguous()}
    for name, x in bad.items():
        with pytest.raises(ValueError):
            stereo_factor_kernel.stereo_factor_sums(plan, **{"poses": poses, "points": points,
                                                            name: x})
    with pytest.raises(ValueError):
        stereo_factor_kernel.stereo_factor_sums(plan, poses, points.T.contiguous().T)


# -- PCG assembly --------------------------------------------------------------


@pytest.mark.parametrize("path", ["segment", "tables", "plan"])
def test_build_obs_blocks_matches_jax(case, path):
    """``build_obs_blocks`` against the JAX XLA assembly (segment-sum path,
    and with gather tables; the plan path, K2's fused plain version, against
    the tables path): atol 1e-12 x the largest entry (rounding and
    summation order only)."""
    problem, state, tables = case
    t = None if path == "segment" else tables
    ref = _jax_blocks(problem, state, t)
    p, s, tt = _ported(problem, state, t if path == "tables" else None)
    plan = full_batch_plan.plan_for_problem(p) if path == "plan" else None
    got = pcg.build_obs_blocks(p, s, LAM, tables=tt, plan=plan)
    assert (got.uy is not None) == (path == "plan")
    for f in ("U18", "Hpp", "Cinv", "gp", "gl", "Hll", "Hpp_undamped"):
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert torch.isfinite(g).all(), f
        _close(g, r, 1e-12)


def test_obs_tables_match_jax(case):
    problem, _, tables = case
    st = problem.stereo
    got = pcg.build_obs_tables(np.asarray(st.pose_idx), np.asarray(st.point_idx), K, J)
    ref = convert.obs_tables_from_numpy(_np(tables), st.pose_idx, st.point_idx)
    for f in pcg.ObsTables._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("tail", [False, True], ids=["example", "padded"])
def test_plan_segments_match_obs_tables(case, tail):
    """The plan's landmark and pose segments are the JAX gather tables'
    rows (slot for slot), also when the rows are stored pose by pose with a
    padding tail at pose 0 (``build_window_problem``'s layout), which makes
    pose 0's observation ids non-consecutive."""
    problem, _, _ = case
    pose_idx = np.asarray(problem.stereo.pose_idx).copy()
    point_idx = np.asarray(problem.stereo.point_idx)
    if tail:
        pose_idx = np.sort(pose_idx)
        pose_idx[-12:] = 0
    tables = jpcg.build_obs_tables(jnp.asarray(pose_idx), jnp.asarray(point_idx), K, J)
    N = pose_idx.size
    plan = full_batch_plan.make_plan(StereoCamera.create(*JCAM), K, J, pose_idx, point_idx,
                                     np.zeros((N, 3)), np.zeros((N, 3, 3)), np.ones(N, bool),
                                     np.ones(K, bool), np.ones(J, bool))
    for seg, start, other, table, w, table_other, n in (
            (plan.pt_obs, plan.pt_start, plan.pt_pose, tables.by_point, tables.by_point_w,
             pose_idx, J),
            (plan.ps_obs, plan.ps_start, plan.ps_point, tables.by_pose, tables.by_pose_w,
             point_idx, K)):
        table, w = np.asarray(table), np.asarray(w)
        for i in range(n):
            ids = table[i][w[i] > 0]
            np.testing.assert_array_equal(seg[start[i]:start[i + 1]].numpy(), ids)
            np.testing.assert_array_equal(other[start[i]:start[i + 1]].numpy(), table_other[ids])
    assert torch.equal(plan.ps_obs[plan.pt_q.long()], plan.pt_obs)
    for k in range(K):
        ids = plan.ps_obs[plan.ps_start[k]:plan.ps_start[k + 1]].numpy()
        assert bool(plan.ps_contig[k]) == bool(np.all(np.diff(ids) == 1)), k
    if tail:
        assert not plan.ps_contig[0] and plan.ps_contig[1:].all()


def test_make_plan_rejects_bad_inputs():
    N = 20
    good = dict(camera=StereoCamera.create(*JCAM), K=3, J=4, pose_idx=np.arange(N) % 3,
                point_idx=np.arange(N) % 4, uvd=np.zeros((N, 3)), stiffness=np.zeros((N, 3, 3)),
                valid=np.ones(N, bool), free_pose=np.ones(3, bool), point_valid=np.ones(4, bool))
    full_batch_plan.make_plan(**good)
    for name, x in (("pose_idx", np.full(N, 3)), ("point_idx", -np.ones(N, int)),
                    ("uvd", np.zeros((N, 2))), ("free_pose", np.ones(2, bool)),
                    ("dtype", torch.float16)):
        with pytest.raises(ValueError):
            full_batch_plan.make_plan(**{**good, name: x})


def test_plan_struct_matches_the_header():
    """``_Plan`` lists the fields of ``Plan`` in csrc/full_batch_plan.h (which
    K2 and K3 include) in order and with their C types, and GROUP_LANDMARKS
    is the header's ``kGroupLandmarks``, the size of K3's phase-1 arrays."""
    text = (cuda_build.CSRC / "full_batch_plan.h").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct Plan \{(.*?)\};", text, re.S).group(1))
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind = (ctypes.c_void_p if "*" in decl else
                ctypes.c_double if decl.startswith("double ") else ctypes.c_int)
        fields += [(item.split()[-1].lstrip("*"), kind) for item in decl.split(",")]
    assert fields == list(full_batch_plan._Plan._fields_)
    limit = int(re.search(r"constexpr int kGroupLandmarks = (\d+);", text).group(1))
    assert limit == full_batch_plan.GROUP_LANDMARKS


@pytest.mark.parametrize("most", [4, 300], ids=["short", "long"])
def test_landmark_groups_fit_k3s_block(most):
    """K3's landmark groups are runs of whole landmarks covering all J, of at
    most GROUP_LANDMARKS landmarks and GROUP_SLOTS slots (a longer landmark
    alone); the plan's ``max_group`` is the largest."""
    counts = np.random.default_rng(most).integers(0, most + 1, 3000)
    start = np.concatenate([[0], np.cumsum(counts)])
    groups = full_batch_plan._landmark_groups(start)
    assert groups[0] == 0 and groups[-1] == counts.size and np.all(np.diff(groups) >= 1)
    sizes = np.diff(groups)
    slots = start[groups[1:]] - start[groups[:-1]]
    assert sizes.max() <= full_batch_plan.GROUP_LANDMARKS
    assert np.all((slots <= full_batch_plan.GROUP_SLOTS) | (sizes == 1))
    if most == 4:  # short landmarks: the landmark cap binds
        assert sizes.max() == full_batch_plan.GROUP_LANDMARKS


# -- K3 and the Schur matvec --------------------------------------------------


def test_k3_matvec_matches_pallas_f32():
    """The gather matvec against the Pallas matvec kernel in interpret
    mode, float32, as tests/test_pallas.py holds that
    kernel: atol 2e-5 of the matvec's scale (max|S v| + 1)."""
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float32, seed=0)
    tables = jpcg.build_obs_tables(problem.stereo.pose_idx, problem.stereo.point_idx, K, J)
    b = jax.jit(lambda p, s, t: jpcg.build_obs_blocks(
        p, s, jnp.asarray(1e-4, jnp.float32), tables=t, fused=False))(problem, state, tables)
    v = np.random.default_rng(3).normal(size=(K, 6)).astype(np.float32)
    ref = np.asarray(jpcg.make_schur_matvec_kernel(b, tables, interpret=True)(jnp.asarray(v)))
    tb = convert.obs_blocks_from_numpy(_np(b))
    tt = convert.obs_tables_from_numpy(_np(tables), problem.stereo.pose_idx,
                                       problem.stereo.point_idx)
    got = pcg.schur_matvec_gather(tb, tt, torch.as_tensor(v)).numpy()
    scale = float(np.abs(np.asarray(jpcg.schur_matvec(b, jnp.asarray(v)))).max()) + 1.0
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)


def test_k3_plan_matches_pallas_f32():
    """K3's plan path (the plain version, bound to JAX's float32 blocks)
    against the Pallas matvec kernel in interpret mode: atol 2e-5 of the
    matvec's scale (max|S v| + 1), as tests/test_pallas.py holds that
    kernel."""
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float32, seed=0)
    tables = jpcg.build_obs_tables(problem.stereo.pose_idx, problem.stereo.point_idx, K, J)
    b = jax.jit(lambda p, s, t: jpcg.build_obs_blocks(
        p, s, jnp.asarray(1e-4, jnp.float32), tables=t, fused=False))(problem, state, tables)
    v = np.random.default_rng(3).normal(size=(K, 6)).astype(np.float32)
    ref = np.asarray(jpcg.make_schur_matvec_kernel(b, tables, interpret=True)(jnp.asarray(v)))
    plan = full_batch_plan.plan_for_problem(_ported(problem, state)[0])
    tb = convert.obs_blocks_from_numpy(_np(b))
    tb = tb._replace(uy=schur_kernel.bind(plan, tb.U18, tb.Cinv))
    got = pcg.schur_matvec_plan(tb, torch.as_tensor(v)).numpy()
    scale = float(np.abs(np.asarray(jpcg.schur_matvec(b, jnp.asarray(v)))).max()) + 1.0
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)


@pytest.mark.parametrize("path", ["segment", "gather", "plan"])
def test_schur_matvec_matches_jax_f64(case, path):
    """The matvecs against JAX's float64 segment / gather matvecs (the plan
    path, K3's plain version, against the gather matvec): atol 1e-12 x
    max|S v|."""
    problem, state, tables = case
    b = _jax_blocks(problem, state, tables)
    v = np.random.default_rng(5).normal(size=(K, 6))
    tb = convert.obs_blocks_from_numpy(_np(b))
    if path == "segment":
        ref = jpcg.schur_matvec(b, jnp.asarray(v))
        got = pcg.schur_matvec(tb, torch.as_tensor(v))
    elif path == "gather":
        ref = jpcg.schur_matvec_gather(b, tables, jnp.asarray(v))
        tt = convert.obs_tables_from_numpy(_np(tables), problem.stereo.pose_idx,
                                           problem.stereo.point_idx)
        got = pcg.schur_matvec_gather(tb, tt, torch.as_tensor(v))
    else:
        ref = jpcg.schur_matvec_gather(b, tables, jnp.asarray(v))
        plan = full_batch_plan.plan_for_problem(_ported(problem, state)[0])
        tb = tb._replace(uy=schur_kernel.bind(plan, tb.U18, tb.Cinv))
        got = pcg.schur_matvec_plan(tb, torch.as_tensor(v))
    _close(got, ref, 1e-12)


def test_k3_wrapper_checks_and_dispatch():
    """On the CPU the bound wrapper is its plain version (no launch), which
    is W C^-1 W^T v with W the dense coupling (atol 1e-12 x the largest
    entry); mismatched bound or per-call tensors raise."""
    bound, v = schur_kernel.random_inputs(300, 40, 9, seed=4)
    plan, U18, Cinv = bound.plan, bound.U18, bound.Cinv
    launches = schur_kernel.schur_uy.launches
    out = schur_kernel.schur_uy(bound, v)
    assert torch.equal(out, schur_kernel.schur_uy_plain(bound, v))
    assert schur_kernel.schur_uy.launches == launches
    # the plain version is W C^-1 W^T v, with W the dense [6K, 3J] coupling
    W = torch.zeros((9, 40, 6, 3), dtype=torch.float64)
    for k in range(9):
        for s in range(int(plan.ps_start[k]), int(plan.ps_start[k + 1])):
            W[k, int(plan.ps_point[s])] += U18[int(plan.ps_obs[s])].reshape(6, 3)
    Wd = W.permute(0, 2, 1, 3).reshape(54, 120)
    ref = Wd @ torch.block_diag(*Cinv) @ Wd.T @ v.reshape(-1)
    _close(out.reshape(-1), ref, 1e-12)
    bad = {"U18": U18.float(), "Cinv": Cinv[:-1], "v": v.T.contiguous().T}
    for name, x in bad.items():
        with pytest.raises(ValueError):
            kw = dict(U18=U18, Cinv=Cinv)
            if name == "v":
                schur_kernel.schur_uy(bound, x)
            else:
                kw[name] = x
                schur_kernel.bind(plan, **kw)
    with pytest.raises(ValueError):
        schur_kernel.schur_uy(bound, v.float())
    with pytest.raises(ValueError):
        schur_kernel.bind(plan, U18.T.contiguous().T, Cinv)


# -- the PCG step --------------------------------------------------------------


def _tracks(problem):
    st = problem.stereo
    valid = st.valid & problem.point_valid[st.point_idx]
    return jbanded.build_track_info(st.pose_idx, st.point_idx, K, J, valid=valid)


@pytest.mark.parametrize("precond", ["jacobi", "banded"])
@pytest.mark.parametrize("path", ["segment", "tables", "plan"])
def test_pcg_step_matches_jax(case, precond, path):
    """``pcg_step`` against JAX's (block-Jacobi and banded preconditioners,
    segment and gather paths; the plan path, K2's and K3's plain versions,
    with the tables, against JAX's gather path): dx atol 1e-9 x max|dx|
    after 200 CG iterations at tol 1e-12 (both converge to the same linear
    solution), gradient norm and predicted decrease rtol 1e-9."""
    problem, state, tables = case
    t = None if path == "segment" else tables
    jtracks = _tracks(problem) if precond == "banded" else None
    dx_r, gn_r, pred_r = jax.jit(lambda p, s: jpcg.pcg_step(
        p, s, jnp.asarray(LAM), 200, 1e-12, tables=t, tracks=jtracks))(problem, state)
    p, s, tt = _ported(problem, state, t)
    tracks = None if jtracks is None else convert.track_info_from_numpy(_np(jtracks))
    plan = full_batch_plan.plan_for_problem(p) if path == "plan" else None
    dx, gn, pred, iters = pcg.pcg_step(p, s, LAM, 200, 1e-12, tables=tt, tracks=tracks, plan=plan)
    assert torch.isfinite(dx).all() and 0 < iters <= 200
    _close(dx, dx_r, 1e-9)
    np.testing.assert_allclose(gn.item(), float(gn_r), rtol=1e-9)
    np.testing.assert_allclose(pred.item(), float(pred_r), rtol=1e-9)


# -- banded preconditioner -----------------------------------------------------


def test_track_info_matches_jax(case):
    """Same structure (exactly), with the observation mask."""
    problem, _, _ = case
    ref = _tracks(problem)
    st = problem.stereo
    got = banded.build_track_info(
        np.asarray(st.pose_idx), np.asarray(st.point_idx), K, J,
        valid=np.asarray(st.valid & problem.point_valid[st.point_idx]))
    assert (got.L, got.n_super, got.eligible_frac) == (ref.L, ref.n_super, ref.eligible_frac)
    for f in ("slots", "slot_w", "start", "by_bin", "by_bin_w", "start_bins", "start_bins_w"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_cyclic_reduction_matches_jax(n):
    """``ctridiag_factor``/``ctridiag_solve`` against JAX's on the SPD
    block-tridiagonal systems of tests/test_banded.py: atol 1e-10."""
    rng = np.random.default_rng(0)
    m = 4
    D = np.stack([np.eye(m) * (5.0 + i) for i in range(n)])
    E = 0.5 * rng.normal(size=(max(0, n - 1), m, m))
    A = np.zeros((n * m, n * m))
    for i in range(n):
        A[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[i]
        if i + 1 < n:
            A[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = E[i]
    A = A + A.T + 4.0 * m * n * np.eye(n * m)
    Ds = np.stack([A[i * m:(i + 1) * m, i * m:(i + 1) * m] for i in range(n)])
    Es = np.stack([A[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] for i in range(n - 1)]) \
        if n > 1 else np.zeros((0, m, m))
    b = rng.normal(size=(n, m))
    ref = np.asarray(jbanded.ctridiag_solve(jbanded.ctridiag_factor(jnp.asarray(Ds), jnp.asarray(Es)),
                                            jnp.asarray(b)))
    got = banded.ctridiag_solve(banded.ctridiag_factor(torch.as_tensor(Ds), torch.as_tensor(Es)),
                                torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[:n].reshape(-1), np.linalg.solve(A, b.reshape(-1)), atol=1e-10)


def test_banded_precond_matches_jax(case):
    """The banded preconditioner's super-tridiagonal and its application
    against JAX's: atol 1e-10 x the largest entry."""
    problem, state, _ = case
    jt = _tracks(problem)
    b = _jax_blocks(problem, state)
    D_r, E_r = jax.jit(lambda b: jbanded.build_super_tridiag(b, jt))(b)
    tb, tt = convert.obs_blocks_from_numpy(_np(b)), convert.track_info_from_numpy(_np(jt))
    D, E = banded.build_super_tridiag(tb, tt)
    _close(D, D_r, 1e-10)
    if E_r.shape[0]:
        _close(E, E_r, 1e-10)
    r = np.random.default_rng(1).normal(size=(K, 6))
    ref = jax.jit(lambda b, r: jbanded.make_banded_precond(b, jt, K)(r))(b, jnp.asarray(r))
    _close(banded.make_banded_precond(tb, tt, K)(torch.as_tensor(r)), ref, 1e-10)


def test_banded_precond_is_exact_when_all_eligible():
    """With every track contiguous the banded part is all of S: ``S M^{-1}
    r = r`` (tests/test_banded.py's case, on the port alone): rtol 1e-8,
    atol 1e-9."""
    problem, state = ge._build_example(K=16, J=64, n_obs=256, dtype=jnp.float64, seed=3)
    p, s, _ = _ported(problem, state)
    st = p.stereo
    t = banded.build_track_info(st.pose_idx, st.point_idx, 16, 64)
    assert t.eligible_frac == 1.0
    b = pcg.build_obs_blocks(p, s, 1e-4)
    r = torch.as_tensor(np.random.default_rng(1).normal(size=(16, 6)))
    Sx = pcg.schur_matvec(b, banded.make_banded_precond(b, t, 16)(r))
    np.testing.assert_allclose(Sx.numpy(), r.numpy(), rtol=1e-8, atol=1e-9)


def test_banded_pcg_with_ineligible_landmarks():
    """Non-contiguous tracks are left out of the banded preconditioner;
    the solve still reaches the block-Jacobi minimum (final cost rtol 1e-6,
    tests/test_banded.py's case, on the port alone)."""
    problem, state = ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64, seed=3)
    pi = np.array(problem.stereo.pose_idx)
    pt = np.asarray(problem.stereo.point_idx)
    for j in [0, 5, 9]:
        rows = np.nonzero(pt == j)[0]
        pi[rows[0]], pi[rows[-1]] = pi[rows[-1]], pi[rows[0]]
    problem = problem._replace(stereo=problem.stereo._replace(pose_idx=jnp.asarray(pi)))
    p, s, _ = _ported(problem, state)
    assert banded.build_track_info(pi, pt, K, J).eligible_frac < 1.0
    dx = np.random.default_rng(11).normal(0, 0.01, 6 * K + 3 * J)
    s = dense._retract_state(p, s, torch.as_tensor(dx))
    cfg = lm.SolveConfig(max_iters=25)
    _, sum_j = pcg.solve_ba_pcg(p, s, cfg, precond="jacobi")
    _, sum_b = pcg.solve_ba_pcg(p, s, cfg, precond="banded")
    np.testing.assert_allclose(sum_b.final_cost, sum_j.final_cost, rtol=1e-6)
    assert sum_b.final_cost < sum_b.initial_cost


@pytest.mark.parametrize("path", ["segment", "tables", "plan"])
def test_fixed_pose_with_non_finite_aux_stays_finite(path):
    """F15: non-finite sun and prior terms on the gauge-fixed pose 0 leave
    every block finite and equal to those of the clean problem (masks are
    ``torch.where``, not products), on the CPU paths with and without
    tables and on the plan path; F14: all three agree to rounding."""
    problem, state = _poisoned(*ge._build_example(K=K, J=J, n_obs=N_OBS, dtype=jnp.float64,
                                                  seed=3))
    tables = jpcg.build_obs_tables(problem.stereo.pose_idx, problem.stereo.point_idx, K, J)
    p, s, tt = _ported(problem, state, tables if path == "tables" else None)
    sun = p.sun
    dir_c = sun.dir_c.clone()
    dir_c[0] = float("nan")
    bad = p._replace(sun=sun._replace(dir_c=dir_c, valid=torch.ones_like(sun.valid)),
                     prior=p.prior._replace(pose_idx=0, valid=True,
                                            T_ref=torch.full_like(p.prior.T_ref, float("inf"))))
    plan = full_batch_plan.plan_for_problem(bad) if path == "plan" else None
    got = pcg.build_obs_blocks(bad, s, LAM, tables=tt, plan=plan)
    clean = pcg.build_obs_blocks(bad._replace(sun=sun._replace(valid=torch.ones_like(sun.valid)),
                                              prior=p.prior), s, LAM)
    for f in ("U18", "Hpp", "Cinv", "gp", "gl", "Hll", "Hpp_undamped"):
        g, r = getattr(got, f), getattr(clean, f)
        assert torch.isfinite(g).all(), f
        _close(g, r.numpy(), 1e-12)
    dx, gn, pred, _ = pcg.pcg_step(bad, s, LAM, 100, 1e-10, tables=tt, plan=plan)
    assert torch.isfinite(dx).all() and torch.isfinite(pred)


# -- the fused CG iteration: its dispatch (its kernels run on the card only) ---


def _plan_blocks(case):
    """The plan path's blocks on the CPU, their tables and block-Jacobi
    preconditioner, and the banded one."""
    problem, state, tables = case
    p, s, tt = _ported(problem, state, tables)
    b = pcg.build_obs_blocks(p, s, LAM, tables=tt, plan=full_batch_plan.plan_for_problem(p))
    tracks = convert.track_info_from_numpy(_np(_tracks(problem)))
    return p, s, tt, b, pcg._block_precond(pcg.schur_diag_blocks(b, tt)), \
        banded.make_banded_precond(b, tracks, K)


def test_fused_cg_dispatch_rule(case, monkeypatch):
    """``pcg_solve`` runs a CG iteration fused only on blocks bound to K3 on
    the card (here a binding given a C side, as ``bind`` gives one on CUDA)
    with the block-Jacobi preconditioner; the banded preconditioner, the
    gather matvec and the CPU's binding take ``cg_body``, as does a CG loop
    given no ``fused`` (the sharded solve's, whose matvec all-reduces)."""
    _, _, tt, b, jacobi, band = _plan_blocks(case)
    card = b._replace(uy=b.uy._replace(args=object()))
    passed = []
    monkeypatch.setattr(pcg, "cg", lambda *args: passed.append(args[5]) or (None, 0))
    cases = {"card": (card, None, jacobi, True), "cpu": (b, None, jacobi, False),
             "banded": (card, None, band, False),
             "gather": (card._replace(uy=None), tt, jacobi, False)}
    for name, (blocks, tables, precond, fused) in cases.items():
        want = (blocks, jacobi.chol) if fused else None
        assert pcg.fused_inputs(blocks, precond) == want, name
        pcg.pcg_solve(blocks, -b.gp, 10, 1e-6, tables=tables, precond=precond, loop="host")
        assert passed.pop() == want, name
        _, body = pcg._cg_in_place(None, precond, pcg.cg_buffers(b.gp), 10, 1e-6, want)
        assert body.__name__ == ("fused_body" if fused else "body"), name
    _, body = pcg._cg_in_place(None, jacobi, pcg.cg_buffers(b.gp), 10, 1e-6)
    assert body.__name__ == "body"


@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_cg_on_the_cpu_is_the_plain_loop(case, precond):
    """``cg`` iterates ``cg_loop``'s in-place body on the host: on the CPU
    the same bits and iterations as the loop of ``cg_start`` and
    ``cg_body`` it replaced, to convergence and to ``max_iters``."""
    _, _, _, b, jacobi, band = _plan_blocks(case)
    pre, rhs = (jacobi if precond == "jacobi" else band), -b.gp

    def matvec(v):
        return pcg.schur_matvec_plan(b, v)

    for max_iters, tol in ((200, 1e-10), (7, 0.0)):
        x, n = pcg.cg(matvec, pre, rhs, max_iters, tol)
        s, bound = pcg.cg_start(pre, rhs, tol)
        it = 0
        while it < max_iters and bool(pcg.cg_continue(s, bound)):
            s = pcg.cg_body(matvec, pre, s)
            it += 1
        assert n == it > 2 and torch.equal(x, s.x)


def test_no_fused_cg_off_the_card(case):
    """On the CPU a solve launches no fused update and opens no ``lm.node``
    span (its LM loop runs on the host), so nothing reports a fused CG
    iteration; the fused wrappers refuse tensors off the card."""
    from ceres_slam_tpu_torch.ops import cg_kernel
    from ceres_slam_tpu_torch.utils import telemetry

    p, s, tt, b, jacobi, _ = _plan_blocks(case)
    before = cg_kernel.cg_update.launches
    telemetry.reset()
    with telemetry.record():
        _, summ = pcg.solve_ba_pcg(p, s, lm.SolveConfig(max_iters=3), tables=tt, precond="jacobi")
    spans = telemetry.spans()
    assert summ.linear_iterations > 0 and cg_kernel.cg_update.launches == before
    assert "pcg.solve" in {r["name"] for r in spans}
    assert not [r for r in spans if r["name"] == "lm.node"
                or r["attrs"].get("fused_cg_iterations", 0)]
    bufs = pcg.cg_buffers(b.gp)
    with pytest.raises(ValueError, match="card"):
        cg_kernel.cg_update(bufs.s, b.gp, b.gp[:, 0], jacobi.chol, bufs.bound, bufs.i,
                            bufs.pred, 10)
    with pytest.raises(ValueError, match="card"):
        schur_kernel.schur_sp(b.uy, b.gp, b.Hpp)
