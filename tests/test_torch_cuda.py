"""The CUDA kernels (K1-K4) against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere. This file imports no JAX,
so it also runs where JAX is absent; there the repository's conftest (which
imports JAX) must be skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K1's tolerances, relative to the largest reference entry: float64 1e-12
(rounding only); float32 1e-5 for the Gram blocks and 5e-3 for the
gradients (accumulation order; the gradients cancel), rtol 1e-4 for the
cost. K2's, K3's and K4's are stated above their tests. K2 and K3 run on
the full-batch plan (``ops/full_batch_plan.py``).
"""

import pytest
import torch

from ceres_slam_tpu_torch.ops import (bilinear_kernel, full_batch_plan, full_batch_trace,
                                      schur_kernel, stereo_factor_kernel, window_kernel)
from ceres_slam_tpu_torch.solver import dense, pcg, window

torch.set_num_threads(1)

TOL = {torch.float64: dict(hll=1e-12, u=1e-12, gl=1e-12, hpp=1e-12, gp=1e-12, pcost=1e-12,
                           cost=1e-12),
       torch.float32: dict(hll=1e-5, u=1e-5, gl=5e-3, hpp=1e-5, gp=5e-3, pcost=1e-4, cost=1e-4)}
K1_SHAPES = {"flagship": (2, 192, 2), "S": (64, 2048, 8), "ragged": (5, 77, 3)}


def _split(o):
    hll, u, gl, hppgp, cost = o
    return dict(hll=hll, u=u, gl=gl, hpp=hppgp[:, :36], gp=hppgp[:, 36:42], pcost=hppgp[:, 42],
                cost=cost)


def _device_kernels(fn) -> int:
    """CUDA kernels one call of ``fn`` runs (torch.profiler over 10 calls,
    ``full_batch_trace.kernel_ms``), rounded."""
    return round(full_batch_trace.kernel_ms(fn, reps=10)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = window_kernel.random_inputs(*K1_SHAPES[shape], dtype, "cuda", seed=11)
    before = window_kernel.window_factor_blocks.launches
    got = window_kernel.window_factor_blocks(plan, poses, points)
    torch.cuda.synchronize()
    assert window_kernel.window_factor_blocks.launches == before + 1
    ref = _split(window_kernel.window_factor_blocks_plain(plan, poses, points))
    for name, g in _split(got).items():
        g, r = g.double(), ref[name].double()
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        assert (g - r).abs().max() <= TOL[dtype][name] * r.abs().max(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_k1_deterministic_single_launch(shape, dtype):
    """Two calls give the same bits; one call, and one ``factor_blocks``,
    runs exactly one device kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = window_kernel.random_inputs(*K1_SHAPES[shape], dtype, "cuda", seed=15)
    a = window_kernel.window_factor_blocks(plan, poses, points)
    b = window_kernel.window_factor_blocks(plan, poses, points)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert _device_kernels(lambda: window_kernel.window_factor_blocks(plan, poses, points)) == 1
    layout = window.WindowLayout(problem=None, O=plan.O, slot_pose=None, w_idx=None, plan=plan)
    state = dense.BAState(poses=poses, points=points)
    assert _device_kernels(lambda: window.factor_blocks(layout, state)) == 1
    blocks = window.factor_blocks(layout, state)
    assert torch.equal(blocks.Hpp.reshape(-1, 36), a[3][:, :36])
    assert torch.equal(blocks.stereo_cost, a[4])


# K2 (fused: the factor pass with its pose and landmark sums) and K3 (bound
# to the full-batch plan) against their plain versions at the full-batch
# shapes of the sims (triangle200: N 12,992, J 448, K 200; kitti1100: N
# 124,480, J 16,640, K 1,100) and at a ragged shape, on random problems whose
# rows are stored pose by pose with a padding tail at pose 0. float64: 1e-12
# x max|ref| (rounding only). float32, K2: 1e-4 x max(1, max|ref|) on the
# Gram blocks, 5e-3 on the gradients (a ~1e3 px projection rounded at 6e-8
# in two orders, times Jacobian entries of ~1e3, in sums that cancel); K3:
# 2e-5 x (max|ref| + 1) (float32 sums over up to ~150 observations in two
# orders). Each is bit-equal across two calls.
FULL_BATCH = {"triangle200": (12992, 448, 200), "kitti1100": (124480, 16640, 1100),
              "ragged": (1001, 77, 13)}
K2_TOL32 = {"U18": 1e-4, "Hpp": 1e-4, "gp": 5e-3, "Hll": 1e-4, "gl": 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(FULL_BATCH))
def test_k2_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(*FULL_BATCH[shape], dtype, "cuda",
                                                             seed=12)
    before = stereo_factor_kernel.stereo_factor_sums.launches
    got = stereo_factor_kernel.stereo_factor_sums(plan, poses, points)
    again = stereo_factor_kernel.stereo_factor_sums(plan, poses, points)
    torch.cuda.synchronize()
    assert stereo_factor_kernel.stereo_factor_sums.launches == before + 2
    ref = stereo_factor_kernel.stereo_factor_sums_plain(plan, poses, points)
    for name, g, a, r in zip(K2_TOL32, got, again, ref):
        assert torch.equal(g, a), name
        g, r = g.double(), r.double()
        assert torch.isfinite(g).all(), name
        if dtype == torch.float64:
            assert (g - r).abs().max() <= 1e-12 * r.abs().max(), name
        else:
            assert (g - r).abs().max() <= K2_TOL32[name] * max(1.0, r.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(FULL_BATCH))
def test_k3_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bound, v = schur_kernel.random_inputs(*FULL_BATCH[shape], dtype, "cuda", seed=13)
    before = schur_kernel.schur_uy.launches
    got = schur_kernel.schur_uy(bound, v)
    again = schur_kernel.schur_uy(bound, v)
    torch.cuda.synchronize()
    assert schur_kernel.schur_uy.launches == before + 2
    assert torch.equal(got, again)
    ref = schur_kernel.schur_uy_plain(bound, v).double()
    err = (got.double() - ref).abs().max()
    assert torch.isfinite(got).all()
    if dtype == torch.float64:
        assert err <= 1e-12 * ref.abs().max()
    else:
        assert err <= 2e-5 * (ref.abs().max() + 1.0)


@pytest.mark.cuda
def test_k2_k3_count_only_cuda_launches():
    """The plain versions on a CPU plan launch nothing; the CUDA wrappers
    count one launch per call (two device kernels each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = (stereo_factor_kernel.stereo_factor_sums.launches, schur_kernel.schur_uy.launches)
    for device, n in (("cpu", 0), ("cuda", 1)):
        plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device=device)
        stereo_factor_kernel.stereo_factor_sums(plan, poses, points)
        bound, v = schur_kernel.random_inputs(1001, 77, 13, device=device)
        schur_kernel.schur_uy(bound, v)
        torch.cuda.synchronize()
        assert (stereo_factor_kernel.stereo_factor_sums.launches,
                schur_kernel.schur_uy.launches) == (counts[0] + n, counts[1] + n)
    k2 = stereo_factor_kernel.stereo_factor_sums
    assert _device_kernels(lambda: k2(plan, poses, points)) == 2
    assert _device_kernels(lambda: schur_kernel.schur_uy(bound, v)) == 2


@pytest.mark.cuda
def test_k3_refuses_a_landmark_group_beyond_its_block():
    """A plan whose largest landmark group holds more landmarks than K3's
    phase-1 block has room for is refused at launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bound, v = schur_kernel.random_inputs(1001, 77, 13, device="cuda")
    assert 1 <= bound.args.plan.max_group <= full_batch_plan.GROUP_LANDMARKS
    wide = full_batch_plan._Plan.from_buffer_copy(bound.args.plan)
    wide.max_group = full_batch_plan.GROUP_LANDMARKS + 1
    args = schur_kernel._UyArgs(wide, bound.args.U18, bound.args.cinv)
    with pytest.raises(RuntimeError, match="schur_uy launch failed"):
        schur_kernel.schur_uy(bound._replace(args=args), v)


def _problem_of(plan, poses) -> dense.StereoBAProblem:
    """The full-batch problem of a random plan, with no valid sun
    observation and the pose prior off. Masked rows get a zero measurement:
    a random plan's rows that see landmark 0 from pose 0 project at depth
    0, and the CPU's segment path masks by product."""
    K, dt, dev = plan.K, poses.dtype, poses.device
    up = torch.zeros((K, 3), dtype=dt, device=dev)
    up[:, 2] = 1.0
    sun = dense.SunObs(dir_c=up, dir_g=up.clone(),
                       stiffness=torch.eye(2, dtype=dt, device=dev).expand(K, 2, 2).contiguous(),
                       valid=torch.zeros(K, dtype=torch.bool, device=dev))
    prior = dense.PosePrior(0, poses[0].clone(), torch.eye(6, dtype=dt, device=dev), False)
    uvd = torch.where(plan.valid[:, None], plan.uvd, 0.0)
    stereo = dense.StereoObs(uvd, plan.stiffness, plan.pose_idx, plan.point_idx, plan.valid)
    return dense.StereoBAProblem(plan.camera, stereo, sun, prior, ~plan.free_pose,
                                 plan.point_valid, 0.0, 1.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_tables", [False, True], ids=["no_tables", "tables"])
def test_pcg_step_on_the_card_runs_k2_and_k3(with_tables):
    """``pcg_step`` on CUDA without a plan builds one: K2 runs once and K3
    once per CG iteration, and the step equals the CPU's (segment sums, no
    kernel) to 1e-6 relative. Blocks without K3's binding are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=16)
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    tables = None
    if with_tables:
        tables = pcg.build_obs_tables(plan.pose_idx.cpu(), plan.point_idx.cpu(), plan.K, plan.J,
                                      device="cuda")
    k2, k3 = stereo_factor_kernel.stereo_factor_sums, schur_kernel.schur_uy
    before = (k2.launches, k3.launches)
    dx, _, _, iters = pcg.pcg_step(problem, state, 1e-2, 200, 1e-12, tables=tables)
    torch.cuda.synchronize()
    assert iters >= 1
    assert (k2.launches - before[0], k3.launches - before[1]) == (1, iters)
    dx_cpu, _, _, _ = pcg.pcg_step(dense.to_device(problem, "cpu"), dense.to_device(state, "cpu"),
                                   1e-2, 200, 1e-12)
    assert torch.isfinite(dx).all()
    scale = dx_cpu.abs().max().item()
    assert (dx.cpu() - dx_cpu).abs().max().item() <= 1e-6 * scale
    b = pcg.build_obs_blocks(problem, state, 1e-2, tables=tables)
    with pytest.raises(ValueError, match="K3"):
        pcg.pcg_solve(b._replace(uy=None), -b.gp, 10, 1e-6, tables=tables)


# K4 against its plain versions at the photometric path's 240x320 (N 68,096
# aligned pixels), at KITTI's full resolution (N 440,134) and at a ragged
# shape, with points outside the image and non-finite coordinates. The
# kernel rounds as the plain versions do (no FMA contraction), so it equals
# them bit for bit at every point (NaN where they are NaN): through
# ``bilinear_sample_imgs`` (pack, then sample) against the planar plain
# version, and on the packed stack at strided coordinates against the
# packed plain version.
K4_SHAPES = {"240x320": (3, 240, 320, 68096), "375x1242": (3, 375, 1242, 440134),
             "ragged": (3, 37, 53, 1001)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(K4_SHAPES))
def test_k4_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs, u, v = bilinear_kernel.random_inputs(*K4_SHAPES[shape], dtype, "cuda", seed=14)
    before = bilinear_kernel.bilinear_sample_packed.launches
    got = bilinear_kernel.bilinear_sample_imgs(imgs, u, v)
    torch.cuda.synchronize()
    assert bilinear_kernel.bilinear_sample_packed.launches == before + 1
    ref = bilinear_kernel.bilinear_sample_imgs_plain(imgs, u, v)
    assert (~(u.isfinite() & v.isfinite())).sum() >= 3
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    packed = bilinear_kernel.pack_imgs(imgs)
    proj = torch.stack([u, v, u], dim=-1)
    got = bilinear_kernel.bilinear_sample_packed(packed, proj[:, 0], proj[:, 1])
    ref = bilinear_kernel.bilinear_sample_packed_plain(packed, proj[:, 0], proj[:, 1])
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert _device_kernels(lambda: bilinear_kernel.bilinear_sample_packed(packed, u, v)) == 1
