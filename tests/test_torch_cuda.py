"""The CUDA kernels (K1-K4, P) against their plain PyTorch versions, on the card,
and the solvers' sums in a fixed order (two runs give the same bits).

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

import numpy as np
import pytest
import torch

from ceres_slam_tpu_torch.ops import (allreduce_kernel, bilinear_kernel, double_kernel,
                                      full_batch_plan, graph_loop, lie, subspace_kernel,
                                      full_batch_trace, schur_kernel, stereo_factor_kernel,
                                      window_kernel)
from ceres_slam_tpu_torch.parallel import multihost, sharded_ba, sharded_pcg
from ceres_slam_tpu_torch.solver import dense, lm, pcg, phong_schur, window

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


# The batched K1: B windows of one shape in one launch. The shapes are the
# sliding-window grid's padded window (triangle/square/penta200: K 2, J 128,
# O 2; 15 chains) and kitti1100's (K 2, J 192, O 2; the flagship's two
# passes). Window b equals a single-window launch on window b's plan bit for
# bit (the same device code on the same slice); against the plain version
# K1's tolerances above.
K1_BATCH = {"grid": (15, 2, 128, 2), "kitti1100": (2, 2, 192, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(K1_BATCH))
def test_batched_k1_equals_single_launches(shape, dtype):
    """One launch for B windows (counted once, serving B windows), one
    device kernel a call; each window bit-equal to its single-window launch
    and within K1's tolerance of the plain version; two calls the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, K, J, O = K1_BATCH[shape]
    plan, poses, points, single = window_kernel.random_batch_inputs(B, K, J, O, dtype, "cuda",
                                                                    seed=31)
    fn = window_kernel.window_factor_blocks_batch
    launches, windows = fn.launches, fn.windows
    got = fn(plan, poses, points)
    torch.cuda.synchronize()
    assert (fn.launches, fn.windows) == (launches + 1, windows + B)
    for b, args in enumerate(single):
        for x, y in zip(got, window_kernel.window_factor_blocks(*args)):
            assert torch.equal(x[b], y)
    ref = window_kernel.window_factor_blocks_batch_plain(plan, poses, points)
    for b in range(B):
        r = _split(tuple(x[b] for x in ref))
        for name, g in _split(tuple(x[b] for x in got)).items():
            g, rr = g.double(), r[name].double()
            assert torch.isfinite(g).all(), name
            assert (g - rr).abs().max() <= TOL[dtype][name] * rr.abs().max(), name
    again = fn(plan, poses, points)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert _device_kernels(lambda: fn(plan, poses, points)) == 1


def _batch_sims(tmp_path):
    """Two datasets (16 and 12 states) and the three runs of
    tests/test_torch_batch.py, on the card."""
    from ceres_slam_tpu_torch.problems import batch_scan
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
    from ceres_slam_tpu_torch.utils import sim

    bases = []
    for kind, k, j, seed in (("triangle", 16, 120, 0), ("square", 12, 90, 5)):
        ds = sim.generate(kind=kind, num_states=k, num_points=j, seed=seed,
                          stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
        base = str(tmp_path / kind)
        sim.write_track_csv(ds, base + ".csv", with_covar=True)
        sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
        sim.write_obs_sun_csv(ds, base + "_sun_dir.csv")
        bases.append(base)

    def load(base):
        d = DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                       base + "_sun_dir.csv")
        d.device = "cuda"
        return d

    runs = [(bases[0], dict(use_sun=False)), (bases[0], dict(use_sun=True)),
            (bases[1], dict(use_sun=True, huber_param=0.1, az_err_thresh=0.2,
                            zen_err_thresh=0.2))]

    def batch():
        datasets = {b: load(b) for b in bases}
        return batch_scan.solve_batch([batch_scan.RunSpec(datasets[b], **kw) for b, kw in runs],
                                      config=lm.SolveConfig(**_BATCH_CFG))

    return runs, load, batch


_BATCH_CFG = dict(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)


@pytest.mark.cuda
def test_batch_solve_on_the_card_matches_sequential_passes(tmp_path):
    """A 3-run batch on the card (two datasets, VO and sun runs) against
    each run's sequential pass on the card: poses within 1e-8, the same
    iterations in every window; the batched K1 serves every window of a
    step in one launch, at least once a trust-region iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs, load, batch = _batch_sims(tmp_path)
    fn = window_kernel.window_factor_blocks_batch
    launches = fn.launches
    results = batch()
    steps = max(r.ok.size for r in results)
    iterations = sum(max((s.iterations for r in results for i, s in _by_window(r) if i == w),
                         default=0) for w in range(steps))
    assert fn.launches - launches >= iterations >= steps
    for res, (base, kw) in zip(results, runs):
        ds = load(base)
        summaries = ds.solve_sliding_window(window=2, config=lm.SolveConfig(**_BATCH_CFG), **kw)
        assert np.abs(res.poses - ds.poses).max() <= 1e-8
        assert [s.iterations for s in res.summaries] == [s.iterations for s in summaries]


def _by_window(res):
    """``(window index, summary)`` of a run's solved windows."""
    return zip(np.nonzero(res.ok)[0], res.summaries)


@pytest.mark.cuda
def test_batch_solve_is_bit_reproducible(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, batch = _batch_sims(tmp_path)
    a, b = batch(), batch()
    for x, y in zip(a, b):
        assert np.array_equal(x.poses, y.poses) and np.array_equal(x.pose_covars, y.pose_covars)
        assert [s.iterations for s in x.summaries] == [s.iterations for s in y.summaries]


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
    observation and the pose prior off. Masked rows get a zero measurement
    (a random plan's rows that see landmark 0 from pose 0 project at depth
    0)."""
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


def _sharded_pcg_one_rank(rendezvous, problem, state, config):
    """``solve_ba_pcg_sharded`` on a one-rank NCCL group (a ``file://``
    rendezvous) that is shut down after the solve; returns ``(state,
    summary, K2 launches)``."""
    k2 = stereo_factor_kernel.stereo_factor_sums
    assert multihost.initialize(f"file://{rendezvous}", 1, 0, device="cuda", timeout_s=60)
    try:
        before = k2.launches
        sol, summ = sharded_pcg.solve_ba_pcg_sharded(problem, state, sharded_ba.make_mesh(),
                                                     config, 200, 1e-10)
        torch.cuda.synchronize()
        return sol, summ, k2.launches - before
    finally:
        multihost.shutdown()


def _sharded_case():
    plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=16)
    return _problem_of(plan, poses), dense.BAState(poses, points), lm.SolveConfig(max_iters=8)


@pytest.mark.cuda
def test_sharded_pcg_on_one_nccl_rank_runs_k2(tmp_path):
    """The distributed Schur-PCG solve on one NCCL rank runs K2 once per LM
    iteration on its shard's plan, and lands on the single-card solve's cost
    (rtol 1e-6: the matvec sums through tables there, through K3 here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem, state, config = _sharded_case()
    _, summ, launches = _sharded_pcg_one_rank(tmp_path / "rendezvous", problem, state, config)
    assert launches == summ.iterations > 0
    _, ref = pcg.solve_ba_pcg(problem, state, config, 200, 1e-10, precond="jacobi")
    assert abs(summ.final_cost - ref.final_cost) <= 1e-6 * ref.final_cost


@pytest.mark.cuda
def test_sharded_pcg_is_bit_reproducible(tmp_path):
    """Two distributed solves give the same bits (ROADMAP F14: no float
    atomics in a rank's sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem, state, config = _sharded_case()
    a, sa, _ = _sharded_pcg_one_rank(tmp_path / "first", problem, state, config)
    b, sb, _ = _sharded_pcg_one_rank(tmp_path / "second", problem, state, config)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    assert (sa.iterations, sa.linear_iterations, sa.final_cost) == (
        sb.iterations, sb.linear_iterations, sb.final_cost)


def _host_tree(x):
    """Tensors (through tuples) to numpy arrays, for a child's results."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, tuple):
        return tuple(_host_tree(v) for v in x)
    return x


def _sharded_host_work(mesh, problem, state, small, small_state) -> dict:
    """Host launches, syncs and copies of a restarted sharded solve in its
    node at 3 and at 8 LM iterations (``run_full_budget``), per solver:
    ``{name: {n: (iterations, launches, syncs, copies)}}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solves = {"jacobi": lambda c, g: sharded_pcg.solve_ba_pcg_sharded(
                  problem, state, mesh, c, 200, 1e-10, "jacobi", graph=g),
              "banded": lambda c, g: sharded_pcg.solve_ba_pcg_sharded(
                  problem, state, mesh, c, 200, 1e-10, "banded", graph=g),
              "dense": lambda c, g: sharded_ba.solve_ba_sharded(small, small_state, mesh, c,
                                                                graph=g)}
    out = {}
    for name, solve in solves.items():
        out[name] = {}
        for n in (3, 8):
            cfg, graph = lm.SolveConfig(max_iters=n, run_full_budget=True), lm.LMGraph()
            solve(cfg, graph)  # the capture
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                _, summ = solve(cfg, graph)
                torch.cuda.synchronize()
            graph.close()
            host = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
            out[name][n] = (summ.iterations, sum(x.startswith("cudaLaunchKernel") for x in host),
                            sum("Synchronize" in x for x in host),
                            sum(x.startswith("cudaMemcpy") for x in host))
    return out


def _nccl_world() -> int:
    """NCCL ranks a card test spawns: 4 or 2 where that many cards are
    visible, else 1."""
    n = torch.cuda.device_count()
    return 4 if n >= 4 else (2 if n >= 2 else 1)


def _spawn_ranks(fn, world, tmp_path, *args) -> list:
    """``fn(rank, world, rendezvous, out, *args)`` in ``world`` child
    processes; returns each rank's pickled results."""
    import pickle

    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    torch.multiprocessing.spawn(fn, args=(world, str(tmp_path / "rdv"), [str(o) for o in outs],
                                          *args), nprocs=world, join=True)
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results


def _sharded_forms_child(rank, world, rendezvous, outs):
    """One NCCL rank (a child process, one a card): the sharded solves in
    each loop form, the restart of a captured solve and the captured GN
    step; pickles what each run returned and counted."""
    import pickle

    assert multihost.initialize(f"file://{rendezvous}", world, rank, device="cuda",
                                timeout_s=60)
    k2, ps = stereo_factor_kernel.stereo_factor_sums, sharded_ba.psum
    peer = allreduce_kernel.peer_all_reduce
    res = {}

    def run(name, fn):
        k2.launches, ps.collectives, ps.bytes, peer.launches = 0, 0, 0, 0
        sol, summ = fn()
        torch.cuda.synchronize()
        res[name] = {"state": _host_tree(tuple(sol)), "summary": _host_tree(tuple(summ)),
                     "k2": k2.launches, "collectives": ps.collectives, "bytes": ps.bytes,
                     "peer": peer.launches}

    try:
        mesh = sharded_ba.make_mesh()
        problem, state = _lm_problem(torch.float64)
        cfg = lm.SolveConfig(max_iters=6, nonmonotonic=True, ftol=1e-9, xtol=1e-12,
                             record_history=True)
        for precond in ("jacobi", "banded"):
            for lm_loop, cg_loop in (("host", "host"), ("host", "device"), ("device", "device")):
                run(f"{precond} {lm_loop}/{cg_loop}", lambda: sharded_pcg.solve_ba_pcg_sharded(
                    problem, state, mesh, cfg, 200, 1e-10, precond, lm_loop, cg_loop))
        # a second state: the first solve's, moved; a restart through one LMGraph
        state2 = dense.BAState(lie.se3_retract(state.poses, torch.full_like(state.poses[:, :6],
                                                                            1e-3)),
                               state.points + 1e-3)
        graph, stats = lm.LMGraph(), lm.GRAPH_STATS
        before = (stats["captures"], stats["restarts"])
        for i, s in enumerate((state, state2)):
            run(f"graph {i}", lambda: sharded_pcg.solve_ba_pcg_sharded(
                problem, s, mesh, cfg, 200, 1e-10, "jacobi", graph=graph))
        res["graph_stats"] = (stats["captures"] - before[0], stats["restarts"] - before[1])
        graph.close()
        run("graph host", lambda: sharded_pcg.solve_ba_pcg_sharded(
            problem, state2, mesh, cfg, 200, 1e-10, "jacobi", "host", "host"))
        small, small_state, _ = _sharded_case()
        for lm_loop in ("host", "device"):
            run(f"dense {lm_loop}", lambda: sharded_ba.solve_ba_sharded(small, small_state, mesh,
                                                                        cfg, lm_loop=lm_loop))
        res["host_work"] = _sharded_host_work(mesh, problem, state, small, small_state)
        shard, steps = sharded_ba.shard_problem(small, mesh), sharded_ba.StepGraph()
        for i, s in enumerate((small_state, dense.BAState(small_state.poses,
                                                          small_state.points + 1e-3))):
            eager = _host_tree(tuple(sharded_ba.gn_step_sharded(shard, s, mesh)))
            ps.collectives = 0
            replayed = _host_tree(tuple(sharded_ba.gn_step_sharded(shard, s, mesh, graph=steps)))
            res[f"gn {i}"] = (eager, replayed, ps.collectives)
        steps.close()
    finally:
        multihost.shutdown()
    with open(outs[rank], "wb") as f:
        pickle.dump(res, f)


def _same_run(a, b):
    for x, y in zip(a["state"] + a["summary"], b["state"] + b["summary"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_sharded_node_forms_equal_host_forms(tmp_path):
    """On 4 or 2 NCCL ranks, one a card, where that many cards are visible
    (else one; child processes), at triangle200's full-batch shape: the
    sharded PCG solve (block-Jacobi and banded) with its LM loop in a WHILE
    node and the CG node nested in it, and with the CG node under the host
    LM loop, gives the host loops' bits (summary and history included) on
    every rank; K2 launches once per LM iteration, and ``psum`` counts, per
    iteration the card ran, the collectives and bytes the host form makes,
    each collective one launch of the peer all-reduce kernel. A second solve
    through one ``LMGraph`` restarts the capture (no new capture) and gives
    the host form's bits on its own state. The sharded dense solve in its
    node equals its host form; ``gn_step_sharded`` replayed through a
    ``StepGraph`` equals the eager step. A restarted solve in its node makes
    the same host launches, syncs and copies at 3 and at 8 LM iterations:
    none per LM or CG iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = _spawn_ranks(_sharded_forms_child, _nccl_world(), tmp_path)
    res = ranks[0]
    for other in ranks[1:]:
        for name, run in res.items():
            if isinstance(run, dict) and "state" in run:
                _same_run(other[name], run)
    for precond in ("jacobi", "banded"):
        ref = res[f"{precond} host/host"]
        assert ref["k2"] == ref["summary"][0] > 2 and ref["summary"][5] > ref["summary"][0]
        for form in ("host/host", "host/device", "device/device"):
            got = res[f"{precond} {form}"]
            _same_run(got, ref)
            assert (got["k2"], got["collectives"], got["bytes"]) == (
                ref["k2"], ref["collectives"], ref["bytes"]), (precond, form)
            assert got["peer"] == got["collectives"], (precond, form)
    for name, counts in res["host_work"].items():  # no host work per LM or CG iteration
        assert (counts[3][0], counts[8][0]) == (3, 8), name
        assert counts[3][1:] == counts[8][1:], (name, counts)
    assert res["graph_stats"] == (1, 1)
    _same_run(res["graph 0"], res["jacobi host/host"])
    _same_run(res["graph 1"], res["graph host"])
    assert res["graph 1"]["collectives"] == res["graph host"]["collectives"]
    _same_run(res["dense device"], res["dense host"])
    assert res["dense device"]["collectives"] == res["dense host"]["collectives"] > 0
    for i in range(2):
        eager, replayed, collectives = res[f"gn {i}"]
        for x, y in zip(eager, replayed):
            np.testing.assert_array_equal(x, y)
        # one all-reduce a replay (the first step also runs the step once eagerly)
        assert collectives == 2 - i


# the peer all-reduce at a CG iteration's U^T v of triangle200 and kitti1100,
# the LM step's blocks, odd sizes and one element
PEER_SIZES = (1, 7, 1344, 2049, 49920, 245880)


def _peer_child(rank, world, rendezvous, outs, share):
    """One rank (a child process): the peer all-reduce kernel and its plain
    version on seeded per-rank buffers of ``PEER_SIZES`` in float64 and
    float32, twice, after 3 replays of a captured graph of 3 in-place calls,
    and in a 3-iteration WHILE node run twice (restarted). ``share``: every
    rank on card 0, a gloo group; else NCCL, one rank a card."""
    import pickle

    assert multihost.initialize(f"file://{rendezvous}", world, rank, device="cuda",
                                timeout_s=60, local_device_ids=[0] if share else None,
                                backend="gloo" if share else None)
    peer, plain = allreduce_kernel.peer_all_reduce, allreduce_kernel.peer_all_reduce_plain
    group, res = torch.distributed.group.WORLD, {}
    try:
        for dtype in (torch.float64, torch.float32):
            for numel in PEER_SIZES:
                gen = torch.Generator().manual_seed(1000 * rank + numel)
                x = torch.randn(numel, generator=gen, dtype=dtype).cuda()
                allreduce_kernel.reserve(group, numel * x.element_size(), x.device)

                def plain_n(k):
                    y = x.clone()
                    for _ in range(k):
                        plain(y, group)
                    return y.cpu()

                before = peer.launches
                eager = [peer(x.clone(), group).cpu() for _ in range(2)]
                launches = peer.launches - before
                buf = x.clone()
                g = graph_loop.DeviceGraph(lambda: [peer(buf, group) for _ in range(3)],
                                           x.get_device())
                for _ in range(3):
                    g.replay()
                g.close()
                nbuf, i = x.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
                pred = torch.ones(1, dtype=torch.int32, device="cuda")

                def body():
                    peer(nbuf, group)
                    i.add_(1)
                    pred.copy_(i < 3)

                node, runs = graph_loop.DeviceWhile(body, pred), []
                for _ in range(2):
                    nbuf.copy_(x)
                    i.zero_()
                    pred.fill_(1)
                    runs.append((node.run(), nbuf.cpu()))
                node.close()
                res[(str(dtype), numel)] = {
                    "plain": plain_n(1), "eager": eager, "launches": launches,
                    "graph": buf.cpu(), "plain9": plain_n(9), "node": runs,
                    "plain3": plain_n(3)}
    finally:
        multihost.shutdown()
    with open(outs[rank], "wb") as f:
        pickle.dump(res, f)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True], ids=["nccl", "shared_card"])
def test_peer_all_reduce_matches_plain(tmp_path, share):
    """The peer all-reduce kernel equals its plain version (all_gather, then
    the sum in rank order) bit for bit on every rank, in float64 and
    float32 at the path's sizes and odd ones: twice in a row, after 3
    replays of a captured graph of 3 in-place calls (9 reductions), and in a
    3-iteration WHILE node run and restarted; one launch a call. On 4 or 2
    NCCL ranks, one a card, where that many cards are visible (else one),
    and on 2 processes sharing card 0 (a gloo group: CUDA IPC on one card,
    the processes taking turns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = _spawn_ranks(_peer_child, 2 if share else _nccl_world(), tmp_path, share)
    for key, r in ranks[0].items():
        for other in ranks[1:]:
            assert torch.equal(other[key]["eager"][0], r["eager"][0]), key
        assert r["launches"] == 2, key
        assert all(torch.equal(e, r["plain"]) for e in r["eager"]), key
        assert torch.equal(r["graph"], r["plain9"]), key
        for n, y in r["node"]:
            assert n == 3 and torch.equal(y, r["plain3"]), key


# a CG iteration's U^T v and U y of kitti1100, in turns
PEER_ALTERNATING = (49920, 6600)


def _peer_alternating_child(rank, world, rendezvous, outs, share):
    """One rank: the peer all-reduce on two buffers of ``PEER_ALTERNATING``
    sizes, in place, in turns (49,920, 6,600, 49,920, ...), float64 and
    float32: 6 calls eagerly, 3 replays of a captured graph of 4 calls, and
    a WHILE node of 3 calls an iteration (an odd number: the round's parity
    flips every iteration) run for 3 iterations, then restarted; each
    buffer against the plain version applied as often."""
    import pickle

    assert multihost.initialize(f"file://{rendezvous}", world, rank, device="cuda",
                                timeout_s=60, local_device_ids=[0] if share else None,
                                backend="gloo" if share else None)
    peer, plain = allreduce_kernel.peer_all_reduce, allreduce_kernel.peer_all_reduce_plain
    group, res = torch.distributed.group.WORLD, {}
    try:
        for dtype in (torch.float64, torch.float32):
            xs = [torch.randn(numel, generator=torch.Generator().manual_seed(100 * rank + numel),
                              dtype=dtype).cuda() for numel in PEER_ALTERNATING]
            allreduce_kernel.reserve(group, xs[0].numel() * xs[0].element_size(), xs[0].device)

            def plain_n(k):
                out = []
                for x, times in zip(xs, k):
                    y = x.clone()
                    for _ in range(times):
                        plain(y, group)
                    out.append(y.cpu())
                return out

            eager = [x.clone() for x in xs]
            for k in range(6):
                peer(eager[k % 2], group)
            bufs = [x.clone() for x in xs]
            g = graph_loop.DeviceGraph(lambda: [peer(bufs[k % 2], group) for k in range(4)],
                                       xs[0].get_device())
            for _ in range(3):
                g.replay()
            g.close()
            nbufs = [x.clone() for x in xs]
            i = torch.zeros(1, dtype=torch.int32, device="cuda")
            pred = torch.ones(1, dtype=torch.int32, device="cuda")

            def body():
                for k in range(3):
                    peer(nbufs[k % 2], group)
                i.add_(1)
                pred.copy_(i < 3)

            node, runs = graph_loop.DeviceWhile(body, pred), []
            for _ in range(2):
                for b, x in zip(nbufs, xs):
                    b.copy_(x)
                i.zero_()
                pred.fill_(1)
                runs.append((node.run(), [b.cpu() for b in nbufs]))
            node.close()
            res[str(dtype)] = {"eager": [b.cpu() for b in eager], "plain_eager": plain_n((3, 3)),
                               "graph": [b.cpu() for b in bufs], "plain_graph": plain_n((6, 6)),
                               "node": runs, "plain_node": plain_n((6, 3))}
    finally:
        multihost.shutdown()
    with open(outs[rank], "wb") as f:
        pickle.dump(res, f)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [False, True], ids=["nccl", "shared_card"])
def test_peer_all_reduce_alternating_sizes(tmp_path, share):
    """The peer all-reduce with calls whose sizes alternate (the two slots'
    parity argument: one flag round a call, the grid fixed per workspace)
    equals its plain version bit for bit on every rank, eagerly, replayed
    in a captured graph and in a WHILE node run and restarted. On 4 or 2
    NCCL ranks where that many cards are visible (else one: the kernel
    returns at once), and on 2 processes sharing card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = _spawn_ranks(_peer_alternating_child, 2 if share else _nccl_world(), tmp_path, share)
    for key, r in ranks[0].items():
        for other in ranks[1:]:
            for a, b in zip(other[key]["eager"], r["eager"]):
                assert torch.equal(a, b), key
        for got, ref in ((r["eager"], r["plain_eager"]), (r["graph"], r["plain_graph"])):
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), key
        for n, ys in r["node"]:
            assert n == 3 and all(torch.equal(a, b) for a, b in zip(ys, r["plain_node"])), key


def test_distributed_cuda_without_a_card_raises(monkeypatch):
    """``device="cuda"`` without a card raises before any process group
    starts; nothing falls back to gloo or the CPU (the card is hidden here,
    so this runs everywhere)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()


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


# P (double_kernel): 2 x is exact in float32, so each form equals x * 2 bit
# for bit, eagerly and replayed from a CUDA graph.

def test_p_wrapper_on_the_cpu():
    """On the CPU the wrapper runs the plain version (no launch) and checks
    its input."""
    x = torch.arange(1024, dtype=torch.float32).reshape(2, 512)
    before = double_kernel.double_kernel.launches
    assert torch.equal(double_kernel.double_kernel(x), x * 2)
    buf = x.clone()
    double_kernel.double_kernel(buf, out=buf)
    assert torch.equal(buf, x * 2) and double_kernel.double_kernel.launches == before
    with pytest.raises(ValueError, match="float32"):
        double_kernel.double_kernel(x.double())
    with pytest.raises(ValueError, match="out"):
        double_kernel.double_kernel(x, out=torch.empty(3))


def test_probe_needs_a_card():
    """The graph probe's cases run on the card only: without one, a case
    exits instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ceres_slam_tpu_torch.apps import probe_graph_loop

    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_graph_loop.main(["eager_loop"])
    with pytest.raises(SystemExit, match="unknown case"):
        probe_graph_loop.main(["grid_in_scan"])


@pytest.mark.cuda
@pytest.mark.parametrize("one_block", [False, True], ids=["grid4", "grid1"])
def test_p_matches_plain_eager_and_in_a_graph(one_block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    P = double_kernel.double_kernel
    x = torch.arange(1024, dtype=torch.float32, device="cuda").reshape(2, 512)
    before = P.launches
    assert torch.equal(P(x, one_block=one_block), double_kernel.double_kernel_plain(x))
    assert P.launches == before + 1
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x
        for _ in range(3):
            y = P(y, one_block=one_block)
    assert P.launches == before + 4  # captured launches count once, replays not
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, x * 8) and float(y.sum()) == 4190208.0
    buf = x.clone()
    h = torch.cuda.CUDAGraph()
    with torch.cuda.graph(h):
        P(buf, one_block=one_block, out=buf)
    for _ in range(3):
        h.replay()
    torch.cuda.synchronize()
    assert torch.equal(buf, x * 8)
    assert _device_kernels(lambda: P(x, one_block=one_block)) == 1


# The device-side while loop (ops/graph_loop.DeviceWhile: a conditional
# WHILE node around a captured body): P's while cases, and the CG loop of
# pcg_solve, which must equal the host loop (cg) bit for bit.

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid_in_while", "grid_in_while_data"])
def test_p_while_cases(case):
    """P's in-place launch as the body of a WHILE node: 3 iterations (a
    counter on the device, or sum(x) < 8 sum(x0)), x * 8 bit for bit, P's
    count up by the 3 launches the device ran (the capture counts none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import probe_graph_loop

    P = double_kernel.double_kernel
    before = P.launches
    assert probe_graph_loop.p_case(torch, case) == 4190208.0
    assert P.launches == before + 1 + 3  # the eager build launch, then the loop's


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_device_cg_equals_host_cg(precond, dtype):
    """``pcg_step`` with the CG loop in the WHILE node equals the host loop
    (``cg``) bit for bit, with the same iterations, on
    ``full_batch_plan.random_problem``; K3 launches once per CG iteration
    in both (the capture counts none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.solver import banded

    plan, poses, points = stereo_factor_kernel.random_inputs(12992, 448, 200, dtype, "cuda",
                                                             seed=16)
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    st = problem.stereo
    tables = pcg.build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), plan.K, plan.J,
                                  device="cuda")
    tracks = None
    if precond == "banded":
        tracks = banded.build_track_info(st.pose_idx.cpu(), st.point_idx.cpu(), plan.K, plan.J,
                                         valid=dense.stereo_valid(problem).cpu(), device="cuda")
    k3 = schur_kernel.schur_uy
    runs = []
    for loop in ("host", "device", "device", "host"):
        before = k3.launches
        dx, gn, pred, iters = pcg.pcg_step(problem, state, 1e-2, 200, 1e-10, tables=tables,
                                           tracks=tracks, plan=plan, loop=loop)
        torch.cuda.synchronize()
        assert k3.launches - before == iters > 1
        runs.append((dx, gn, pred, iters))
    for dx, gn, pred, iters in runs[1:]:
        assert iters == runs[0][3]
        assert torch.equal(dx, runs[0][0]) and torch.equal(pred, runs[0][2])


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "banded"])
def test_solve_with_reused_loop_equals_host_loop(precond):
    """``solve_ba_pcg`` captures its CG loop once (``pcg.CGGraph``) and
    reuses it every LM iteration, copying the new blocks and factors in:
    the same LM and CG iterations and the same bits as the host loop, K3
    once per CG iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(12992, 448, 200, seed=16,
                                                             device="cuda")
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    cfg = lm.SolveConfig(max_iters=8, nonmonotonic=True, ftol=1e-9, xtol=1e-12)
    k3 = schur_kernel.schur_uy
    runs = []
    for loop in ("host", "device"):
        before = k3.launches
        sol, summ = pcg.solve_ba_pcg(problem, state, cfg, precond=precond, loop=loop)
        torch.cuda.synchronize()
        assert k3.launches - before == summ.linear_iterations > summ.iterations > 1
        runs.append((sol, summ))
    (a, sa), (b, sb) = runs
    assert (sa.iterations, sa.linear_iterations, sa.final_cost) == (
        sb.iterations, sb.linear_iterations, sb.final_cost)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)


@pytest.mark.cuda
def test_device_while_capture_failure_raises():
    """A body that synchronizes with the host cannot be captured: the
    capture raises (no host loop instead), and the next loop still works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.ops import graph_loop

    pred = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError):
        graph_loop.DeviceWhile(lambda: pred.fill_(int(pred.item()) - 1), pred)
    n = torch.zeros(1, dtype=torch.int32, device="cuda")

    def body():
        n.add_(1)
        pred.copy_(n < 5)

    loop = graph_loop.DeviceWhile(body, pred)
    assert loop.run() == 5 and int(n.item()) == 5
    n.zero_()
    pred.fill_(0)
    assert loop.run() == 0 and int(n.item()) == 0
    loop.close()


# ROADMAP F14: every float sum on the card runs in a fixed order, so two
# runs of a solve give the same bits.

@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["dogleg", "lm"])
def test_window_solve_is_bit_reproducible(strategy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=17)
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    cfg = lm.SolveConfig(max_iters=30, nonmonotonic=True, ftol=1e-9, xtol=1e-12)
    runs = [window.solve_ba_window_with_covariance(problem, state, 1, cfg, strategy=strategy)
            for _ in range(2)]
    (s1, sum1, c1), (s2, sum2, c2) = runs
    assert sum1 == sum2 and sum1.iterations > 1
    assert torch.equal(s1.poses, s2.poses) and torch.equal(s1.points, s2.points)
    assert torch.equal(c1, c2)


@pytest.mark.cuda
def test_tableless_pcg_step_is_bit_reproducible():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=18)
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    a = pcg.pcg_step(problem, state, 1e-2, 200, 1e-12)
    b = pcg.pcg_step(problem, state, 1e-2, 200, 1e-12)
    assert a[3] == b[3] >= 1
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_dense_ba_is_bit_reproducible():
    """The dense LM's block sums by pose, landmark and pair (``dense.segment_sum``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=19)
    problem, state = _problem_of(plan, poses), dense.BAState(poses, points)
    H1, g1 = dense.ba_normal_equations(problem, state)
    H2, g2 = dense.ba_normal_equations(problem, state)
    assert torch.equal(H1, H2) and torch.equal(g1, g2)


def _phong_problem(tmp_path, device):
    """The 12-state Phong sim's full-batch problem, from the VO initial guess."""
    from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
    from ceres_slam_tpu_torch.utils import sim

    path = str(tmp_path / "phong12.csv")
    sim.write_phong_track_csv(sim.generate_phong(num_states=12, num_points=200, seed=7), path)
    ds = DatasetProblemPhong.read_csv(path)
    ds.device = device
    ds.compute_initial_guess()
    return ds.build_window_problem(0, ds.num_states, *ds._window_budget(ds.num_states))[:2]


@pytest.mark.cuda
def test_phong_schur_step_is_bit_reproducible(tmp_path):
    """Two vertex-Schur steps on the card give the same bits, and the CPU's
    step to 1e-9 x max|dx| (float64: sums in another order, two Cholesky
    factorizations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem, state = _phong_problem(tmp_path, "cuda")
    step = phong_schur.phong_schur_step(problem, True, False, False)
    a, b = step(state, 1e-3), step(state, 1e-3)
    for x, y in zip(a, b):
        assert torch.isfinite(x).all() and torch.equal(x, y)
    cpu_problem, cpu_state = _phong_problem(tmp_path, "cpu")
    dx = phong_schur.phong_schur_step(cpu_problem, True, False, False)(cpu_state, 1e-3)[0]
    assert (a[0].cpu() - dx).abs().max() <= 1e-9 * dx.abs().max()


# The pose-graph, FactorGraph and checkpoint slice on the card.


def _stereo_graph(device, seed=4):
    """A FactorGraph on ``device``: 4 poses (pose 0 fixed), 24 landmarks,
    landmark 0 seen 40 times from every pose (160 slots, beyond K3's
    128-slot groups), rows shuffled; numpy from a seeded generator."""
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver.graph import FactorGraph

    rng = np.random.default_rng(seed)
    cam = StereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)
    xi = np.zeros((4, 6))
    xi[1:] = rng.normal(0, 0.1, (3, 6)) + np.array([0.1, 0.0, -0.4, 0.0, 0.0, 0.0])
    T = lie.se3_exp(torch.as_tensor(xi))
    pts = rng.uniform([-4, -3, 5], [4, 3, 14], (24, 3))
    obs = []
    for k in range(4):
        uvd = cam.project(lie.se3_transform_point(T[k], torch.as_tensor(pts))).numpy()
        for j in range(24):
            obs += [(k, j, uvd[j] + rng.normal(0, 0.2, 3)) for _ in range(40 if j == 0 else 1)]
    g = FactorGraph(cam, default_stereo_var=(0.04,) * 3, device=device)
    T0 = lie.se3_retract(T, torch.as_tensor(np.where(np.arange(4)[:, None] == 0, 0.0, 0.03)
                                            * np.ones((4, 6)))).numpy()
    for k in range(4):
        g.add_pose(T0[k], fixed=k == 0)
    for p in pts + rng.normal(0, 0.2, pts.shape):
        g.add_point(p)
    for i in rng.permutation(len(obs)):
        g.add_stereo_obs(*obs[i])
    return g


@pytest.mark.cuda
def test_factor_graph_pcg_on_the_card_runs_k2_and_k3():
    """FactorGraph(pcg) on CUDA builds the full-batch plan of rows in
    insertion order and launches K2 once per LM iteration and K3 once per
    CG iteration; the solution equals the CPU's (cost rtol 1e-9, poses
    1e-8: float64, sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k2, k3 = stereo_factor_kernel.stereo_factor_sums, schur_kernel.schur_uy
    g = _stereo_graph("cuda")
    n2, n3 = k2.launches, k3.launches
    _, summ = g.solve(linear_solver="pcg")
    assert k2.launches - n2 >= summ.iterations > 0
    assert k3.launches - n3 >= summ.linear_iterations > 0
    c = _stereo_graph("cpu")
    _, csumm = c.solve(linear_solver="pcg")
    assert summ.iterations == csumm.iterations
    assert abs(summ.final_cost - csumm.final_cost) <= 1e-9 * csumm.final_cost
    for k in range(4):
        assert np.abs(g.pose(k) - c.pose(k)).max() <= 1e-8


@pytest.mark.cuda
def test_pose_graph_and_schur_steps_are_bit_reproducible():
    """Two pose-graph normal-equation builds (a repeated edge, a reversed
    pair) and two Schur steps give the same bits on the card (F14)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver import pose_graph, schur

    rng = np.random.default_rng(5)
    K = 8
    poses = lie.se3_exp(torch.as_tensor(rng.normal(0, 0.3, (K, 6)))).cuda()
    edges = [(k, k + 1) for k in range(K - 1)] + [(1, 2), (2, 1), (3, 5), (3, 5)]
    i1 = torch.tensor([e[0] for e in edges]).cuda()
    i2 = torch.tensor([e[1] for e in edges]).cuda()
    n = len(edges)
    meas = lie.se3_retract(lie.se3_compose(poses[i2], lie.se3_inverse(poses[i1])),
                           torch.as_tensor(rng.normal(0, 0.02, (n, 6))).cuda())
    eye6 = torch.eye(6, dtype=torch.float64, device="cuda")
    problem = pose_graph.PoseGraphProblem(
        rel=pose_graph.RelPoseFactors(i1, i2, meas, 5.0 * eye6.expand(n, 6, 6),
                                      torch.ones(n, dtype=torch.bool, device="cuda")),
        priors=pose_graph.PriorFactors(torch.zeros(1, dtype=torch.int64, device="cuda"),
                                       poses[:1], 100.0 * eye6[None],
                                       torch.ones(1, dtype=torch.bool, device="cuda")),
        fixed_pose_mask=torch.zeros(K, dtype=torch.bool, device="cuda"))
    x = lie.se3_retract(poses, torch.as_tensor(rng.normal(0, 0.05, (K, 6))).cuda())
    a, b = (pose_graph.pose_graph_normal_equations(problem, x) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    plan, pts, points = stereo_factor_kernel.random_inputs(1001, 77, 13, device="cuda", seed=20)
    ba_problem, state = _problem_of(plan, pts), dense.BAState(pts, points)
    blocks = dense.ba_block_normal_equations(ba_problem, state)
    s1, s2 = (schur.schur_step(ba_problem, blocks, 1e-3) for _ in range(2))
    for u, v in zip(s1, s2):
        assert torch.isfinite(u).all() and torch.equal(u, v)


@pytest.mark.cuda
def test_resumed_pass_is_bit_equal(tmp_path, monkeypatch):
    """The flagship pass on the card, interrupted after its checkpoint at
    window 10 and resumed by a fresh dataset object, gives the
    uninterrupted pass's poses and covariances bit for bit (F14), with K1
    launching in the resumed part."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
    from ceres_slam_tpu_torch.utils import checkpoint, sim

    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    files = [str(tmp_path / n) for n in ("t.csv", "t_sun_ref.csv", "t_sun_dir_gtsun5.csv")]
    sim.write_track_csv(ds, files[0], with_covar=True)
    sim.write_ref_sun_csv(ds, files[1])
    sim.write_obs_sun_csv(ds, files[2])
    cfg = lm.SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    path = str(tmp_path / "ck.npz")

    def dataset():
        d = DatasetProblemSun.read_csv(*files)
        d.device = "cuda"
        return d

    full = dataset()
    full.solve_sliding_window(window=2, use_sun=True, config=cfg)
    solve, calls = window.solve_ba_window_with_covariance, []

    class Interrupt(Exception):
        pass

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) == 14:
            raise Interrupt
        return solve(*args, **kwargs)

    monkeypatch.setattr(window, "solve_ba_window_with_covariance", interrupted)
    with pytest.raises(Interrupt):
        dataset().solve_sliding_window(window=2, use_sun=True, config=cfg, checkpoint=path,
                                       checkpoint_every=5)
    monkeypatch.setattr(window, "solve_ba_window_with_covariance", solve)
    assert checkpoint.load(path)[0] == 10
    launches = window_kernel.window_factor_blocks_batch.launches
    resumed = dataset()
    resumed.solve_sliding_window(window=2, use_sun=True, config=cfg, checkpoint=path,
                                 checkpoint_every=5)
    assert window_kernel.window_factor_blocks_batch.launches > launches
    assert np.array_equal(resumed.poses, full.poses)
    assert np.array_equal(resumed.pose_covars, full.pose_covars)


# The 2x2 subproblem of SUBSPACE_DOGLEG (ops/subspace_kernel.py): the kernel
# equals its plain version on the card bit for bit (every operation rounded
# as PyTorch rounds it), NaN where the model is not finite. One warp a
# window, 4 a block: B 1, 2, 15 and 67 leave the last block part empty.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 2, 15, 40, 64, 67])
def test_subspace_kernel_matches_plain(B, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, radius = subspace_kernel.random_models(B, dtype, "cuda", seed=B)
    before = subspace_kernel.subspace_step.launches
    got = subspace_kernel.subspace_step(model, radius)
    torch.cuda.synchronize()
    assert subspace_kernel.subspace_step.launches == before + 1
    ref = subspace_kernel.subspace_step_plain(model, radius)
    assert got.shape == (B, 3) and torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_op_latency_probe(dtype):
    """The latency probe (apps/probe_op_latency.py, csrc/op_chain.cu) builds,
    launches and gives every kind of the subspace kernel's chain a positive
    latency; the bound is the chain at those latencies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import probe_op_latency as probe

    lat = probe.op_latencies(dtype, n=1 << 12, reps=3)
    assert set(lat) == set(probe.CHAIN) and all(v > 0 for v in lat.values()), lat
    assert probe.latency_bound_us(lat) == pytest.approx(
        sum(n * lat[k] for k, n in probe.CHAIN.items()) / 1e3)


# The window trust-region loops in a conditional WHILE node
# (solver/window.py): the same bits as the host loop, K1 and the subspace
# kernel counted per iteration the card ran, one capture per shape, and no
# host launch, sync or copy per iteration.

def _loop_windows(tmp_path, starts, dtype="float64"):
    """Windows [k, k + 2) of a 24-state triangle sim with prior and sun, as
    ``(problem, state)`` on the host padded to the pass's shape, with the
    pass's ``(O_pad, widths)``."""
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
    from ceres_slam_tpu_torch.utils import sim

    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    base = str(tmp_path / "w24")
    sim.write_track_csv(ds, base + ".csv", with_covar=True)
    sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
    sim.write_obs_sun_csv(ds, base + "_sun_dir.csv")
    d = DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv", base + "_sun_dir.csv")
    d.dtype, d.device = dtype, "cpu"
    n_obs, n_pts, o_pad = d._window_budget(2)
    out = []
    for k in starts:
        d.compute_initial_guess(k, k + 2)
        problem, state, _ = d.build_window_problem(
            k, k + 2, n_obs, n_pts, prior=d._window_prior(k), sun=d._window_sun(k, k + 2),
            gauge_fix_first=False, device="cpu")
        out.append((problem, state))
        d.reset_points()
    return out, o_pad, d._table_widths(2)


def _same(a, b):
    for x, y in zip(window._leaves(a), window._leaves(b)):
        assert torch.equal(torch.isnan(x), torch.isnan(y)) if x.is_floating_point() else True
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


_LOOP_CFG = dict(max_iters=40, nonmonotonic=True, ftol=1e-8, xtol=1e-10, record_history=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_window_device_loop_equals_host_loop(tmp_path, strategy, B, dtype):
    """The loop in the WHILE node against ``host_loop`` (the same body on
    the host): the same bits (state, blocks, every summary statistic with
    the history), K1 once per iteration the card ran and the windows it
    served counted B a launch, the subspace kernel once per dogleg
    iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    windows, o_pad, widths = _loop_windows(tmp_path, [3, 8, 15][:B], dtype)
    layout, state = window.windows_batch(windows, o_pad, widths, device="cuda")
    cfg = lm.SolveConfig(**_LOOP_CFG)
    host = window.run_loop(layout, state, cfg, strategy, loop="host")
    k1, sub = window_kernel.window_factor_blocks_batch, subspace_kernel.subspace_step
    before = (k1.launches, k1.windows, sub.launches)
    graph = window.WindowGraph()
    dev = window.run_loop(layout, state, cfg, strategy, loop="device", graph=graph)
    torch.cuda.synchronize()
    node = next(iter(graph.loops.values()))[2]
    n = int(dev[1][:, 0].max())
    assert n > 1 and node.count.item() == n
    # one launch to start, one to warm the capture up, then one a node iteration
    assert k1.launches - before[0] == n + 2 and k1.windows - before[1] == B * (n + 2)
    assert sub.launches - before[2] == (n + 1 if strategy == "dogleg" else 0)
    graph.close()
    _same(dev, host)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["lm", "dogleg"])
def test_window_graph_reuse_equals_host_loop(tmp_path, strategy):
    """A ``WindowGraph`` captures once for windows of one shape: the second
    window copies its ``loop_inputs`` in and restarts the loop, and gives
    the host loop's bits; a batch of another B takes a capture of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    windows, o_pad, widths = _loop_windows(tmp_path, [3, 12, 17])
    cfg = lm.SolveConfig(**_LOOP_CFG)
    graph, stats = window.WindowGraph(), window.GRAPH_STATS
    before = (stats["captures"], stats["restarts"])
    for w in windows[:2]:
        layout, state = window.windows_batch([w], o_pad, widths, device="cuda")
        _same(window.run_loop(layout, state, cfg, strategy, loop="device", graph=graph),
              window.run_loop(layout, state, cfg, strategy, loop="host"))
    assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (1, 1)
    layout, state = window.windows_batch(windows[1:], o_pad, widths, device="cuda")
    _same(window.run_loop(layout, state, cfg, strategy, loop="device", graph=graph),
          window.run_loop(layout, state, cfg, strategy, loop="host"))
    assert stats["captures"] - before[0] == 2 and len(graph.loops) == 2
    graph.close()


@pytest.mark.cuda
def test_window_node_makes_no_host_work_per_iteration(tmp_path):
    """A restarted dogleg loop under torch.profiler with 3 and with 12
    iterations (run_full_budget): the same host launches, syncs and copies,
    so none per iteration inside the node."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    windows, o_pad, widths = _loop_windows(tmp_path, [3])
    layout, state = window.windows_batch(windows, o_pad, widths, device="cuda")
    counts = {}
    for n in (3, 12):
        cfg = lm.SolveConfig(max_iters=n, run_full_budget=True)
        graph = window.WindowGraph()
        window.run_loop(layout, state, cfg, "dogleg", loop="device", graph=graph)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, stats, _ = window.run_loop(layout, state, cfg, "dogleg", loop="device",
                                          graph=graph)
            torch.cuda.synchronize()
        graph.close()
        assert int(stats[0, 0].item()) == n
        host = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
        counts[n] = (sum(x.startswith("cudaLaunchKernel") for x in host),
                     sum("Synchronize" in x for x in host),
                     sum(x.startswith("cudaMemcpy") for x in host))
    assert counts[3] == counts[12], counts


# The full-batch LM loop in a WHILE node with the CG loop's nested in it
# (solver/lm.py, solver/pcg.py): the host LM loop's bits, K2 once per LM
# iteration and K3 once per CG iteration the card ran, and no host work
# per LM iteration.

def _lm_problem(dtype, seed=16):
    plan, poses, points = stereo_factor_kernel.random_inputs(12992, 448, 200, dtype, "cuda",
                                                             seed=seed)
    return _problem_of(plan, poses), dense.BAState(poses, points)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f64", "f32", "banded"])
def test_lm_node_equals_host_lm_loop(case):
    """``solve_ba_pcg`` with the LM loop in the WHILE node (the CG loop's
    node nested in it) against ``lm_loop="host"`` around the CG loop's own
    node and around the host CG loop, at triangle200's full-batch shape:
    the same LM and CG iterations, summary (the history included), poses
    and points bit for bit; a second solve through the same ``LMGraph``
    restarts the capture and gives the same bits; in every run K2 launches
    once per LM iteration and K3 once per CG iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype = torch.float32 if case == "f32" else torch.float64
    problem, state = _lm_problem(dtype)
    precond = "banded" if case == "banded" else "jacobi"
    cfg = lm.SolveConfig(max_iters=10, nonmonotonic=True, ftol=1e-9, xtol=1e-12,
                         record_history=True)
    k2, k3 = stereo_factor_kernel.stereo_factor_sums, schur_kernel.schur_uy
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    before = (stats["captures"], stats["restarts"])
    runs = []
    for cg_loop, lm_loop in (("host", "host"), ("device", "host"), ("device", "device"),
                             ("device", "device")):
        n2, n3 = k2.launches, k3.launches
        sol, summ = pcg.solve_ba_pcg(problem, state, cfg, precond=precond, loop=cg_loop,
                                     lm_loop=lm_loop, graph=graph if lm_loop == "device" else None)
        torch.cuda.synchronize()
        assert (k2.launches - n2, k3.launches - n3) == (summ.iterations, summ.linear_iterations)
        assert summ.linear_iterations > summ.iterations > 2
        runs.append((sol, summ))
    assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (1, 1)
    graph.close()
    ref, rs = runs[0]
    for sol, summ in runs[1:]:
        for a, b in zip(summ, rs):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(sol.poses, ref.poses) and torch.equal(sol.points, ref.points)


@pytest.mark.cuda
def test_lm_node_makes_no_host_work_per_iteration():
    """A restarted LM loop in the WHILE node under torch.profiler with 3
    and with 12 LM iterations (run_full_budget; ~20 CG iterations each):
    the same host launches, syncs and copies, so none per LM iteration nor
    per CG iteration inside the nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem, state = _lm_problem(torch.float64)
    st = problem.stereo
    tables = pcg.build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), 200, 448, device="cuda")
    plan = full_batch_plan.plan_for_problem(problem)
    counts = {}
    for n in (3, 12):
        cfg = lm.SolveConfig(max_iters=n, run_full_budget=True)
        graph = lm.LMGraph()

        def solve():
            return pcg.solve_ba_pcg(problem, state, cfg, tables=tables, plan=plan,
                                    precond="jacobi", graph=graph)

        solve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, summ = solve()
            torch.cuda.synchronize()
        graph.close()
        assert summ.iterations == n and summ.linear_iterations > n
        host = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
        counts[n] = (sum(x.startswith("cudaLaunchKernel") for x in host),
                     sum("Synchronize" in x for x in host),
                     sum(x.startswith("cudaMemcpy") for x in host))
    assert counts[3] == counts[12], counts


@pytest.mark.cuda
def test_nested_device_while_counts():
    """A WHILE node nested in another's body (``graph_loop.while_loop``
    inside a ``DeviceWhile``'s capture): the outer loop runs 4 times, the
    inner one i times in the outer iteration i, 10 in all, which the card
    counts beside the outer loop's; each counted wrapper gets its counts
    per iteration of its own loop. A second run gives the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.ops import graph_loop

    def outer_kernel():
        outer_kernel.launches += 1

    def inner_kernel():
        inner_kernel.launches += 1

    outer_kernel.launches = inner_kernel.launches = 0
    z = lambda: torch.zeros(1, dtype=torch.int32, device="cuda")  # noqa: E731
    i, j, total, pred, pred_in = z(), z(), z(), z(), z()

    def inner():
        inner_kernel()
        j.add_(1)
        total.add_(1)
        pred_in.copy_(j < i)

    def outer():
        outer_kernel()
        i.add_(1)
        j.zero_()
        pred_in.copy_(j < i)
        graph_loop.while_loop(inner, pred_in, counted=(inner_kernel,))
        pred.copy_(i < 4)

    pred.fill_(1)
    loop = graph_loop.DeviceWhile(outer, pred, counted=(outer_kernel,))
    assert (outer_kernel.launches, inner_kernel.launches) == (0, 0)
    assert loop.run() == 4 and loop.inner_iterations == [10]
    assert (int(i), int(total)) == (4, 10)
    assert (outer_kernel.launches, inner_kernel.launches) == (4, 10)
    i.zero_(), total.zero_(), pred.fill_(1)
    assert loop.run() == 4 and loop.inner_iterations == [10] and int(total) == 10
    loop.close()


@pytest.mark.cuda
def test_nested_while_needs_cuda_12_4(monkeypatch):
    """Where the toolkit, the driver or PyTorch's runtime is older than
    CUDA 12.4, a loop nested in a device loop is refused with the reason
    (no host loop instead), and the next device loop still builds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.ops import graph_loop

    graph_loop.build()
    real = graph_loop.versions()
    pred, inner = (torch.ones(1, dtype=torch.int32, device="cuda") for _ in range(2))

    def body():
        inner.fill_(0)
        graph_loop.while_loop(lambda: inner.fill_(0), inner)
        pred.fill_(0)

    monkeypatch.setattr(graph_loop, "versions", lambda: {**real, "driver": (12, 3)})
    with pytest.raises(RuntimeError, match=r"12\.4 or newer \(nested conditional graph nodes\)"):
        graph_loop.DeviceWhile(body, pred)
    monkeypatch.setattr(graph_loop, "versions", lambda: real)
    pred.fill_(1)
    loop = graph_loop.DeviceWhile(body, pred)
    assert loop.run() == 1 and loop.inner_iterations == [0]
    loop.close()


# The Phong BA LM loop in a WHILE node (solver/phong.py, solver/phong_schur.py):
# each stage one node, the host loop's bits, no host work per LM iteration,
# and a later window of a pass restarting the capture of the first.

def _phong_pass(tmp_path, device, solver, dtype="float64"):
    """The 12-state Phong sim's problems: the full batch (vertex-Schur) or
    windows 0 and 3 of its ``--window 5`` pass (dense), from the VO initial
    guess, with the pass's table widths."""
    from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
    from ceres_slam_tpu_torch.utils import sim

    path = str(tmp_path / "phong12.csv")
    if not (tmp_path / "phong12.csv").exists():
        sim.write_phong_track_csv(sim.generate_phong(num_states=12, num_points=200, seed=7), path)
    ds = DatasetProblemPhong.read_csv(path)
    ds.device, ds.dtype = device, dtype
    ds.compute_initial_guess()
    window = ds.num_states if solver == "schur" else 5
    budget = ds._window_budget(window)
    widths = ds._table_widths(window)
    starts = [0] if solver == "schur" else [0, 3]
    return [ds.build_window_problem(k1, k1 + window, *budget)[:2] for k1 in starts], widths


def _same_solve(a, b):
    (sa, ma), (sb, mb) = a, b
    for x, y in zip(ma, mb):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_phong_node_equals_host_loop(tmp_path, solver, dtype):
    """``solve_phong_staged`` (3 stages) with each stage's LM loop in a WHILE
    node against the host loop, on phong12: the same iterations, summaries
    (the history included) and state bit for bit; one capture a stage. A
    second window of the pass through the same ``LMGraph`` restarts the
    three captures (no new one) and again gives the host loop's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.solver import phong

    problems, widths = _phong_pass(tmp_path, "cuda", solver, dtype)
    if solver == "schur":
        problems = problems * 2  # the restart on the same problem
    cfg = lm.SolveConfig(max_iters=30, ftol=1e-8, record_history=True)
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    for i, (problem, state) in enumerate(problems):
        before = (stats["captures"], stats["restarts"])
        runs = {loop: phong.solve_phong_staged(
            problem, state, cfg, multistage=True, linear_solver=solver, lm_loop=loop,
            graph=graph if loop == "device" else None, widths=widths)
            for loop in ("host", "device")}
        torch.cuda.synchronize()
        assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (
            (3, 0) if i == 0 else (0, 3))
        (sh, mh), (sd, md) = runs["host"], runs["device"]
        assert len(mh) == len(md) == 3 and all(m.iterations >= 1 for m in mh)
        for a, b in zip(md, mh):
            _same_solve((sd, a), (sh, b))
    graph.close()


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_phong_node_makes_no_host_work_per_iteration(tmp_path, solver):
    """A restarted Phong joint-stage LM loop in its WHILE node under
    torch.profiler with 3 and with 12 LM iterations (run_full_budget): the
    same host launches, syncs and copies, so none per LM iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ceres_slam_tpu_torch.solver import phong

    [(problem, state), *_], widths = _phong_pass(tmp_path, "cuda", solver)
    tables = phong.solve_tables(problem, state, solver, widths)
    kw = {"layout" if solver == "schur" else "tables": tables}
    counts = {}
    for n in (3, 12):
        cfg = lm.SolveConfig(max_iters=n, run_full_budget=True)
        graph = lm.LMGraph()

        def solve():
            return phong.solve_phong_ba(problem, state, cfg, linear_solver=solver, graph=graph,
                                        **kw)

        solve()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, summ = solve()
            torch.cuda.synchronize()
        graph.close()
        assert summ.iterations == n
        host = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
        counts[n] = (sum(x.startswith("cudaLaunchKernel") for x in host),
                     sum("Synchronize" in x for x in host),
                     sum(x.startswith("cudaMemcpy") for x in host))
    assert counts[3] == counts[12], counts


# The dense-system LM loops in WHILE nodes (solver/dense.py, solver/schur.py,
# solver/pose_graph.py) and blowup's chain as one node with each step's LM loop
# nested in it (apps/blowup.py): the host forms' bits, no host work per step.

def _host_counts(fn):
    """Host launches, graph launches, syncs and copies of one call of ``fn``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    host = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
    return (sum(x.startswith("cudaLaunchKernel") for x in host),
            sum(x.startswith("cudaGraphLaunch") for x in host),
            sum("Synchronize" in x for x in host),
            sum(x.startswith("cudaMemcpy") for x in host))


@pytest.mark.cuda
def test_blowup_chain_node_equals_host_form():
    """``blowup.run_chain(31)`` with the chain in its WHILE node (each
    step's LM loop a node nested in it) against the host form: every
    covariance, closed form and step's LM iteration count bit for bit, one
    capture; the deviation from the closed form below 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import blowup

    node = blowup.run_chain(31, device="cuda", chain_loop="device")
    host = blowup.run_chain(31, device="cuda", chain_loop="host")
    for a, b in zip(node[:3], host[:3]):
        np.testing.assert_array_equal(a, b)
    assert node[3]["captures"] == 1 and host[3]["captures"] == 0
    assert node[3]["steps"] == host[3]["steps"] == 30
    covs, manuals = node[0], node[1]
    rel = np.abs(covs - manuals).max(axis=(1, 2)) / np.abs(manuals).max(axis=(1, 2))
    assert rel.max() < 1e-6


@pytest.mark.cuda
def test_blowup_chain_node_makes_no_host_work_per_step():
    """The chain in its node at 11 and at 31 poses under torch.profiler:
    the same host launches, graph launches, syncs and copies, so none per
    chain step nor per LM iteration inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import blowup

    blowup.run_chain(11, device="cuda")
    counts = {n: _host_counts(lambda: blowup.run_chain(n, device="cuda")) for n in (11, 31)}
    assert counts[11] == counts[31], counts
    assert counts[11][1] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_dense_node_equals_host_loop(solver, dtype):
    """``dense.solve_ba`` / ``schur.solve_ba_schur`` with the LM loop in its
    WHILE node against the host loop on two problems of one shape (tables
    at common widths): the same summaries (the history included) and
    state bit for bit; the second problem restarts the first's capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.solver import schur

    solve = dense.solve_ba if solver == "dense" else schur.solve_ba_schur
    problems = []
    for seed in (20, 21):
        plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, dtype, "cuda",
                                                                 seed=seed)
        problems.append((_problem_of(plan, poses), dense.BAState(poses, points)))
    widths = tuple(max(t) for t in zip(*[[x.shape[1] for x in dense.block_tables(p)]
                                         for p, _ in problems]))
    cfg = lm.SolveConfig(max_iters=10, nonmonotonic=True, ftol=1e-9, xtol=1e-12,
                         record_history=True)
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    for i, (problem, state) in enumerate(problems):
        before = (stats["captures"], stats["restarts"])
        node = solve(problem, state, cfg, lm_loop="device", graph=graph, widths=widths)
        host = solve(problem, state, cfg, lm_loop="host", widths=widths)
        torch.cuda.synchronize()
        assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (
            (1, 0) if i == 0 else (0, 1))
        assert host[1].iterations > 2
        _same_solve(node, host)
    graph.close()


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_factor_graph_defaults_to_the_node(solver):
    """``FactorGraph(dense|schur).solve()`` at its default on the card runs
    the LM loop in a WHILE node (one capture) and gives ``lm_loop='host'``'s
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stats = lm.GRAPH_STATS
    before = stats["captures"]
    a = _stereo_graph("cuda").solve(linear_solver=solver)
    assert stats["captures"] - before == 1
    b = _stereo_graph("cuda").solve(linear_solver=solver, lm_loop="host")
    assert stats["captures"] - before == 1
    _same_solve(a, b)


@pytest.mark.cuda
def test_pose_graph_node_equals_host_loop():
    """``solve_pose_graph`` with its LM loop in a WHILE node against the host
    loop on an 8-pose graph (a repeated edge, a reversed pair): the same
    poses and summary bit for bit; a second solve through the same
    ``LMGraph`` from another start restarts the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver import pose_graph

    rng = np.random.default_rng(6)
    K = 8
    poses = lie.se3_exp(torch.as_tensor(rng.normal(0, 0.3, (K, 6)))).cuda()
    edges = [(k, k + 1) for k in range(K - 1)] + [(1, 2), (2, 1), (3, 5), (3, 5)]
    i1 = torch.tensor([e[0] for e in edges]).cuda()
    i2 = torch.tensor([e[1] for e in edges]).cuda()
    n = len(edges)
    meas = lie.se3_retract(lie.se3_compose(poses[i2], lie.se3_inverse(poses[i1])),
                           torch.as_tensor(rng.normal(0, 0.02, (n, 6))).cuda())
    eye6 = torch.eye(6, dtype=torch.float64, device="cuda")
    problem = pose_graph.PoseGraphProblem(
        rel=pose_graph.RelPoseFactors(i1, i2, meas, 5.0 * eye6.expand(n, 6, 6),
                                      torch.ones(n, dtype=torch.bool, device="cuda")),
        priors=pose_graph.PriorFactors(torch.zeros(1, dtype=torch.int64, device="cuda"),
                                       poses[:1], 100.0 * eye6[None],
                                       torch.ones(1, dtype=torch.bool, device="cuda")),
        fixed_pose_mask=torch.zeros(K, dtype=torch.bool, device="cuda"))
    cfg = lm.SolveConfig(max_iters=20, record_history=True)
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    before = (stats["captures"], stats["restarts"])
    for scale in (0.05, 0.1):
        x0 = lie.se3_retract(poses, torch.as_tensor(rng.normal(0, scale, (K, 6))).cuda())
        node = pose_graph.solve_pose_graph(problem, x0, cfg, lm_loop="device", graph=graph)
        host = pose_graph.solve_pose_graph(problem, x0, cfg, lm_loop="host")
        assert host[1].iterations > 2
        _same_solve(((node[0],), node[1]), ((host[0],), host[1]))
    assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (1, 1)
    graph.close()


# The dense frame pair on the card (solver/photometric.py, frontend/dense_stereo.py):
# the photometric LM loop as one WHILE node with K4 inside, the matcher as one
# captured graph, and the dense dogleg (solver/lm.py) as a WHILE node.

def _photometric_pairs(dtype, n=2):
    """``n`` ``--gt-disparity`` problems at 96x128 on the card, one shape and
    key (seeds 0, 1, ...: other noise, another start)."""
    from ceres_slam_tpu_torch.apps import dense_stereo

    return [dense_stereo.synthetic_problem(96, 128, seed=s, dtype=dtype, device="cuda")[:2]
            for s in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_photometric_node_equals_host_loop(dtype):
    """``solve_photometric`` with its LM loop in a WHILE node against the
    host loop on two pairs of one shape: the same summaries (the history
    included) and state bit for bit, K4 counted alike (two launches an LM
    iteration and one for the start); the second pair restarts the first's
    capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.solver import photometric as ph

    k4 = bilinear_kernel.bilinear_sample_packed
    cfg = lm.SolveConfig(max_iters=25, nonmonotonic=True, ftol=1e-12, record_history=True)
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    for i, (problem, state) in enumerate(_photometric_pairs(dtype)):
        before = (stats["captures"], stats["restarts"])
        runs = {}
        for loop in ("device", "host"):
            k4.launches = 0
            runs[loop] = ph.solve_photometric(problem, state, cfg, lm_loop=loop,
                                              graph=graph if loop == "device" else None)
            torch.cuda.synchronize()
            runs[loop] += (k4.launches,)
        assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (
            (1, 0) if i == 0 else (0, 1))
        (sd, md, kd), (sh, mh, kh) = runs["device"], runs["host"]
        assert mh.iterations > 3 and kd == kh == 2 * mh.iterations + 1
        _same_solve((sd, md), (sh, mh))
    graph.close()


@pytest.mark.cuda
def test_photometric_node_makes_no_host_work_per_iteration():
    """A restarted photometric LM node under torch.profiler with 3 and with
    12 LM iterations (run_full_budget, float32): the same host launches,
    graph launches, syncs and copies, so none per LM iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.solver import photometric as ph

    (problem, state), = _photometric_pairs(torch.float32, 1)
    counts = {}
    for n in (3, 12):
        cfg = lm.SolveConfig(max_iters=n, ftol=0.0, gtol=0.0, run_full_budget=True)
        graph = lm.LMGraph()
        ph.solve_photometric(problem, state, cfg, graph=graph)
        counts[n] = _host_counts(lambda: ph.solve_photometric(problem, state, cfg, graph=graph))
        graph.close()
    assert counts[3] == counts[12], counts
    assert counts[3][1] == 1


@pytest.mark.cuda
def test_matcher_graph_equals_eager():
    """``match_disparity`` replayed from one captured graph against its
    eager launches (``loop="host"``) at 96x128, float32, on two pairs of one
    shape: disparity and mask bit for bit; the second pair replays the
    first's capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.frontend import dense_stereo as front

    out = dense_stereo.make_scene(96, 128, stereo=True, device="cuda")
    rng = np.random.default_rng(3)
    pair = (out[1].float(), out[7].float())
    pairs = [pair, tuple(x + torch.as_tensor(rng.normal(0, 0.02, x.shape), dtype=x.dtype,
                                             device="cuda") for x in pair)]
    graph, stats = front.MatcherGraph(), front.MATCH_STATS
    before = stats["captures"]
    for left, right in pairs:
        got = front.match_disparity(left, right, max_disp=32, loop="device", graph=graph)
        ref = front.match_disparity(left, right, max_disp=32, loop="host")
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert ref[1].float().mean() > 0.4
    assert stats["captures"] - before == 1
    graph.close()


@pytest.mark.cuda
def test_dense_pairs_restart_the_captures():
    """``dense_stereo.run_pairs`` (the full chain at 96x128, three pairs)
    with the LM node and the captured matcher against both host forms: each
    pair's costs, iterations, pose and matcher error bit for bit; in the
    device form the first pair captures both, every later pair restarts the
    node and replays the matcher."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import dense_stereo

    runs = {loop: dense_stereo.run_pairs(3, H=96, W=128, frontend=True, max_disp=32,
                                         verbose=False, lm_loop=loop, match_loop=loop)
            for loop in ("device", "host")}
    for i, (dev, host) in enumerate(zip(runs["device"], runs["host"])):
        assert dev[0] == host[0] and dev[1:3] == host[1:3] and dev[0].iterations > 1
        for k in ("T", "pixels_valid", "matcher_median_derr"):
            assert dev[3][k] == host[3][k]
        got = tuple(dev[3][k] for k in ("lm_graph_captures", "lm_graph_restarts",
                                        "match_graph_captures"))
        assert got == ((1, 0, 1) if i == 0 else (0, 1, 0))


@pytest.mark.cuda
def test_dogleg_node_equals_host_loop():
    """``dense.solve_ba(strategy="dogleg")`` with its loop in a WHILE node
    against the host loop on two problems of one shape (tables at common
    widths): the same summary and state bit for bit; the second restarts
    the first's capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problems = []
    for seed in (20, 21):
        plan, poses, points = stereo_factor_kernel.random_inputs(1001, 77, 13, torch.float64,
                                                                 "cuda", seed=seed)
        problems.append((_problem_of(plan, poses), dense.BAState(poses, points)))
    widths = tuple(max(t) for t in zip(*[[x.shape[1] for x in dense.block_tables(p)]
                                         for p, _ in problems]))
    cfg = lm.SolveConfig(max_iters=10)
    graph, stats = lm.LMGraph(), lm.GRAPH_STATS
    for i, (problem, state) in enumerate(problems):
        before = (stats["captures"], stats["restarts"])
        node = dense.solve_ba(problem, state, cfg, strategy="dogleg", graph=graph, widths=widths)
        host = dense.solve_ba(problem, state, cfg, strategy="dogleg", lm_loop="host",
                              widths=widths)
        torch.cuda.synchronize()
        assert (stats["captures"] - before[0], stats["restarts"] - before[1]) == (
            (1, 0) if i == 0 else (0, 1))
        assert host[1].iterations > 1
        _same_solve(node, host)
    graph.close()


@pytest.mark.cuda
def test_frame_graph_equals_host_frames():
    """Live VO on the card: six rendered frames with each tracked frame as
    ``FrameGraph``'s two replays around the eager SVD, and launch by launch,
    give the same trajectory and counts bit for bit; the pairs alternate
    between tensors on the card and host arrays (the staging copy), with
    eager work that churns the allocator between frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceres_slam_tpu_torch.apps import stereo_vo as app
    from ceres_slam_tpu_torch.frontend import stereo_vo
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera

    cam = StereoCamera.create(140.0, 140.0, 80.0, 60.0, 0.4)
    frames, _ = app._render_synthetic(cam, 6, device="cuda")
    runs, before = {}, dict(stereo_vo.FRAME_STATS)
    for loop in ("host", "device"):
        vo = stereo_vo.OnlineStereoVO(cam, device="cuda", frame_loop=loop)
        for i, (left, right) in enumerate(frames):
            if i % 2:
                left, right = left.cpu().numpy(), right.cpu().numpy()
            vo.process(left, right)
            junk = torch.randn(257, 129, device="cuda", dtype=torch.float64)
            (junk @ junk.T).sum()
        runs[loop] = (torch.stack(vo.trajectory), torch.stack(vo.counts))
        vo.close()
    assert stereo_vo.FRAME_STATS["captures"] - before["captures"] == 1
    assert torch.equal(runs["device"][0], runs["host"][0])
    assert torch.equal(runs["device"][1], runs["host"][1])
    assert (runs["host"][1][1:, 2] > 30).all()
