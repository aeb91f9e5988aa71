#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (``--phases`` selects a subset, for bring-up; the default runs all):

  device   the card's name and power limit (nvidia-smi), torch and CUDA versions
  build    compiles the kernels K1 (csrc/window_factor_blocks.cu), K2
           (csrc/stereo_factor_blocks.cu), K3 (csrc/schur_uy.cu) and K4
           (csrc/bilinear_sample_imgs.cu) with nvcc, one process each, all
           started together
  kernels  each kernel against its plain PyTorch version on the card, in
           float64 and float32, with median times per call (CUDA events
           around the wrapper, host included): K1 at the flagship window
           shape (K=2, J=192, O=2) and the S scale (K=64, J=2048, 16,384
           slots), called twice for equal bits; K2 (fused with its pose and
           landmark sums) and K3 (bound to the full-batch plan) at the
           full-batch shapes of triangle200 (N 12,992, J 448, K 200) and
           kitti1100 (N 124,480, J 16,640, K 1,100), called twice for equal
           bits, with host time per call back to back; K4 at the photometric shape
           (3x240x320, N 68,096) and at KITTI's full resolution (3x375x1242,
           N 440,134), equal to its plain versions bit for bit, its packing
           (once per solve) timed apart, beside one
           torch.nn.functional.grid_sample call (its yardstick, which the
           port never calls); and the host cost of the two ways to read
           PyTorch's current stream
  slice    generates triangle200 and kitti1100 with the port's make_sim and
           runs both CLIs on CUDA: the flagship sliding window (dataset_vo_sun,
           triangle200 float64 and float32, kitti1100 float64; K1 launch
           counts and ATE against the JAX figures) and full-batch BA
           (dataset_vo --window 0, the same three runs; K2 and K3 launch
           counts, final cost and ATE against the JAX figures), plus one
           banded-preconditioner solve of the triangle200 full problem
  dense    dense photometric alignment through the dense_stereo CLI at
           240x320 (68,096 aligned pixels), float64: rendered disparities
           (--gt-disparity) against the JAX figures, the full chain (SGM,
           Sobel, alignment) against the JAX figures, and --images on three
           rendered .npy files; then the photometric rate of
           scripts/bench_xl.py (float32, 20 LM iterations under
           run_full_budget, 3 timed repetitions after a warm-up); K4
           launches at least twice per LM iteration
  cpu      triangle200 float64 once more on the CPU, through both BA CLIs
           (poses must equal the CUDA runs' to 1e-6; all runs draw the same
           RANSAC hypotheses: seed 42 + pair, the threefry draw is integer
           arithmetic, the same bits on either device), and the dense
           --gt-disparity run (pose equal to the CUDA run's to 1e-8)
  profile  torch.profiler, last, so that no profiler session precedes a
           timed run: the device time per call (the sum of its kernels) of
           every kernel checked in the kernels phase (and of grid_sample)
           with the share of its bound, failing unless K1 runs one device
           kernel per call and K2 and K3 two; for K2 and K3 each kernel's
           (phase's) time and the device time per call of calls back to
           back, the gaps between kernels included; K4's device time on the path's own
           coordinates (the 240x320 problem's projections, float64 and
           float32); kitti1100's full problem (float64): one
           build_obs_blocks and one CG iteration (device time, kernels,
           launches, syncs, copies); and a trace of one photometric rate
           solve (device busy share, launches per LM iteration). It runs
           whenever the kernels phase runs with no main-path phase (slice,
           dense) after it.

Any failure exits non-zero before the result line. The last line of
standard output is ``{"ok": true, "device": {...}}``; before it come the
kernel table as JSON and the card's name and power limit. Each kernel's
``bound_ms`` is the larger of its bytes (inputs read once, outputs written
once, at this run's shapes) over 3.35 TB/s and its operations over the
H100's peak outside the tensor cores (67 TFLOP/s float32, 34 TFLOP/s
float64). Imports nothing of JAX or ``ceres_slam_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

# the port must run without JAX and without the JAX package
sys.modules["jax"] = None
sys.modules["ceres_slam_tpu"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "slice", "dense", "cpu", "profile")

# JAX package reference ATEs [m] (f64, --window 2, gtsun10 obs file), and
# the relative bound each run is held to: the 1,100-window chain gets a
# looser one, its ATE is sensitive to small differences along the chain.
JAX_ATE = {"triangle200": {"vo": 0.3079, "sun": 0.3252},
           "kitti1100": {"vo": 10.1957, "sun": 9.4062}}
ATE_BOUND = {"triangle200": 0.15, "kitti1100": 0.30}

# JAX package reference figures of full-batch BA (dataset_vo --window 0,
# float64, on a CPU): final cost and ATE [m]. The bounds: triangle200
# converges in 6 LM iterations to the same minimum on every backend (cost
# rtol 1e-6, ATE to 4 decimals); kitti1100 takes ~140 nonmonotonic LM
# iterations, and the port on the CPU lands 0.14% (cost) and 0.30% (ATE)
# from JAX there (PERF.md), so a different summation order may move it:
# 2% on the cost and 3% on the ATE.
JAX_FULL = {"triangle200": (1.836544e+04, 0.0088), "kitti1100": (2.216621e+06, 35.2755)}
FULL_COST_RTOL = {"triangle200": 1e-6, "kitti1100": 0.02}
FULL_ATE_ATOL = {"triangle200": 0.00005, "kitti1100": 0.03 * 35.2755}

# kernel vs plain tolerances, relative to the largest reference entry:
# float64 rounding only. float32: K1 as tests/test_window.py holds the
# Pallas kernel to the XLA assembly (accumulation-order noise, gradients
# cancel); K2 as tests/test_torch_pcg.py holds its plain version to the
# Pallas kernel (x max(1, max|ref|)); K3 2e-5 x (max|ref| + 1), as
# tests/test_pallas.py holds the Pallas matvec.
TOL64 = 1e-12
TOL32 = {"hll": 1e-5, "u": 1e-5, "gl": 5e-3, "hpp": 1e-5, "gp": 5e-3, "pcost": 1e-4,
         "cost": 1e-4}
COST_RTOL32 = 1e-4
K2_TOL32 = {"U18": 1e-4, "Hpp": 1e-4, "Hll": 1e-4, "gp": 5e-3, "gl": 5e-3}
K3_TOL32 = 2e-5
FULL_SHAPES = {"triangle200": (12992, 448, 200), "kitti1100": (124480, 16640, 1100)}

# K4 shapes (C, H, W, N): the photometric path's 240x320 with its 68,096
# aligned pixels, and KITTI's full resolution with 440,134 points. The
# kernel rounds as its plain versions do (no FMA contraction), so it must
# equal them bit for bit, in both dtypes, at every point (NaN where they
# are NaN). grid_sample (border padding, corners
# aligned) computes the same function on the in-bounds points, through a
# coordinate normalization that rounds at ~W x eps: 1e-9 (f64) and 1e-4
# (f32) absolute.
K4_SHAPES = {"240x320": (3, 240, 320, 68096), "375x1242": (3, 375, 1242, 440134)}
K4_LIB_TOL = {"f64": 1e-9, "f32": 1e-4}

# bounds: HBM bytes/s and peak operations/s outside the tensor cores (H100
# SXM data sheet), and the operations per row each kernel does, counted
# from its source (K1 per slot, K2 per observation, K3 per observation,
# K4 per point and channel plus the index arithmetic)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12}
OPS_PER_ROW = {"K1": 750, "K2": 650, "K3": 90}
K4_OPS = (6, 9)

# JAX package reference figures of dense_stereo at 240x320 (float64, seed
# 0, on a CPU). --gt-disparity: the port on the CPU lands 8.4e-15 (cost)
# and 7e-13 relative (final pose error) from them, the rounding floor of a
# 68,096-term sum, which the card reorders again: bounds 1e-12 relative on
# the cost and 1e-10 absolute on the pose errors. Full chain (SGM, max_disp
# 48): the float32 matcher's order moves a few disparities, so the valid
# pixels within 0.5%, the median disparity error within 0.01 px and the
# final pose error within 25%.
JAX_DENSE_GT = {"iterations": 17, "final_cost": 1.9217444021313948e-01,
                "err0": 0.057575438090236374, "err1": 1.7889717220419588e-04}
DENSE_GT_COST_RTOL, DENSE_GT_ERR_ATOL = 1e-12, 1e-10
JAX_DENSE_CHAIN = {"pixels_valid": 66653, "matcher_median_derr": 0.124,
                   "err1": 1.2379311009159493e-03}
DENSE_ARGS = ["--height", "240", "--width", "320", "--max-disp", "48"]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def phase_device(torch):
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build(kernels):
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(kernels)) as ex:
            paths = dict(zip(kernels, ex.map(lambda m: m.build(), kernels.values())))
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, path in paths.items():
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}")
        for ln in open(path[:-3] + ".log"):
            if "registers" in ln or "smem" in ln:
                log(f"[build]   {ln.strip()}")


def _medians_ms(torch, fns, reps=50):
    """Median time per call of each function, CUDA events around the call
    (host included), the functions taken in turns so that they share the
    host's and the card's state (pair only calls of like cost: a heavy one
    leaves the host's caches cold for the next)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def _median_ms(torch, fn, reps=50):
    return _medians_ms(torch, [fn], reps)[0]


def _host_us(torch, fn, n=1000):
    """Host time per call of back-to-back calls (the enqueue rate; a kernel
    slower than its host path sets it instead)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _device_ms(fn):
    """Device time per call from the CUDA events of a torch.profiler trace
    of 20 calls (no host time in it): the sum of the call's kernels, the
    device kernels per call (checked rounded), and each kernel's mean time
    per call by name, in ms (``full_batch_trace.kernel_ms``)."""
    from ceres_slam_tpu_torch.ops.full_batch_trace import kernel_ms

    by_name, kernels = kernel_ms(fn)
    return sum(by_name.values()), kernels, by_name


def _trace(torch, fn):
    """One run of ``fn`` under torch.profiler (CPU and CUDA): device time
    (sum of the device events), device kernels, launches (runtime launch
    calls), host syncs (runtime synchronize calls) and copies, and the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session on the card now and then records no event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if dev:
            break
    host = [e.name for e in events if e.device_type != DeviceType.CUDA]
    return {"device_us": sum(e.device_time_total for e in dev), "kernels": len(dev),
            "launches": sum(n.startswith("cudaLaunchKernel") for n in host),
            "syncs": sum("Synchronize" in n for n in host),
            "copies": sum(n.startswith("cudaMemcpy") for n in host), "wall_us": wall * 1e6}


def _profile_full_batch(torch, data):
    """kitti1100's full problem (the dataset_vo --window 0 problem, float64,
    from the CLI's initial guess): one build_obs_blocks and one CG
    iteration (21 iterations less 1, block-Jacobi, tol 0) under the
    profiler, with the plan and the gather tables built beforehand, as
    solve_ba_pcg builds them once per problem."""
    from ceres_slam_tpu_torch.ops import full_batch_plan
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
    from ceres_slam_tpu_torch.solver import dense, pcg

    path = os.path.join(data, "kitti1100_vo.csv")
    if not os.path.exists(path):
        from ceres_slam_tpu_torch.apps import make_sim

        make_sim.main([data, "--kind", "kitti", "--num-states", "1100", "--sun-noise", "10"])
    ds = DatasetProblem.read_csv(path)
    ds.device = "cuda"
    ds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = ds._window_budget(ds.num_states)
    problem, state, _ = ds.build_window_problem(0, ds.num_states, n_obs_pad, n_pts_pad)
    problem = dense.to_device(problem, "cuda")
    st = problem.stereo
    K, J = state.poses.shape[0], state.points.shape[0]
    tables = pcg.build_obs_tables(st.pose_idx.cpu(), st.point_idx.cpu(), K, J, device="cuda")
    plan = full_batch_plan.plan_for_problem(problem)

    def blocks():
        return pcg.build_obs_blocks(problem, state, 1e-4, tables=tables, plan=plan)

    b = blocks()
    torch.cuda.synchronize()
    reps = 10
    t = _trace(torch, lambda: [blocks() for _ in range(reps)])
    log(f"[profile] full batch kitti1100 f64 (N {st.uvd.shape[0]}, J {J}, K {K}): build_obs_blocks "
        f"{t['device_us'] / reps:.2f} us of device time, {t['kernels'] / reps:g} device kernels, "
        f"{t['launches'] / reps:g} launches, {t['syncs'] / reps:g} syncs, "
        f"{t['copies'] / reps:g} copies, wall {t['wall_us'] / reps:.1f} us (profiled) per call")
    rhs = -b.gp
    precond = pcg._block_precond(pcg.schur_diag_blocks(b, tables))

    def cg(n):
        return lambda: pcg.pcg_solve(b, rhs, n, 0.0, tables=tables, precond=precond)

    cg(21)()
    one, many = _trace(torch, cg(1)), _trace(torch, cg(21))
    d = {k: (many[k] - one[k]) / 20 for k in one}
    log(f"[profile] full batch kitti1100 f64: one CG iteration {d['device_us']:.2f} us of device "
        f"time, {d['kernels']:g} device kernels, {d['launches']:g} launches, {d['syncs']:g} "
        f"syncs, {d['copies']:g} copies, wall {d['wall_us']:.1f} us (profiled)")


def _split(out):
    hll, u, gl, hppgp, cost = out
    return {"hll": hll, "u": u, "gl": gl, "hpp": hppgp[:, :36], "gp": hppgp[:, 36:42],
            "pcost": hppgp[:, 42], "cost": cost}


def _kernel_k1(torch, window_kernel, results, jobs):
    from ceres_slam_tpu_torch.solver import dense, window

    for shape, (K, J, O) in (("flagship", (2, 192, 2)), ("S", (64, 2048, 8))):
        for dtype in (torch.float64, torch.float32):
            plan, poses, points = args = window_kernel.random_inputs(K, J, O, dtype, "cuda", seed=7)
            out = window_kernel.window_factor_blocks(*args)
            again = window_kernel.window_factor_blocks(*args)
            kern = _split(out)
            plain = _split(window_kernel.window_factor_blocks_plain(*args))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                fail(f"K1 {shape} {dtype}: two calls on the same inputs differ")
            worst, errs = 0.0, {}
            for name, ref in plain.items():
                ref64, got64 = ref.double(), kern[name].double()
                if not torch.isfinite(got64).all():
                    fail(f"K1 {shape} {dtype}: non-finite {name}")
                err = (got64 - ref64).abs().max().item()
                scale = ref64.abs().max().item()
                errs[name] = err
                worst = max(worst, err)
                tol = TOL64 if dtype == torch.float64 else TOL32[name]
                if not err <= tol * scale:
                    fail(f"K1 {shape} {dtype}: {name} max|err| {err:.3e} vs max|ref| {scale:.3e}")
            layout = window.WindowLayout(problem=None, O=O, slot_pose=None, w_idx=None, plan=plan)
            state = dense.BAState(poses=poses, points=points)
            ms, blocks_ms = _medians_ms(torch, [lambda: window_kernel.window_factor_blocks(*args),
                                                lambda: window.factor_blocks(layout, state)])
            plain_ms = _median_ms(torch, lambda: window_kernel.window_factor_blocks_plain(*args))
            host_us = _host_us(torch, lambda: window_kernel.window_factor_blocks(*args))
            tag = "f64" if dtype == torch.float64 else "f32"
            # the function's own bytes: the 14 used values of each obs record,
            # the slot poses and pose order, the state and the outputs
            inputs = (poses, points, plan.pose_idx, plan.obs[:, :14], plan.pose_order,
                      plan.pose_start)
            results[("K1", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound(inputs, out, OPS_PER_ROW["K1"] * J * O, tag),
                                           "library_ms": None}
            jobs.append((f"K1 {shape} {tag}", lambda a=args: window_kernel.window_factor_blocks(*a),
                         results[("K1", shape, tag)]))
            log(f"[kernels] K1 {shape} K={K} J={J} O={O} M={J * O} {tag}: kernel {ms * 1e3:.1f} us "
                f"(host {host_us:.1f} us per call back to back; factor_blocks "
                f"{blocks_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
                f"{_bound_str(results[('K1', shape, tag)])}, two calls bit-equal, max|err| "
                f"{worst:.3e} " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


def _compare(tag, names, got, ref, tol):
    """Worst and per-output max |kernel - plain|; ``tol(name, ref)`` is the
    bound of one output."""
    worst, errs = 0.0, {}
    for name, g, r in zip(names, got, ref):
        g, r = g.double(), r.double()
        if not g.isfinite().all():
            fail(f"{tag}: non-finite {name}")
        errs[name] = (g - r).abs().max().item()
        worst = max(worst, errs[name])
        if errs[name] > tol(name, r):
            fail(f"{tag}: {name} max|err| {errs[name]:.3e} vs max|ref| {r.abs().max().item():.3e}")
    return worst, errs


def _kernel_full_batch(torch, kernels, results, jobs):
    """K2 (fused) and K3 (bound to the plan) on random full-batch problems:
    against their plain versions, bit-equal across two calls, wrapper and
    host times, and the bounds of the functions' own bytes."""
    k2, k3 = kernels["K2"], kernels["K3"]
    for shape, (N, J, K) in FULL_SHAPES.items():
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            f64 = dtype == torch.float64
            e = 8 if f64 else 4
            args = k2.random_inputs(N, J, K, dtype, "cuda", seed=7)
            names = ("U18", "Hpp", "gp", "Hll", "gl")
            out = k2.stereo_factor_sums(*args)
            again = k2.stereo_factor_sums(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                fail(f"K2 {shape} {tag}: two calls on the same inputs differ")
            worst, errs = _compare(
                f"K2 {shape} {tag}", names, out, k2.stereo_factor_sums_plain(*args),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K2_TOL32[n] * max(1.0, r.abs().max().item())))
            ms = _median_ms(torch, lambda: k2.stereo_factor_sums(*args))
            plain_ms = _median_ms(torch, lambda: k2.stereo_factor_sums_plain(*args))
            host_us = _host_us(torch, lambda: k2.stereo_factor_sums(*args))
            # the function's own bytes: uvd, stiffness, one pose and one landmark
            # index (int32) and a validity byte per observation, the state; U18
            # and the four sums
            nbytes = N * (12 * e + 8 + 1) + (12 * K + 3 * J) * e + (18 * N + 42 * K + 12 * J) * e
            results[("K2", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound_of(nbytes, OPS_PER_ROW["K2"] * N, tag),
                                           "library_ms": None}
            jobs.append((f"K2 {shape} {tag}", lambda a=args: k2.stereo_factor_sums(*a),
                         results[("K2", shape, tag)]))
            log(f"[kernels] K2 {shape} N={N} J={J} K={K} {tag}: kernel {ms * 1e3:.1f} us (host "
                f"{host_us:.1f} us per call back to back), plain {plain_ms * 1e3:.1f} us, "
                f"{_bound_str(results[('K2', shape, tag)])}, two calls bit-equal, max|err| "
                f"{worst:.3e} " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))

            bound, v = k3.random_inputs(N, J, K, dtype, "cuda", seed=7)
            out = k3.schur_uy(bound, v)
            again = k3.schur_uy(bound, v)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"K3 {shape} {tag}: two calls on the same inputs differ")
            worst, _ = _compare(
                f"K3 {shape} {tag}", ("uy",), (out,), (k3.schur_uy_plain(bound, v),),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K3_TOL32 * (r.abs().max().item() + 1.0)))
            ms = _median_ms(torch, lambda: k3.schur_uy(bound, v))
            plain_ms = _median_ms(torch, lambda: k3.schur_uy_plain(bound, v))
            host_us = _host_us(torch, lambda: k3.schur_uy(bound, v))
            # U18, Cinv, v and Uy, and one pose and one landmark index per observation
            nbytes = (18 * N + 9 * J + 12 * K) * e + 8 * N
            results[("K3", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound_of(nbytes, OPS_PER_ROW["K3"] * N, tag),
                                           "library_ms": None}
            jobs.append((f"K3 {shape} {tag}", lambda a=(bound, v): k3.schur_uy(*a),
                         results[("K3", shape, tag)]))
            log(f"[kernels] K3 {shape} N={N} J={J} K={K} {tag}: kernel {ms * 1e3:.1f} us (host "
                f"{host_us:.1f} us per call back to back), plain {plain_ms * 1e3:.1f} us, "
                f"{_bound_str(results[('K3', shape, tag)])}, two calls bit-equal, max|err| "
                f"{worst:.3e}")


def _nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (tensors, tuples, NamedTuples)."""
    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    return 0


def _bound(inputs, outputs, ops, tag):
    """The least time the card could take: bytes (each input read once,
    each output written once) over the HBM rate, or operations over the
    peak rate of their type, whichever is larger."""
    return _bound_of(_nbytes(inputs) + _nbytes(outputs), ops, tag)


def _bound_of(nbytes, ops, tag):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[tag] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _bound_str(r) -> str:
    return f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})"


def _kernel_k4(torch, k4, results, jobs):
    import torch.nn.functional as F

    for shape, (C, H, W, N) in K4_SHAPES.items():
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            imgs, u, v = k4.random_inputs(C, H, W, N, dtype, "cuda", seed=7)
            packed = k4.pack_imgs(imgs)
            got = k4.bilinear_sample_packed(packed, u, v)
            pairs = ((got, k4.bilinear_sample_packed_plain(packed, u, v)),
                     (k4.bilinear_sample_imgs(imgs, u, v), k4.bilinear_sample_imgs_plain(imgs, u, v)))
            torch.cuda.synchronize()
            fin = u.isfinite() & v.isfinite()
            if not got[:, fin].isfinite().all():
                fail(f"K4 {shape} {tag}: non-finite samples at finite coordinates")
            for g, r in pairs:
                same = (g == r) | (g.isnan() & r.isnan())
                if not same.all():
                    err = (g[:, fin].double() - r[:, fin].double()).abs().max().item()
                    fail(f"K4 {shape} {tag}: {int((~same).sum())} samples differ from the plain "
                         f"version, max|err| {err:.3e} at finite coordinates")
            # the library yardstick on the same inputs (grid prepared outside the timing)
            grid = torch.stack([2.0 * u / (W - 1) - 1.0, 2.0 * v / (H - 1) - 1.0], dim=-1)
            grid = grid.reshape(1, 1, N, 2).contiguous()

            def library(imgs=imgs, grid=grid):
                return F.grid_sample(imgs[None], grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

            err = (got[:, fin].double() - pairs[0][1][:, fin].double()).abs().max().item()
            ref = pairs[1][1]
            inb = fin & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
            lib_err = (library()[0, :, 0][:, inb].double() - ref[:, inb].double()).abs().max().item()
            if lib_err > K4_LIB_TOL[tag]:
                fail(f"K4 {shape} {tag}: grid_sample disagrees with the plain version by {lib_err:.3e}")
            ms, library_ms = _medians_ms(torch, [lambda: k4.bilinear_sample_packed(packed, u, v),
                                                 library])
            plain_ms = _median_ms(torch, lambda: k4.bilinear_sample_packed_plain(packed, u, v))
            pack_ms = _median_ms(torch, lambda: k4.pack_imgs(imgs))
            host_us = _host_us(torch, lambda: k4.bilinear_sample_packed(packed, u, v))
            library_host_us = _host_us(torch, library)
            ops = N * (K4_OPS[0] + K4_OPS[1] * C)
            # the bound counts the unpadded [C, H, W] stack: the function's own bytes
            results[("K4", shape, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           **_bound((imgs, u, v), got, ops, tag),
                                           "library_ms": library_ms}
            jobs.append((f"K4 {shape} {tag}",
                         lambda a=(packed, u, v): k4.bilinear_sample_packed(*a),
                         results[("K4", shape, tag)]))
            jobs.append((f"K4 {shape} {tag} grid_sample", library, results[("K4", shape, tag)]))
            jobs.append((f"K4 {shape} {tag} pack_imgs", lambda i=imgs: k4.pack_imgs(i), None))
            log(f"[kernels] K4 {shape} C={C} N={N} {tag}: kernel {ms * 1e3:.1f} us (host "
                f"{host_us:.1f} us per call back to back), plain {plain_ms * 1e3:.1f} us, grid_sample "
                f"{library_ms * 1e3:.1f} us (host {library_host_us:.1f} us), "
                f"{_bound_str(results[('K4', shape, tag)])}; pack_imgs (once per solve) "
                f"{pack_ms * 1e3:.1f} us; equal to both plain versions bit for bit "
                f"(grid_sample {lib_err:.1e} off on {int(inb.sum())} in-bounds points)")


def _stream_lookup(torch, cuda_build):
    """Host cost of reading PyTorch's current stream: the raw handle (what
    the thin launch path reads) against the public Stream object."""
    idx = torch.cuda.current_device()
    dev = torch.device("cuda", idx)
    n = 20000
    times = {}
    for name, fn in (("raw", lambda: cuda_build.current_stream(idx)),
                     ("public", lambda: torch.cuda.current_stream(dev).cuda_stream)):
        if fn() != torch.cuda.current_stream(dev).cuda_stream:
            fail(f"stream lookup {name} disagrees with torch.cuda.current_stream")
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times[name] = (time.perf_counter() - t0) / n * 1e6
    log(f"[kernels] current stream lookup, host us per call: "
        f"torch._C._cuda_getCurrentRawStream {times['raw']:.3f}, "
        f"torch.cuda.current_stream(device).cuda_stream {times['public']:.3f}")


def phase_kernels(torch, kernels):
    """Each kernel against its plain version; returns the results and the
    calls whose device time the profile phase measures."""
    from ceres_slam_tpu_torch.ops import cuda_build

    results, jobs = {}, []
    _stream_lookup(torch, cuda_build)
    _kernel_k1(torch, kernels["K1"], results, jobs)
    _kernel_full_batch(torch, kernels, results, jobs)
    _kernel_k4(torch, kernels["K4"], results, jobs)
    return results, jobs


def phase_profile(torch, jobs, dense: bool, data):
    """torch.profiler measurements, run last so that no profiler session
    precedes the timed main-path runs: each kernel call's device time and
    kernels per call (K1 must run one, K2 and K3 two), K4 on the path's own
    coordinates, kitti1100's build_obs_blocks and CG iteration, and a trace
    of one photometric solve."""
    from ceres_slam_tpu_torch.ops.full_batch_trace import device_span_ms

    for label, fn, row in jobs:
        ms, kernels, by_name = _device_ms(fn)
        share = f", {100 * row['bound_ms'] / ms:.1f}% of its bound" if row else ""
        more = ""
        if label.split()[0] in ("K2", "K3"):
            span = device_span_ms(fn)
            more = (" (" + ", ".join(f"{n} {t * 1e3:.2f} us" for n, t in by_name.items())
                    + f"); {span * 1e3:.2f} us per call back to back, gaps included")
        log(f"[profile] {label}: {ms * 1e3:.2f} us of device time per call, {kernels:g} device "
            f"kernels per call{more}{share}")
        want = {"K1": 1, "K2": 2, "K3": 2}.get(label.split()[0])
        if want and round(kernels) != want:
            fail(f"{label}: {kernels:g} device kernels per call, not {want}")
    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.ops import bilinear_kernel, lie
    from ceres_slam_tpu_torch.ops import photometric as ops_ph

    for dtype in (torch.float64, torch.float32):
        problem, state0, _ = dense_stereo.synthetic_problem(240, 320, dtype=dtype, device="cuda")
        packed = ops_ph.pack_track(problem.track_img, problem.grad_u, problem.grad_v)
        cam = problem.camera
        obs = torch.cat([problem.ref_uv, state0.disparities[:, None]], dim=-1)
        proj = cam.project(lie.se3_transform_point(state0.T, cam.triangulate(obs)))
        ms, _, _ = _device_ms(lambda: bilinear_kernel.bilinear_sample_packed(
            packed, proj[:, 0], proj[:, 1]))
        log(f"[profile] K4 on the path's coordinates (240x320 --gt-disparity start, N "
            f"{proj.shape[0]}, {dtype}): {ms * 1e3:.2f} us of device time per call")
    _profile_full_batch(torch, data)
    if dense:
        from ceres_slam_tpu_torch.solver import photometric
        from ceres_slam_tpu_torch.solver.lm import SolveConfig

        problem, state0, _ = dense_stereo.synthetic_problem(240, 320, dtype=torch.float32,
                                                            device="cuda")
        cfg = SolveConfig(max_iters=20, ftol=0.0, gtol=0.0, run_full_budget=True)
        _profile_solve(torch, lambda: photometric.solve_photometric(problem, state0, cfg))


def _make_sims(data):
    from ceres_slam_tpu_torch.apps import make_sim

    t0 = time.perf_counter()
    make_sim.main([data, "--kind", "triangle", "--num-states", "200", "--sun-noise", "10"])
    make_sim.main([data, "--kind", "kitti", "--num-states", "1100", "--sun-noise", "10"])
    log(f"[slice] sims (triangle200, kitti1100): {time.perf_counter() - t0:.2f} s")


def _run_cli(data, seq, dtype, device, window_kernel):
    import numpy as np

    from ceres_slam_tpu_torch.apps import dataset_vo_sun
    from ceres_slam_tpu_torch.utils import csvio, metrics

    base = os.path.join(data, seq)
    window_kernel.window_factor_blocks.launches = 0
    stats = dataset_vo_sun.main([base + ".csv", base + "_sun_ref.csv",
                                 base + "_sun_dir_gtsun10.csv", "--window", "2",
                                 "--dtype", dtype, "--device", device])
    launches = window_kernel.window_factor_blocks.launches
    gt = csvio.read_poses_csv(base + "_gt_poses.csv")
    poses, ate = {}, {}
    for name, p in stats["passes"].items():
        if not os.path.exists(p["output"]):
            fail(f"{seq} {dtype} {device}: {p['output']} was not written")
        poses[name] = csvio.read_poses_csv(p["output"])
        if poses[name].shape != gt.shape or not np.all(np.isfinite(poses[name])):
            fail(f"{seq} {dtype} {device}: {name} poses not finite or of shape {gt.shape}")
        ate[name] = metrics.ate_translation(poses[name], gt)
    return stats, launches, poses, ate


def _run_full(data, seq, dtype, device, kernels):
    """dataset_vo --window 0 (full-batch BA) on ``<seq>_vo.csv``."""
    import numpy as np

    from ceres_slam_tpu_torch.apps import dataset_vo
    from ceres_slam_tpu_torch.utils import csvio, metrics

    base = os.path.join(data, seq)
    k2, k3 = kernels["K2"].stereo_factor_sums, kernels["K3"].schur_uy
    k2.launches = k3.launches = 0
    stats = dataset_vo.main([base + "_vo.csv", "--window", "0", "--dtype", dtype,
                             "--device", device])
    launches = {"K2": k2.launches, "K3": k3.launches}
    gt = csvio.read_poses_csv(base + "_gt_poses.csv")
    for out in (stats["poses"], stats["map"]):
        if not os.path.exists(out):
            fail(f"{seq} full batch {dtype} {device}: {out} was not written")
    poses = csvio.read_poses_csv(stats["poses"])
    if poses.shape != gt.shape or not np.all(np.isfinite(poses)):
        fail(f"{seq} full batch {dtype} {device}: poses not finite or of shape {gt.shape}")
    with open(stats["map"]) as f:
        rows = [[float(x) for x in ln.split(",")] for ln in f.readlines()[1:] if ln.strip()]
    if not np.all(np.isfinite(np.asarray(rows, dtype=float))):
        fail(f"{seq} full batch {dtype} {device}: non-finite map")
    return stats, launches, poses, metrics.ate_translation(poses, gt)


def _slice_window(data, kernels):
    """The flagship sliding-window CLI; returns K1's launches and the
    triangle200 float64 poses."""
    total_launches, keep = 0, None
    for seq, dtype in (("triangle200", "float64"), ("triangle200", "float32"),
                       ("kitti1100", "float64")):
        stats, launches, poses, ate = _run_cli(data, seq, dtype, "cuda", kernels["K1"])
        windows = sum(p["windows"] for p in stats["passes"].values())
        if launches < windows:
            fail(f"{seq} {dtype}: {launches} K1 launches for {windows} solved windows")
        total_launches += launches
        for name, ref in JAX_ATE[seq].items():
            dev = abs(ate[name] - ref) / ref
            log(f"[slice] {seq} {dtype} {name}: ATE {ate[name]:.4f} m (JAX {ref:.4f}, "
                f"{100 * dev:.2f}% off, bound {100 * ATE_BOUND[seq]:.0f}%)")
            if dev > ATE_BOUND[seq]:
                fail(f"{seq} {dtype} {name}: ATE {ate[name]:.4f} vs JAX {ref:.4f}")
        log(f"[slice] {seq} {dtype} cuda: load {stats['load_s']:.2f} s, RANSAC "
            f"{stats['ransac_s']:.2f} s, total {stats['total_s']:.2f} s, K1 launches {launches}")
        for name, p in stats["passes"].items():
            log(f"[slice]   pass {name}: {p['windows']} windows in {p['wall_s']:.2f} s "
                f"({p['windows_per_s']:.1f} windows/s), {p['mean_iters']:.2f} iterations/window")
        if (seq, dtype) == ("triangle200", "float64"):
            keep = poses
    return total_launches, keep


def _slice_full(data, kernels):
    """Full-batch BA through dataset_vo; returns K2's and K3's launches, the
    triangle200 float64 poses and that run's final cost."""
    total = {"K2": 0, "K3": 0}
    keep = None
    for seq, dtype in (("triangle200", "float64"), ("triangle200", "float32"),
                       ("kitti1100", "float64")):
        stats, launches, poses, ate = _run_full(data, seq, dtype, "cuda", kernels)
        lm_it, cg_it = stats["lm_iterations"], stats["cg_iterations"]
        if launches["K2"] < lm_it or launches["K3"] < cg_it or not cg_it:
            fail(f"{seq} full batch {dtype}: {launches} launches for {lm_it} LM and {cg_it} "
                 "CG iterations")
        for name in total:
            total[name] += launches[name]
        cost_ref, ate_ref = JAX_FULL[seq]
        rtol = FULL_COST_RTOL[seq] if dtype == "float64" else max(FULL_COST_RTOL[seq], COST_RTOL32)
        ate_atol = FULL_ATE_ATOL[seq] if dtype == "float64" else max(FULL_ATE_ATOL[seq], 0.0005)
        cost_dev = abs(stats["final_cost"] - cost_ref) / cost_ref
        log(f"[slice] {seq} full batch {dtype}: cost {stats['initial_cost']:.6e} -> "
            f"{stats['final_cost']:.6e} (JAX {cost_ref:.6e}, {100 * cost_dev:.4f}% off, bound "
            f"{100 * rtol:.4g}%), ATE {ate:.6f} m (JAX {ate_ref:.4f}, bound +-{ate_atol:.4g} m)")
        log(f"[slice] {seq} full batch {dtype} cuda: load {stats['load_s']:.2f} s, RANSAC "
            f"{stats['ransac_s']:.2f} s, solve {stats['solve_s']:.2f} s, total "
            f"{stats['total_s']:.2f} s; {lm_it} LM iterations, {cg_it} CG iterations "
            f"({cg_it / max(lm_it, 1):.1f} per LM iteration); launches K2 {launches['K2']}, "
            f"K3 {launches['K3']}")
        if not (cost_dev <= rtol and abs(ate - ate_ref) <= ate_atol):
            fail(f"{seq} full batch {dtype}: cost {stats['final_cost']:.6e} / ATE {ate:.6f} "
                 f"vs JAX {cost_ref:.6e} / {ate_ref:.4f}")
        if (seq, dtype) == ("triangle200", "float64"):
            keep = (poses, stats["final_cost"])
    return total, keep


def _banded_full(data, kernels, jacobi_cost):
    """solve_ba_pcg with the banded preconditioner on the triangle200 full
    problem, from the CLI's initial guess and with its float64 settings:
    the same minimum as the block-Jacobi run (rtol 1e-6)."""
    import torch

    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
    from ceres_slam_tpu_torch.solver import dense, pcg
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    t0 = time.perf_counter()
    ds = DatasetProblem.read_csv(os.path.join(data, "triangle200_vo.csv"))
    ds.device = "cuda"
    ds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = ds._window_budget(ds.num_states)
    problem, state, _ = ds.build_window_problem(0, ds.num_states, n_obs_pad, n_pts_pad)
    config = SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    k2, k3 = kernels["K2"].stereo_factor_sums, kernels["K3"].schur_uy
    k2.launches = k3.launches = 0
    _, summary = pcg.solve_ba_pcg(dense.to_device(problem, "cuda"), state, config,
                                  precond="banded")
    torch.cuda.synchronize()
    dev = abs(summary.final_cost - jacobi_cost) / jacobi_cost
    log(f"[slice] triangle200 full batch float64 banded: cost {summary.final_cost:.6e} (Jacobi "
        f"{jacobi_cost:.6e}, {dev:.2e} relative), {summary.iterations} LM iterations, "
        f"{summary.linear_iterations} CG iterations, launches K2 {k2.launches}, K3 "
        f"{k3.launches}, {time.perf_counter() - t0:.2f} s")
    if not (dev <= 1e-6 and k2.launches >= summary.iterations
            and k3.launches >= summary.linear_iterations):
        fail("the banded-preconditioner solve disagrees with the block-Jacobi one")


def phase_slice(kernels, data):
    _make_sims(data)
    k1_launches, window_poses = _slice_window(data, kernels)
    full_launches, (full_poses, jacobi_cost) = _slice_full(data, kernels)
    _banded_full(data, kernels, jacobi_cost)
    return {"K1": k1_launches, **full_launches}, window_poses, full_poses


def _run_dense(label, argv, device, k4):
    """One dense_stereo CLI run with K4's launches counted from 0."""
    from ceres_slam_tpu_torch.apps import dense_stereo

    k4.launches = 0
    stats = dense_stereo.main([*argv, "--device", device])
    stats["launches"] = k4.launches
    if not all(math.isfinite(x) for x in stats["T"]) or not stats["final_cost"] < stats["initial_cost"]:
        fail(f"dense_stereo {argv} on {device}: pose not finite or cost not decreased")
    if device == "cuda" and stats["launches"] < 2 * stats["iterations"]:
        fail(f"dense_stereo {argv}: {stats['launches']} K4 launches for {stats['iterations']} "
             "LM iterations")
    log(f"[dense] {label} {device}: "
        f"{stats['size'][0]}x{stats['size'][1]}, {stats['pixels_valid']} / {stats['pixels_total']} "
        f"pixels, cost {stats['initial_cost']:.6e} -> {stats['final_cost']:.6e} in "
        f"{stats['iterations']} LM iterations, K4 launches {stats['launches']}; matcher "
        f"{stats['matcher_s']:.3f} s, alignment {stats['align_s']:.3f} s, total {stats['total_s']:.3f} s")
    return stats


def _photometric_rate(k4):
    """scripts/bench_xl.py's photometric rate on the port: the 240x320
    --gt-disparity problem in float32, 20 LM iterations under
    run_full_budget (every iteration a full step and candidate cost), 3
    timed repetitions after a warm-up."""
    import torch

    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.solver import photometric
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    problem, state0, _ = dense_stereo.synthetic_problem(240, 320, dtype=torch.float32,
                                                        device="cuda")
    cfg = SolveConfig(max_iters=20, ftol=0.0, gtol=0.0, run_full_budget=True)
    k4.launches = 0
    t0 = time.perf_counter()
    _, summary = photometric.solve_photometric(problem, state0, cfg)
    warm_s = time.perf_counter() - t0
    launches = k4.launches
    if summary.iterations != 20 or launches < 40:
        fail(f"photometric rate: {summary.iterations} iterations, {launches} K4 launches")
    t0 = time.perf_counter()
    for _ in range(3):
        _, summary = photometric.solve_photometric(problem, state0, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = {"metric": "photometric_it_s", "pixels": problem.ref_uv.shape[0], "H": 240, "W": 320,
            "dtype": "float32", "it_s": 3 * 20 / dt, "warmup_s": warm_s,
            "final_cost": summary.final_cost}
    log(f"[dense] {json.dumps(rate)}; K4 launches per solve {launches}")
    return k4.launches


def _profile_solve(torch, solve):
    """One solve under torch.profiler: the device's busy share of the wall,
    launches per LM iteration, K4's device time per call on the path's own
    coordinates, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    k4 = [e.device_time_total for e in events if "bilinear_packed_kernel" in e.name]
    log(f"[profile] one 20-iteration photometric solve (float32, 240x320): wall {wall_us / 1e3:.2f} ms (profiled), "
        f"device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.2f}%), {len(events)} "
        f"device events ({len(events) / 20:.1f} per LM iteration); K4 {len(k4)} calls, "
        f"{sum(k4) / max(len(k4), 1):.2f} us of device time each")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {name[:100]}")


def phase_dense(kernels, data):
    """The dense photometric slice on CUDA; returns K4's launches and the
    --gt-disparity run's pose."""
    import numpy as np

    from ceres_slam_tpu_torch.apps import dense_stereo

    k4 = kernels["K4"].bilinear_sample_packed
    total = 0
    gt = _run_dense("--gt-disparity", DENSE_ARGS + ["--gt-disparity"], "cuda", k4)
    total += gt["launches"]
    ref = JAX_DENSE_GT
    cost_dev = abs(gt["final_cost"] - ref["final_cost"]) / ref["final_cost"]
    log(f"[dense] --gt-disparity: final cost {gt['final_cost']:.9e} (JAX {ref['final_cost']:.9e}, "
        f"{cost_dev:.2e} relative, bound {DENSE_GT_COST_RTOL:.0e}), pose error "
        f"{gt['pose_err0']:.9f} -> {gt['pose_err1']:.9f} (JAX {ref['err0']:.9f} -> "
        f"{ref['err1']:.9f}, bound {DENSE_GT_ERR_ATOL:.0e})")
    if not (gt["iterations"] == ref["iterations"] and cost_dev <= DENSE_GT_COST_RTOL
            and abs(gt["pose_err0"] - ref["err0"]) <= DENSE_GT_ERR_ATOL
            and abs(gt["pose_err1"] - ref["err1"]) <= DENSE_GT_ERR_ATOL):
        fail("the --gt-disparity run disagrees with the JAX figures")

    chain = _run_dense("full chain", DENSE_ARGS, "cuda", k4)
    total += chain["launches"]
    ref = JAX_DENSE_CHAIN
    log(f"[dense] full chain: {chain['pixels_valid']} valid pixels (JAX {ref['pixels_valid']}), "
        f"matcher {100 * chain['matcher_valid_share']:.1f}% valid, median |d_err| "
        f"{chain['matcher_median_derr']:.4f} px (JAX {ref['matcher_median_derr']}), pose error "
        f"{chain['pose_err0']:.6f} -> {chain['pose_err1']:.6f} (JAX -> {ref['err1']:.6f})")
    if not (abs(chain["pixels_valid"] - ref["pixels_valid"]) <= 0.005 * ref["pixels_valid"]
            and abs(chain["matcher_median_derr"] - ref["matcher_median_derr"]) <= 0.01
            and chain["pose_err1"] <= 0.75 * chain["pose_err0"]
            and abs(chain["pose_err1"] - ref["err1"]) <= 0.25 * ref["err1"]):
        fail("the full-chain run is outside the JAX figures' bounds")

    _, img_ref, img_trk, _, _, _, _, img_right = dense_stereo.make_scene(240, 320, stereo=True,
                                                                         device="cuda")
    paths = [os.path.join(data, f"{name}.npy") for name in ("left0", "right0", "left1")]
    for path, img in zip(paths, (img_ref, img_right, img_trk)):
        np.save(path, img.cpu().numpy())
    images = _run_dense("--images", ["--images", *paths, "--pyrdown", "1", "--max-disp", "32", "--camera",
                         "150", "150", "160", "120", "0.5"], "cuda", k4)
    total += images["launches"]
    total += _photometric_rate(kernels["K4"].bilinear_sample_packed)
    return total, gt["T"]


def phase_cpu(kernels, data, window_poses, full_poses, dense_pose):
    import numpy as np

    if dense_pose is not None:
        stats = _run_dense("--gt-disparity", DENSE_ARGS + ["--gt-disparity"], "cpu",
                           kernels["K4"].bilinear_sample_packed)
        d = float(np.max(np.abs(np.asarray(stats["T"]) - np.asarray(dense_pose))))
        log(f"[cpu] dense --gt-disparity: max |pose(cpu) - pose(cuda)| = {d:.3e}")
        if stats["launches"] or not d <= 1e-8:
            fail(f"CPU dense run: {stats['launches']} K4 launches, poses differ by {d:.3e}")
    if window_poses is None:
        return
    stats, launches, poses, _ = _run_cli(data, "triangle200", "float64", "cpu", kernels["K1"])
    if launches:
        fail(f"the CPU run launched K1 {launches} times")
    for name in poses:
        d = float(np.max(np.abs(poses[name] - window_poses[name])))
        log(f"[cpu] triangle200 float64 {name}: max |pose(cpu) - pose(cuda)| = {d:.3e} "
            f"(total {stats['total_s']:.2f} s on the CPU)")
        if not d <= 1e-6:
            fail(f"CPU and CUDA poses differ by {d:.3e} in pass {name}")
    stats, launches, poses, _ = _run_full(data, "triangle200", "float64", "cpu", kernels)
    if any(launches.values()):
        fail(f"the CPU full-batch run launched kernels: {launches}")
    d = float(np.max(np.abs(poses - full_poses)))
    log(f"[cpu] triangle200 full batch float64: max |pose(cpu) - pose(cuda)| = {d:.3e} "
        f"(total {stats['total_s']:.2f} s on the CPU, {stats['lm_iterations']} LM iterations)")
    if not d <= 1e-6:
        fail(f"CPU and CUDA full-batch poses differ by {d:.3e}")


# name, function, CUDA source, line of the TPU kernel in pallas_kernels.py,
# the shape whose float64 numbers the JSON line reports, and the design
KERNELS = (
    ("K1", "window_factor_blocks", "window_factor_blocks.cu", ":299", "flagship",
     "redesigned: one launch (pose blocks, landmark blocks), per-window plan, thin launch path"),
    ("K2", "stereo_factor_sums", "stereo_factor_blocks.cu", ":124", "kitti1100",
     "redesigned: fused with its pose and landmark sums (a block per pose, then a landmark "
     "pass in slot order), staged 16-byte stores, full-batch plan, thin launch path"),
    ("K3", "schur_uy", "schur_uy.cu", ":591", "kitti1100",
     "redesigned: rows staged through shared memory, a block per landmark group then per "
     "pose, full-batch plan bound once per LM iteration, thin launch path"),
    ("K4", "bilinear_sample_packed", "bilinear_sample_imgs.cu", ":427", "240x320",
     "redesigned: packed [H, W, 4] texels, strided coordinates, per-solve plan, "
     "thin launch path"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    cli = ap.parse_args()
    phases = cli.phases.split(",")
    if not set(phases) <= set(PHASES) or ("cpu" in phases and not {"slice", "dense"} & set(phases)):
        fail(f"bad --phases {phases}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from ceres_slam_tpu_torch.ops import (bilinear_kernel, schur_kernel, stereo_factor_kernel,
                                              window_kernel)
    except ImportError as e:
        fail(f"cannot import the port: {e}")
    kernels = {"K1": window_kernel, "K2": stereo_factor_kernel, "K3": schur_kernel,
               "K4": bilinear_kernel}

    smi = phase_device(torch)
    if "build" in phases or "kernels" in phases:
        phase_build(kernels)
    k, jobs = phase_kernels(torch, kernels) if "kernels" in phases else ({}, [])
    launches = {name: 0 for name in kernels}
    window_poses = full_poses = dense_pose = None
    data = os.path.join(ROOT, "build", "chip_smoke_data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    if "slice" in phases:
        slice_launches, window_poses, full_poses = phase_slice(kernels, data)
        launches.update(slice_launches)
    if "dense" in phases:
        launches["K4"], dense_pose = phase_dense(kernels, data)
    if "cpu" in phases:
        phase_cpu(kernels, data, window_poses, full_poses, dense_pose)
    if "profile" in phases or ("kernels" in phases and not {"slice", "dense"} & set(phases)):
        phase_profile(torch, jobs, "dense" in phases, data)
    nan = {"max_abs_err": math.nan, "ms": math.nan, "plain_ms": math.nan, "bound_ms": math.nan,
           "bound_by": None, "library_ms": None}
    log(json.dumps({"kernels": [{
        "name": fn, "route": "cuda", "source": f"ceres_slam_tpu_torch/csrc/{src}",
        "replaces": f"ceres_slam_tpu/ops/pallas_kernels.py{line}", "launches": launches[name],
        **k.get((name, shape, "f64"), nan), "design": design}
        for name, fn, src, line, shape, design in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
