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
           slots); K2 and K3 at the full-batch shapes of triangle200 (N
           12,992, J 448, K 200) and kitti1100 (N 124,480, J 16,640, K
           1,100); K4 at the photometric shape (3x240x320, N 68,096) and at
           KITTI's full resolution (3x375x1242, N 440,134), beside one
           torch.nn.functional.grid_sample call (its yardstick, which the
           port never calls)
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
           timed run: the device time per call of every kernel checked in
           the kernels phase (and of grid_sample), and a trace of one
           photometric rate solve (device busy share, launches per LM
           iteration, K4's device time on the path's own coordinates)

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
TOL32 = {"hll": 1e-5, "u": 1e-5, "gl": 5e-3, "hpp": 1e-5, "gp": 5e-3}
COST_RTOL32 = 1e-4
K2_TOL32 = {"r": 1e-4, "hpp": 1e-4, "hll": 1e-4, "u": 1e-4, "gp": 5e-3, "gl": 5e-3}
K3_TOL32 = 2e-5
FULL_SHAPES = {"triangle200": (12992, 448, 200), "kitti1100": (124480, 16640, 1100)}

# K4 shapes (C, H, W, N): the photometric path's 240x320 with its 68,096
# aligned pixels, and KITTI's full resolution with 440,134 points. The
# kernel rounds as its plain version does (no FMA contraction), so float64
# is held to 1e-12 and float32 to 2e-6 absolute on O(1) images, at every
# point with finite coordinates. grid_sample (border padding, corners
# aligned) computes the same function on the in-bounds points, through a
# coordinate normalization that rounds at ~W x eps: 1e-9 (f64) and 1e-4
# (f32) absolute.
K4_SHAPES = {"240x320": (3, 240, 320, 68096), "375x1242": (3, 375, 1242, 440134)}
K4_TOL = {"f64": 1e-12, "f32": 2e-6}
K4_LIB_TOL = {"f64": 1e-9, "f32": 1e-4}

# bounds: HBM bytes/s and peak operations/s outside the tensor cores (H100
# SXM data sheet), and the operations per row each kernel does, counted
# from its source (K1 per slot, K2 per observation, K3 per observation,
# K4 per point and channel plus the index arithmetic)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12}
OPS_PER_ROW = {"K1": 750, "K2": 710, "K3": 90}
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


def _median_ms(torch, fn, reps=50):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, reps=20):
    """Mean device time per call: the CUDA kernels' durations in a
    torch.profiler trace of ``reps`` calls (no host time in it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def _split(out):
    hll, u, gl, hppgp = out
    return {"hll": hll, "u": u, "gl": gl, "hpp": hppgp[:36], "gp": hppgp[36:42],
            "cost": hppgp[42]}


def _kernel_k1(torch, window_kernel, results, jobs):
    for shape, (K, J, O) in (("flagship", (2, 192, 2)), ("S", (64, 2048, 8))):
        for dtype in (torch.float64, torch.float32):
            args = window_kernel.random_inputs(K, J, O, dtype, "cuda", seed=7)
            out = window_kernel.window_factor_blocks(*args)
            kern = _split(out)
            plain = _split(window_kernel.window_factor_blocks_plain(*args))
            torch.cuda.synchronize()
            worst, errs = 0.0, {}
            for name, ref in plain.items():
                ref64, got64 = ref.double(), kern[name].double()
                if not torch.isfinite(got64).all():
                    fail(f"K1 {shape} {dtype}: non-finite {name}")
                err = (got64 - ref64).abs().max().item()
                scale = ref64.abs().max().item()
                errs[name] = err
                worst = max(worst, err)
                if name == "cost" and dtype == torch.float32:
                    ok = abs(got64.sum().item() - ref64.sum().item()) <= COST_RTOL32 * abs(ref64.sum().item())
                else:
                    tol = TOL64 if dtype == torch.float64 else TOL32[name]
                    ok = err <= tol * scale
                if not ok:
                    fail(f"K1 {shape} {dtype}: {name} max|err| {err:.3e} vs max|ref| {scale:.3e}")
            ms = _median_ms(torch, lambda: window_kernel.window_factor_blocks(*args))
            plain_ms = _median_ms(torch, lambda: window_kernel.window_factor_blocks_plain(*args))
            tag = "f64" if dtype == torch.float64 else "f32"
            results[("K1", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound(args, out, OPS_PER_ROW["K1"] * J * O, tag),
                                           "library_ms": None}
            jobs.append((f"K1 {shape} {tag}", lambda a=args: window_kernel.window_factor_blocks(*a)))
            log(f"[kernels] K1 {shape} K={K} J={J} O={O} M={J * O} {tag}: kernel {ms * 1e3:.1f} us, "
                f"plain {plain_ms * 1e3:.1f} us, {_bound_str(results[('K1', shape, tag)])}, "
                f"max|err| {worst:.3e} "
                + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


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
    k2, k3 = kernels["K2"], kernels["K3"]
    for shape, (N, J, K) in FULL_SHAPES.items():
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            f64 = dtype == torch.float64
            args = k2.random_inputs(N, dtype, "cuda", seed=7)
            names = ("r", "hpp", "hll", "u", "gp", "gl")
            out = k2.stereo_factor_blocks(*args)
            worst, errs = _compare(
                f"K2 {shape} {tag}", names, out,
                k2.stereo_factor_blocks_plain(*args),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K2_TOL32[n] * max(1.0, r.abs().max().item())))
            ms = _median_ms(torch, lambda: k2.stereo_factor_blocks(*args))
            plain_ms = _median_ms(torch, lambda: k2.stereo_factor_blocks_plain(*args))
            results[("K2", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound(args, out, OPS_PER_ROW["K2"] * N, tag),
                                           "library_ms": None}
            jobs.append((f"K2 {shape} {tag}", lambda a=args: k2.stereo_factor_blocks(*a)))
            log(f"[kernels] K2 {shape} N={N} {tag}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, {_bound_str(results[('K2', shape, tag)])}, "
                f"max|err| {worst:.3e} "
                + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))

            args = k3.random_inputs(N, J, K, dtype, "cuda", seed=7)
            out = k3.schur_uy(*args)
            worst, _ = _compare(
                f"K3 {shape} {tag}", ("uy",), (out,), (k3.schur_uy_plain(*args),),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K3_TOL32 * (r.abs().max().item() + 1.0)))
            ms = _median_ms(torch, lambda: k3.schur_uy(*args))
            plain_ms = _median_ms(torch, lambda: k3.schur_uy_plain(*args))
            results[("K3", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                           **_bound(args, out, OPS_PER_ROW["K3"] * N, tag),
                                           "library_ms": None}
            t = args[3]
            jobs.append((f"K3 {shape} {tag}", lambda a=args: k3.schur_uy(*a)))
            log(f"[kernels] K3 {shape} N={N} J={J} K={K} O_l={t.by_point.shape[1]} "
                f"O_p={t.by_pose.shape[1]} {tag}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, {_bound_str(results[('K3', shape, tag)])}, "
                f"max|err| {worst:.3e}")


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
    t_bytes = (_nbytes(inputs) + _nbytes(outputs)) / HBM_BYTES_PER_S * 1e3
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
            got = k4.bilinear_sample_imgs(imgs, u, v)
            ref = k4.bilinear_sample_imgs_plain(imgs, u, v)
            torch.cuda.synchronize()
            fin = u.isfinite() & v.isfinite()
            if not got[:, fin].isfinite().all():
                fail(f"K4 {shape} {tag}: non-finite samples at finite coordinates")
            err = (got[:, fin].double() - ref[:, fin].double()).abs().max().item()
            if err > K4_TOL[tag]:
                fail(f"K4 {shape} {tag}: max|kernel - plain| {err:.3e}")
            # the library yardstick on the same inputs (grid prepared outside the timing)
            grid = torch.stack([2.0 * u / (W - 1) - 1.0, 2.0 * v / (H - 1) - 1.0], dim=-1)
            grid = grid.reshape(1, 1, N, 2).contiguous()

            def library(imgs=imgs, grid=grid):
                return F.grid_sample(imgs[None], grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

            inb = fin & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
            lib_err = (library()[0, :, 0][:, inb].double() - ref[:, inb].double()).abs().max().item()
            if lib_err > K4_LIB_TOL[tag]:
                fail(f"K4 {shape} {tag}: grid_sample disagrees with the plain version by {lib_err:.3e}")
            ms = _median_ms(torch, lambda: k4.bilinear_sample_imgs(imgs, u, v))
            plain_ms = _median_ms(torch, lambda: k4.bilinear_sample_imgs_plain(imgs, u, v))
            library_ms = _median_ms(torch, library)
            ops = N * (K4_OPS[0] + K4_OPS[1] * C)
            results[("K4", shape, tag)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           **_bound((imgs, u, v), got, ops, tag),
                                           "library_ms": library_ms}
            jobs.append((f"K4 {shape} {tag}", lambda a=(imgs, u, v): k4.bilinear_sample_imgs(*a)))
            jobs.append((f"K4 {shape} {tag} grid_sample", library))
            log(f"[kernels] K4 {shape} C={C} N={N} {tag}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, grid_sample {library_ms * 1e3:.1f} us, "
                f"{_bound_str(results[('K4', shape, tag)])}, max|err| {err:.3e} "
                f"(grid_sample {lib_err:.1e}, {int(inb.sum())} in-bounds points)")


def phase_kernels(torch, kernels):
    """Each kernel against its plain version; returns the results and the
    calls whose device time the profile phase measures."""
    results, jobs = {}, []
    _kernel_k1(torch, kernels["K1"], results, jobs)
    _kernel_full_batch(torch, kernels, results, jobs)
    _kernel_k4(torch, kernels["K4"], results, jobs)
    return results, jobs


def phase_profile(torch, jobs, dense: bool):
    """torch.profiler measurements, run last so that no profiler session
    precedes the timed main-path runs: each kernel call's device time, and
    a trace of one photometric solve."""
    for label, fn in jobs:
        log(f"[profile] {label}: {_device_ms(torch, fn) * 1e3:.2f} us of device time per call")
    if dense:
        from ceres_slam_tpu_torch.apps import dense_stereo
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
    k2, k3 = kernels["K2"].stereo_factor_blocks, kernels["K3"].schur_uy
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
    k2, k3 = kernels["K2"].stereo_factor_blocks, kernels["K3"].schur_uy
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
    k4 = [e.device_time_total for e in events if "bilinear_kernel" in e.name]
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

    k4 = kernels["K4"].bilinear_sample_imgs
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

    _, img_ref, img_trk, _, _, _, _, img_right = dense_stereo.make_scene(240, 320, stereo=True)
    paths = [os.path.join(data, f"{name}.npy") for name in ("left0", "right0", "left1")]
    for path, img in zip(paths, (img_ref, img_right, img_trk)):
        np.save(path, img.numpy())
    images = _run_dense("--images", ["--images", *paths, "--pyrdown", "1", "--max-disp", "32", "--camera",
                         "150", "150", "160", "120", "0.5"], "cuda", k4)
    total += images["launches"]
    total += _photometric_rate(kernels["K4"].bilinear_sample_imgs)
    return total, gt["T"]


def phase_cpu(kernels, data, window_poses, full_poses, dense_pose):
    import numpy as np

    if dense_pose is not None:
        stats = _run_dense("--gt-disparity", DENSE_ARGS + ["--gt-disparity"], "cpu",
                           kernels["K4"].bilinear_sample_imgs)
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
# and the shape whose float64 numbers the JSON line reports
KERNELS = (
    ("K1", "window_factor_blocks", "window_factor_blocks.cu", ":299", "flagship"),
    ("K2", "stereo_factor_blocks", "stereo_factor_blocks.cu", ":124", "kitti1100"),
    ("K3", "schur_uy", "schur_uy.cu", ":591", "kitti1100"),
    ("K4", "bilinear_sample_imgs", "bilinear_sample_imgs.cu", ":427", "240x320"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
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
    if "profile" in phases:
        phase_profile(torch, jobs, "dense" in phases)
    nan = {"max_abs_err": math.nan, "ms": math.nan, "plain_ms": math.nan, "bound_ms": math.nan,
           "bound_by": None, "library_ms": None}
    log(json.dumps({"kernels": [{
        "name": fn, "route": "cuda", "source": f"ceres_slam_tpu_torch/csrc/{src}",
        "replaces": f"ceres_slam_tpu/ops/pallas_kernels.py{line}", "launches": launches[name],
        **k.get((name, shape, "f64"), nan)} for name, fn, src, line, shape in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
