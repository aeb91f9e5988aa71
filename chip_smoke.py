#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (``--phases`` selects a subset, for bring-up; the default runs all):

  device   the card's name and power limit (nvidia-smi), torch and CUDA versions
  build    compiles the kernels K1 (csrc/window_factor_blocks.cu), K2
           (csrc/stereo_factor_blocks.cu) and K3 (csrc/schur_uy.cu) with nvcc,
           one process each, all started together
  kernels  each kernel against its plain PyTorch version on the card, in
           float64 and float32, with median times: K1 at the flagship window
           shape (K=2, J=192, O=2) and the S scale (K=64, J=2048, 16,384
           slots); K2 and K3 at the full-batch shapes of triangle200 (N
           12,992, J 448, K 200) and kitti1100 (N 124,480, J 16,640, K 1,100)
  slice    generates triangle200 and kitti1100 with the port's make_sim and
           runs both CLIs on CUDA: the flagship sliding window (dataset_vo_sun,
           triangle200 float64 and float32, kitti1100 float64; K1 launch
           counts and ATE against the JAX figures) and full-batch BA
           (dataset_vo --window 0, the same three runs; K2 and K3 launch
           counts, final cost and ATE against the JAX figures), plus one
           banded-preconditioner solve of the triangle200 full problem
  cpu      triangle200 float64 once more on the CPU, through both CLIs; poses
           must equal the CUDA runs' to 1e-6. All runs draw the same RANSAC
           hypotheses (seed 42 + pair; the threefry draw is integer
           arithmetic, the same bits on either device)

Any failure exits non-zero before the result line. The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
is the kernel table as JSON. Imports nothing of JAX or ``ceres_slam_tpu``.
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
PHASES = ("device", "build", "kernels", "slice", "cpu")

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


def _split(out):
    hll, u, gl, hppgp = out
    return {"hll": hll, "u": u, "gl": gl, "hpp": hppgp[:36], "gp": hppgp[36:42],
            "cost": hppgp[42]}


def _kernel_k1(torch, window_kernel, results):
    for shape, (K, J, O) in (("flagship", (2, 192, 2)), ("S", (64, 2048, 8))):
        for dtype in (torch.float64, torch.float32):
            args = window_kernel.random_inputs(K, J, O, dtype, "cuda", seed=7)
            kern = _split(window_kernel.window_factor_blocks(*args))
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
            results[("K1", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
            log(f"[kernels] K1 {shape} K={K} J={J} O={O} M={J * O} {tag}: kernel {ms * 1e3:.1f} us, "
                f"plain {plain_ms * 1e3:.1f} us, max|err| {worst:.3e} "
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


def _kernel_full_batch(torch, kernels, results):
    k2, k3 = kernels["K2"], kernels["K3"]
    for shape, (N, J, K) in FULL_SHAPES.items():
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            f64 = dtype == torch.float64
            args = k2.random_inputs(N, dtype, "cuda", seed=7)
            names = ("r", "hpp", "hll", "u", "gp", "gl")
            worst, errs = _compare(
                f"K2 {shape} {tag}", names, k2.stereo_factor_blocks(*args),
                k2.stereo_factor_blocks_plain(*args),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K2_TOL32[n] * max(1.0, r.abs().max().item())))
            ms = _median_ms(torch, lambda: k2.stereo_factor_blocks(*args))
            plain_ms = _median_ms(torch, lambda: k2.stereo_factor_blocks_plain(*args))
            results[("K2", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
            log(f"[kernels] K2 {shape} N={N} {tag}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, max|err| {worst:.3e} "
                + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))

            args = k3.random_inputs(N, J, K, dtype, "cuda", seed=7)
            worst, _ = _compare(
                f"K3 {shape} {tag}", ("uy",), (k3.schur_uy(*args),), (k3.schur_uy_plain(*args),),
                lambda n, r: (TOL64 * r.abs().max() if f64
                              else K3_TOL32 * (r.abs().max().item() + 1.0)))
            ms = _median_ms(torch, lambda: k3.schur_uy(*args))
            plain_ms = _median_ms(torch, lambda: k3.schur_uy_plain(*args))
            results[("K3", shape, tag)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
            t = args[3]
            log(f"[kernels] K3 {shape} N={N} J={J} K={K} O_l={t.by_point.shape[1]} "
                f"O_p={t.by_pose.shape[1]} {tag}: kernel {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, max|err| {worst:.3e}")


def phase_kernels(torch, kernels):
    results = {}
    _kernel_k1(torch, kernels["K1"], results)
    _kernel_full_batch(torch, kernels, results)
    return results


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


def phase_cpu(kernels, data, window_poses, full_poses):
    import numpy as np

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
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not set(phases) <= set(PHASES) or ("cpu" in phases and "slice" not in phases):
        fail(f"bad --phases {phases}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from ceres_slam_tpu_torch.ops import schur_kernel, stereo_factor_kernel, window_kernel
    except ImportError as e:
        fail(f"cannot import the port: {e}")
    kernels = {"K1": window_kernel, "K2": stereo_factor_kernel, "K3": schur_kernel}

    smi = phase_device(torch)
    if "build" in phases or "kernels" in phases:
        phase_build(kernels)
    k = phase_kernels(torch, kernels) if "kernels" in phases else {}
    launches = {name: 0 for name in kernels}
    if "slice" in phases:
        data = os.path.join(ROOT, "build", "chip_smoke_data")
        shutil.rmtree(data, ignore_errors=True)
        os.makedirs(data)
        launches, window_poses, full_poses = phase_slice(kernels, data)
        if "cpu" in phases:
            phase_cpu(kernels, data, window_poses, full_poses)
    nan = {"max_abs_err": math.nan, "ms": math.nan, "plain_ms": math.nan}
    log(json.dumps({"kernels": [{
        "name": fn, "route": "cuda", "source": f"ceres_slam_tpu_torch/csrc/{src}",
        "replaces": f"ceres_slam_tpu/ops/pallas_kernels.py{line}", "launches": launches[name],
        **k.get((name, shape, "f64"), nan)} for name, fn, src, line, shape in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
