"""Sun-aided sliding-window VO driver (the flagship workload).

  python -m ceres_slam_tpu_torch.apps.dataset_vo_sun <track> <ref_sun> <obs_sun>
      [--window 2] [--huber-param 0] [--az-err-thresh 1000] [--zen-err-thresh 1000]
      [--sun-only] [--dtype float64|float32] [--strategy dogleg|lm]
      [--checkpoint PATH] [--checkpoint-every 25] [--tr-loop device|host] [--device cuda]

Port of ``ceres_slam_tpu/apps/dataset_vo_sun.py``: a VO-only pass (unless
``--sun-only``) writing ``<track>_poses.csv``, then a VO+sun pass writing
``<track>_<sunmethod>_poses.csv``, the sun method being the last
'_'-token of the obs-sun file stem. Thresholds are given in degrees. The
two passes are independent (each chains from pose 0 and restarts the
covariance chain), so by default they run together as one batch of two
(``problems/batch_scan.py``: one K1 launch a trust-region iteration serves
both passes' windows), as the JAX app does; the files equal the sequential
passes' to the bit. ``--sun-only`` and ``--checkpoint`` run the passes one
after the other, as the JAX app's sequential branch does, each from the
loaded dataset's state (``pass_copy``): the sun pass does not start from
the VO pass's solved first pose. ``--checkpoint PATH`` saves each pass's state every
``--checkpoint-every`` windows to ``PATH.vo`` / ``PATH.sun``; a run that
was interrupted resumes from them, and a pass that completes deletes its
file.

On the card each window solve (each step of the batch) is one graph launch:
the trust-region loop runs in a CUDA graph's WHILE node, captured once per
pass (``solver/window.py``). ``--tr-loop host`` runs the same loop body on
the host instead, one host-read stop test per iteration, and writes the
same bytes; it is an explicit switch, not a fallback (a capture that fails
raises). On the CPU the host loop is the only form.

Two settings differ from the JAX app on purpose: ``--ftol 0`` is a
tolerance of 0 (the JAX app reads it as unset), and the float32 tolerance
is chosen by the pass's window count (the JAX app passes the state count).
"""

from __future__ import annotations

import math
import sys
import time


def build_parser():
    from ceres_slam_tpu_torch.apps.common import base_parser

    p = base_parser("dataset_vo_sun: sun-aided sliding-window stereo VO")
    p.add_argument("track_file")
    p.add_argument("ref_sun_file")
    p.add_argument("obs_sun_file")
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--huber-param", type=float, default=0.0)
    p.add_argument("--az-err-thresh", type=float, default=1000.0, help="degrees")
    p.add_argument("--zen-err-thresh", type=float, default=1000.0, help="degrees")
    p.add_argument("--sun-only", action="store_true")
    p.add_argument("--ftol", type=float, default=None,
                   help="override ftol/xtol (default: common.solver_tolerance)")
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"],
                   help="state and factor-pass dtype (the Schur solve is float64 in both)")
    p.add_argument("--strategy", default="dogleg", choices=["dogleg", "lm"],
                   help="trust-region strategy (reference: SUBSPACE_DOGLEG)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint-restart: save the pass state every --checkpoint-every "
                        "windows (per-pass files PATH.vo / PATH.sun); an interrupted run "
                        "resumes from the last checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=25, metavar="N",
                   help="windows between checkpoints")
    add_loop_argument(p)
    return p


def add_loop_argument(p):
    p.add_argument("--tr-loop", choices=["device", "host"], default=None,
                   help="where the window trust-region loop runs: in a WHILE node on the card "
                        "(device, the CUDA default) or on the host (host, the CPU's only form)")


def solve_config(args, num_windows: int):
    """Nonmonotonic steps (the reference's use_nonmonotonic_steps) with
    ftol = xtol = ``--ftol`` if given, else the precision- and
    chain-length-matched default for ``num_windows`` windows."""
    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    tol = args.ftol if args.ftol is not None else common.solver_tolerance(args.dtype, num_windows)
    return SolveConfig(max_iters=args.max_iters, nonmonotonic=True, ftol=tol, xtol=tol,
                       record_history=args.report == "full")


def main(argv=None) -> dict:
    """Run the app; returns the run's phase walls and counts."""
    args = build_parser().parse_args(argv)
    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun

    device = common.resolve_device(args.device)
    t0 = time.perf_counter()
    dataset = DatasetProblemSun.read_csv(args.track_file, args.ref_sun_file, args.obs_sun_file)
    dataset.dtype = args.dtype
    dataset.device = str(device)
    num_windows = max(1, dataset.num_states - (args.window or dataset.num_states) + 1)
    config = solve_config(args, num_windows)
    print(f"Loaded {dataset.num_states} states, {dataset.num_points} points, "
          f"{dataset.state_ids.size} stereo obs, {int(dataset.state_has_sun_obs.sum())} "
          f"sun obs; device {device}, {args.dtype}", file=sys.stderr)
    t1 = time.perf_counter()
    dataset.precompute_pair_alignments()
    t2 = time.perf_counter()

    track_base = args.track_file.rsplit(".", 1)[0]
    sun_method = args.obs_sun_file.rsplit(".", 1)[0].split("_")[-1]
    passes = []
    if not args.sun_only:
        passes.append(("vo", dict(use_sun=False), f"{track_base}_poses.csv"))
    passes.append(("sun", dict(use_sun=True, huber_param=args.huber_param,
                               az_err_thresh=args.az_err_thresh * math.pi / 180.0,
                               zen_err_thresh=args.zen_err_thresh * math.pi / 180.0),
                   f"{track_base}_{sun_method}_poses.csv"))
    stats = {"device": str(device), "dtype": args.dtype, "states": dataset.num_states,
             "load_s": t1 - t0, "ransac_s": t2 - t1, "passes": {},
             "batched": not args.sun_only and not args.checkpoint}
    from ceres_slam_tpu_torch.utils import csvio

    def record(name, out, summaries, wall):
        common.print_reports(summaries, args.report)
        iters = sum(s.iterations for s in summaries)
        stats["passes"][name] = p = {
            "output": out, "windows": len(summaries), "iterations": iters, "wall_s": wall,
            "iterations_by_window": [s.iterations for s in summaries],
            "windows_per_s": len(summaries) / wall if wall > 0 else math.nan,
            "mean_iters": iters / max(len(summaries), 1),
        }
        print(f"  pass {name}: {p['windows']} windows in {wall:.2f} s "
              f"({p['windows_per_s']:.1f} windows/s, {p['mean_iters']:.2f} iterations/window)",
              file=sys.stderr)

    if stats["batched"]:
        from ceres_slam_tpu_torch.problems import batch_scan

        print("Computing VO without / with sun measurements (one batch of two passes)",
              file=sys.stderr)
        ts = time.perf_counter()
        results = batch_scan.solve_batch(
            [batch_scan.RunSpec(dataset, **kwargs) for _, kwargs, _ in passes],
            window=args.window or dataset.num_states, config=config, strategy=args.strategy,
            progress=True, loop=args.tr_loop)
        # the passes share the batch's wall
        stats["batch_wall_s"] = wall = time.perf_counter() - ts
        for (name, _, out), res in zip(passes, results):
            csvio.write_poses_csv(out, res.poses)
            record(name, out, res.summaries, wall)
    else:
        for name, kwargs, out in passes:
            print(f"Computing VO {'with' if kwargs['use_sun'] else 'without'} sun measurements",
                  file=sys.stderr)
            ts = time.perf_counter()
            ds = dataset.pass_copy()
            summaries = ds.solve_sliding_window(
                window=args.window, config=config, strategy=args.strategy, progress=True,
                checkpoint=f"{args.checkpoint}.{name}" if args.checkpoint else None,
                checkpoint_every=args.checkpoint_every, loop=args.tr_loop, **kwargs)
            wall = time.perf_counter() - ts
            csvio.write_poses_csv(out, ds.poses)
            record(name, out, summaries, wall)
    stats["total_s"] = time.perf_counter() - t0
    print(f"  load {stats['load_s']:.2f} s, RANSAC {stats['ransac_s']:.2f} s, "
          f"total {stats['total_s']:.2f} s", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
