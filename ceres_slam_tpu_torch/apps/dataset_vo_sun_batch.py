"""Batched flagship harness: a grid of independent sliding-window runs
solved together on one device.

    python -m ceres_slam_tpu_torch.apps.dataset_vo_sun_batch --sims DATA_DIR
        [--num-states 200] [--sequences triangle square penta] [--window 2]
        [--dtype float64|float32] [--strategy dogleg|lm] [--tr-loop device|host]
        [--device cuda]
    python -m ceres_slam_tpu_torch.apps.dataset_vo_sun_batch --run TRACK,REF_SUN,OBS_SUN,MODE ...

Port of ``ceres_slam_tpu/apps/dataset_vo_sun_batch.py``. The reference
harness loops 3 sequences x sun configurations through ``dataset_vo_sun``
one run after the other (``scripts/ba_all_sims.sh``); every run is
independent, and one chain leaves the device mostly idle. This app
solves all runs in lockstep (``problems/batch_scan.py``): step w solves
window w of every run in one batch, one K1 launch a trust-region
iteration.

``--sims`` builds the reference grid (per sequence ``<name> =
<seq><num-states>``: one VO-only run and one sun run per
``<name>_sun_dir_*.csv``) and writes what the sequential harness writes:
``<name>_poses.csv`` and ``<name>_<method>_poses.csv``, the method being
the last '_'-token of the obs-sun file stem. ``--run`` adds a run; MODE is
``vo`` or ``sun``. RANSAC runs once per track, shared by its datasets.
Thresholds are given in degrees. ``--sequential`` solves the same runs one
after the other (each through ``solve_sliding_window`` on its own copy of
the state) and writes the same files, for comparison with the batch.
``--tr-loop`` is ``dataset_vo_sun``'s: on the card a step of the batch is
one graph launch (``device``, the default there), or the same loop on the
host (``host``). The
float32 tolerance is chosen by the largest window count of the batch (the
JAX app passes a state count).
"""

from __future__ import annotations

import glob
import math
import os
import sys
import time


def build_parser():
    from ceres_slam_tpu_torch.apps.common import base_parser

    p = base_parser("dataset_vo_sun_batch: batched independent VO+sun runs")
    p.add_argument("--sims", default=None, metavar="DATA_DIR",
                   help="build the ba_all_sims grid from this directory")
    p.add_argument("--num-states", type=int, default=200)
    p.add_argument("--sequences", nargs="*", default=["triangle", "square", "penta"])
    p.add_argument("--run", action="append", default=[], metavar="TRACK,REF,OBS,MODE",
                   help="explicit run (MODE: vo|sun); repeatable")
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--huber-param", type=float, default=0.0)
    p.add_argument("--az-err-thresh", type=float, default=1000.0, help="degrees")
    p.add_argument("--zen-err-thresh", type=float, default=1000.0, help="degrees")
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--strategy", default="dogleg", choices=["dogleg", "lm"])
    p.add_argument("--sequential", action="store_true",
                   help="solve the runs one after the other instead (for comparison)")
    from ceres_slam_tpu_torch.apps.dataset_vo_sun import add_loop_argument

    add_loop_argument(p)
    return p


def grid_runs(sims: str, num_states: int = 200,
              sequences=("triangle", "square", "penta")) -> list:
    """``(track, ref, obs, mode)`` of the grid in ``sims``: per sequence with
    a track file, the VO-only run (``obs`` None) and a sun run per sun file."""
    runs = []
    for seq in sequences:
        name = f"{seq}{num_states}"
        track = os.path.join(sims, f"{name}.csv")
        if not os.path.exists(track):
            continue
        ref = os.path.join(sims, f"{name}_sun_ref.csv")
        runs.append((track, ref, None, "vo"))
        for obs in sorted(glob.glob(os.path.join(sims, f"{name}_sun_dir_*.csv"))):
            runs.append((track, ref, obs, "sun"))
    return runs


def load_runs(triples: list, dtype: str = "float64", device="cuda", huber_param: float = 0.0,
              az_err_thresh: float = 1000.0, zen_err_thresh: float = 1000.0):
    """``(runs, outputs)``: a ``batch_scan.RunSpec`` and the poses file of each
    ``(track, ref, obs, mode)`` (thresholds in radians). One dataset per
    (track, obs-sun) file pair; a VO run (``obs`` None) shares the dataset of
    its track's first sun file (the reader needs one; the sun observations
    are not used); the datasets of one track share its RANSAC precompute."""
    from ceres_slam_tpu_torch.problems import batch_scan
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun

    datasets, runs, outs = {}, [], []
    for track, ref, obs, mode in triples:
        if obs is None:
            obs = next((t[2] for t in triples if t[0] == track and t[2]), None)
            if obs is None:
                print(f"WARNING: skipping the VO-only run of {track}: no sun-obs file for it "
                      "(the CSV reader needs one; <name>_poses.csv will not be written)",
                      file=sys.stderr)
                continue
        if (track, obs) not in datasets:
            ds = DatasetProblemSun.read_csv(track, ref, obs)
            ds.dtype, ds.device = dtype, str(device)
            datasets[(track, obs)] = ds
        ds = datasets[(track, obs)]
        base = track.rsplit(".", 1)[0]
        if mode == "vo":
            runs.append(batch_scan.RunSpec(ds, use_sun=False))
            outs.append(f"{base}_poses.csv")
        else:
            runs.append(batch_scan.RunSpec(ds, use_sun=True, huber_param=huber_param,
                                           az_err_thresh=az_err_thresh,
                                           zen_err_thresh=zen_err_thresh))
            outs.append(f"{base}_{obs.rsplit('.', 1)[0].split('_')[-1]}_poses.csv")
    by_track = {}
    for (track, _), ds in datasets.items():
        by_track.setdefault(track, []).append(ds)
    for group in by_track.values():
        group[0].precompute_pair_alignments()
        for other in group[1:]:
            other._pair_T = group[0]._pair_T
            other._pair_inliers = group[0]._pair_inliers
            other._pair_num_inliers = group[0]._pair_num_inliers
    return runs, outs


def main(argv=None) -> dict:
    """Run the app; returns the wall of the solve (and of the set-up: the
    CSVs and RANSAC), the windows solved and each run's output and
    iterations."""
    p = build_parser()
    args = p.parse_args(argv)
    from ceres_slam_tpu_torch.apps import common

    with common.traced(args):
        return _run(args, p)


def _run(args, p) -> dict:
    """``main`` on its parsed ``args`` (``p``: the parser, for its errors)."""
    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.problems import batch_scan
    from ceres_slam_tpu_torch.utils import csvio

    device = common.resolve_device(args.device)
    triples = grid_runs(args.sims, args.num_states, args.sequences) if args.sims else []
    for spec in args.run:
        fields = spec.split(",")
        if len(fields) != 4 or fields[3] not in ("vo", "sun"):
            p.error(f"--run {spec!r}: expected TRACK,REF,OBS,MODE with MODE vo or sun")
        triples.append(tuple(fields))
    if not triples:
        p.error("no runs (use --sims or --run)")
    t0 = time.perf_counter()
    runs, outs = load_runs(triples, args.dtype, device, args.huber_param,
                           args.az_err_thresh * math.pi / 180.0,
                           args.zen_err_thresh * math.pi / 180.0)
    if not runs:
        p.error("no runs left to solve")
    t1 = time.perf_counter()

    window = args.window
    num_windows = max(r.ds.num_states - window + 1 for r in runs)
    tol = common.solver_tolerance(args.dtype, num_windows)
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    config = SolveConfig(max_iters=args.max_iters, nonmonotonic=True, ftol=tol, xtol=tol,
                         record_history=args.report == "full")
    print(f"{'Sequential' if args.sequential else 'Batch'}: {len(runs)} runs, window {window}; "
          f"device {device}, {args.dtype}", file=sys.stderr)
    ts = time.perf_counter()
    if args.sequential:
        results = []
        for r in runs:
            ds = r.ds.pass_copy()
            summaries = ds.solve_sliding_window(
                window=window, use_sun=r.use_sun, huber_param=r.huber_param,
                az_err_thresh=r.az_err_thresh, zen_err_thresh=r.zen_err_thresh, config=config,
                strategy=args.strategy, loop=args.tr_loop)
            results.append((ds.poses, summaries, None))
    else:
        results = [(res.poses, res.summaries, res.ok) for res in batch_scan.solve_batch(
            runs, window=window, config=config, strategy=args.strategy, progress=True,
            loop=args.tr_loop)]
    wall = time.perf_counter() - ts
    n_windows = sum(len(summaries) for _, summaries, _ in results)
    stats = {"device": str(device), "dtype": args.dtype, "sequential": args.sequential,
             "setup_s": t1 - t0, "wall_s": wall, "windows": n_windows,
             "windows_per_s": n_windows / wall if wall > 0 else math.nan, "runs": []}
    print(f"{'Sequential' if args.sequential else 'Batch'} solved: {wall:.2f} s wall, "
          f"{n_windows} windows ({stats['windows_per_s']:.1f} windows/s aggregate)",
          file=sys.stderr)
    for (poses, summaries, ok), out in zip(results, outs):
        csvio.write_poses_csv(out, poses)
        common.print_reports(summaries, args.report)
        run = {"output": out, "windows": len(summaries),
               "iterations": sum(s.iterations for s in summaries)}
        if ok is not None:  # per window index, 0 where the window was not solved
            solved = iter(summaries)
            run["iterations_by_window"] = [next(solved).iterations if o else 0 for o in ok]
        stats["runs"].append(run)
        print(f"wrote {out}", file=sys.stderr)
    stats["total_s"] = time.perf_counter() - t0
    return stats


if __name__ == "__main__":
    main()
