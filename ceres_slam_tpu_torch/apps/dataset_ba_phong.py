"""Phong-illumination BA command-line app.

  python -m ceres_slam_tpu_torch.apps.dataset_ba_phong <track>.csv [--nolight] [--dirlight]
      [--multistage] [--window N] [--linear-solver auto|dense|schur]
      [--dtype float64|float32] [--lm-loop device|host] [--report none|brief|full]
      [--device cuda]

Port of ``ceres_slam_tpu/apps/dataset_ba_phong.py`` (the reference's
``dataset_ba_phong``): reads the Phong track CSV, runs the full-trajectory
VO initial guess with the material and texture initialization (written as
``<track>_initial_{poses,map,lights}.csv``), solves geometry and lighting
(optionally with the 3-stage schedule, optionally in windows of N poses)
and writes ``<track>_poses.csv``, ``<track>_map.csv`` and
``<track>_lights.csv``. ``--linear-solver auto`` picks the dense Cholesky
up to ~1k dof and the vertex-Schur solver beyond. On the card each stage's
LM loop runs as one conditional WHILE node (``--lm-loop device``, the
default there; a pass captures each stage once and restarts it for every
later window); ``--lm-loop host`` iterates it on the host, the CPU's form
and its default; both write the same bytes. ``--lm-loop device`` on the
CPU raises. ``--device`` defaults to ``cuda`` and exits without a card
(``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import sys
import time


def build_parser():
    from ceres_slam_tpu_torch.apps.common import base_parser

    p = base_parser("dataset_ba_phong: joint geometry + Phong lighting BA")
    p.add_argument("input_file")
    p.add_argument("--nolight", action="store_true", help="geometry only")
    p.add_argument("--dirlight", action="store_true", help="directional light model")
    p.add_argument("--multistage", action="store_true", help="3-stage solve schedule")
    p.add_argument("--window", type=int, default=0, help="0 = full batch")
    p.add_argument("--linear-solver", default="auto", choices=["auto", "dense", "schur"],
                   help="auto picks schur past ~1k dof (full batch), dense at window scale")
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"],
                   help="solver dtype (RANSAC, factors and solves alike)")
    p.add_argument("--lm-loop", choices=["device", "host"], default=None,
                   help="each stage's LM loop as a WHILE node on the card (the default there) "
                        "or on the host (the default on the CPU)")
    return p


def main(argv=None):
    """Run the app; returns the run's walls, per-stage figures and outputs."""
    args = build_parser().parse_args(argv)
    from ceres_slam_tpu_torch.apps import common

    with common.traced(args):
        return _run(args)


def _run(args):
    """``main`` on its parsed ``args``."""
    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
    from ceres_slam_tpu_torch.solver import lm, phong

    device = common.resolve_device(args.device)
    lm_loop = phong.resolve_lm_loop(device, args.lm_loop)
    t0 = time.perf_counter()
    dataset = DatasetProblemPhong.read_csv(args.input_file, directional_light=args.dirlight)
    dataset.dtype = args.dtype
    dataset.device = str(device)
    print(f"Loaded {dataset.num_states} states, {dataset.num_vertices} vertices, "
          f"{dataset.num_materials} materials, {dataset.state_ids.size} observations; "
          f"device {device}, {args.dtype}", file=sys.stderr)
    t1 = time.perf_counter()
    # the VO initial guess, written before refinement
    dataset.compute_initial_guess()
    base = args.input_file.rsplit(".", 1)[0]
    dataset.write_csv(base + "_initial.csv")
    dataset.reset_points()
    t2 = time.perf_counter()
    # ftol: Ceres' default function tolerance, which the reference keeps
    config = lm.SolveConfig(max_iters=args.max_iters, ftol=1e-6,
                         record_history=args.report == "full")
    graph0 = dict(lm.GRAPH_STATS)
    summaries = dataset.solve_full(window=args.window, use_light=not args.nolight,
                                   multistage=args.multistage, config=config,
                                   linear_solver=args.linear_solver, lm_loop=lm_loop)
    t3 = time.perf_counter()
    if args.report != "none":
        common.print_reports(summaries, args.report)
    else:
        for i, s in enumerate(summaries):
            print(f"stage {i}: cost {s.initial_cost:.6e} -> {s.final_cost:.6e} "
                  f"in {s.iterations} iterations")
    dataset.write_csv(args.input_file)
    lm_iters = sum(s.iterations for s in summaries)
    stats = {
        "device": str(device), "dtype": args.dtype, "states": dataset.num_states,
        "vertices": dataset.num_vertices, "observations": int(dataset.state_ids.size),
        "stages": [{"iterations": s.iterations, "initial_cost": s.initial_cost,
                    "final_cost": s.final_cost} for s in summaries],
        "lm_iterations": lm_iters, "lm_loop": lm_loop,
        "lm_graph_captures": lm.GRAPH_STATS["captures"] - graph0["captures"],
        "lm_graph_restarts": lm.GRAPH_STATS["restarts"] - graph0["restarts"],
        "load_s": t1 - t0, "init_s": t2 - t1, "solve_s": t3 - t2,
        "it_s": lm_iters / (t3 - t2) if t3 > t2 else float("nan"),
        "total_s": time.perf_counter() - t0,
        "poses": base + "_poses.csv", "map": base + "_map.csv", "lights": base + "_lights.csv",
    }
    print(f"  load {stats['load_s']:.2f} s, initial guess {stats['init_s']:.2f} s, solve "
          f"{stats['solve_s']:.2f} s ({lm_iters} LM iterations, {stats['it_s']:.1f} it/s; LM "
          f"loop {lm_loop}, captures {stats['lm_graph_captures']}, restarts "
          f"{stats['lm_graph_restarts']}), total {stats['total_s']:.2f} s", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
