"""Stereo VO / full-batch BA command-line app.

  python -m ceres_slam_tpu_torch.apps.dataset_vo <track>_vo.csv [--window 0]
      [--dtype float64|float32] [--linear-solver auto|dense|window|pcg]
      [--lm-loop device|host] [--cg-loop device|host] [--device cuda]

Port of ``ceres_slam_tpu/apps/dataset_vo.py``: reads the plain track CSV,
runs the VO initial guess and BA with the first pose of each window held
constant (``--window 0``, the default, is one full-batch solve), with
Levenberg-Marquardt and nonmonotonic steps, and writes ``<track>_poses.csv``
and ``<track>_map.csv``. ``--linear-solver auto`` picks dense Cholesky at
window scale, the explicit-Schur window solver up to 128 poses and
matrix-free Schur-PCG beyond (the full-batch path, kernels K2 and K3 on
CUDA). On the card the Schur-PCG solve runs its LM loop as one conditional
WHILE node with the CG loop's WHILE node nested in it (``--lm-loop
device --cg-loop device``, the default there); ``--lm-loop host`` runs
the LM loop on the host around the CG loop's node, ``--cg-loop host`` the
CG loop on the host too (it needs ``--lm-loop host``, which it implies
when ``--lm-loop`` is not given; ``--lm-loop device --cg-loop host``
raises). The dense solver (``--linear-solver dense``, and ``auto`` at
window scale) runs its LM loop as one WHILE node on the card too, captured
once for the pass and restarted for every later window (``--lm-loop
device``, the default there; ``--lm-loop host`` iterates it on the host).
On the CPU every loop runs on the host. Every form writes the same bytes.
The window solver refuses both switches, the dense solver ``--cg-loop``.

The float32 tolerance is chosen by the window count (the JAX app passes
the state count; ROADMAP F5). Full batch is one window either way.
"""

from __future__ import annotations

import sys
import time


def build_parser():
    from ceres_slam_tpu_torch.apps.common import base_parser

    p = base_parser("dataset_vo: stereo VO / full-batch bundle adjustment")
    p.add_argument("input_file")
    p.add_argument("--window", type=int, default=0, help="0 = full batch")
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"],
                   help="state and solver dtype")
    p.add_argument("--linear-solver", default="auto", choices=["auto", "dense", "window", "pcg"],
                   help="auto selects by problem size: dense at window scale, "
                        "explicit Schur to 128 poses, Schur-PCG beyond")
    p.add_argument("--lm-loop", choices=["device", "host"], default=None,
                   help="Schur-PCG and dense: the LM loop as a WHILE node on the card (the "
                        "default there) or on the host")
    p.add_argument("--cg-loop", choices=["device", "host"], default=None,
                   help="Schur-PCG: the CG loop as a WHILE node on the card (the default "
                        "there; nested in the LM loop's node under --lm-loop device) or on "
                        "the host (needs --lm-loop host)")
    return p


def main(argv=None) -> dict:
    """Run the app; returns the run's phase walls, iteration counts and outputs."""
    args = build_parser().parse_args(argv)
    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    device = common.resolve_device(args.device)
    t0 = time.perf_counter()
    dataset = DatasetProblem.read_csv(args.input_file)
    dataset.dtype = args.dtype
    dataset.device = str(device)
    print(f"Loaded {dataset.num_states} states, {dataset.num_points} points, "
          f"{dataset.state_ids.size} observations; device {device}, {args.dtype}",
          file=sys.stderr)
    num_windows = max(1, dataset.num_states - (args.window or dataset.num_states) + 1)
    tol = common.solver_tolerance(args.dtype, num_windows)
    # the reference's minimizer: LM with nonmonotonic steps
    config = SolveConfig(max_iters=args.max_iters, nonmonotonic=True, ftol=tol, xtol=tol,
                         record_history=args.report == "full")
    t1 = time.perf_counter()
    dataset.precompute_pair_alignments()
    t2 = time.perf_counter()
    from ceres_slam_tpu_torch.solver import lm

    graph0 = dict(lm.GRAPH_STATS)
    summaries = dataset.solve_full(window=args.window, config=config,
                                   linear_solver=args.linear_solver, cg_loop=args.cg_loop,
                                   lm_loop=args.lm_loop)
    t3 = time.perf_counter()
    if args.report != "none":
        common.print_reports(summaries, args.report)
    else:
        for i, s in enumerate(summaries):
            print(f"window {i}: cost {s.initial_cost:.6e} -> {s.final_cost:.6e} "
                  f"in {s.iterations} iterations")
    dataset.write_csv(args.input_file)
    base = args.input_file.rsplit(".", 1)[0]
    lm_iters = sum(s.iterations for s in summaries)
    stats = {
        "device": str(device), "dtype": args.dtype, "states": dataset.num_states,
        "windows": len(summaries), "lm_iterations": lm_iters,
        "cg_iterations": sum(s.linear_iterations for s in summaries),
        "lm_graph_captures": lm.GRAPH_STATS["captures"] - graph0["captures"],
        "lm_graph_restarts": lm.GRAPH_STATS["restarts"] - graph0["restarts"],
        "initial_cost": summaries[0].initial_cost if summaries else float("nan"),
        "final_cost": summaries[-1].final_cost if summaries else float("nan"),
        "load_s": t1 - t0, "ransac_s": t2 - t1, "solve_s": t3 - t2,
        "total_s": time.perf_counter() - t0,
        "poses": base + "_poses.csv", "map": base + "_map.csv",
    }
    print(f"  load {stats['load_s']:.2f} s, RANSAC {stats['ransac_s']:.2f} s, solve "
          f"{stats['solve_s']:.2f} s ({lm_iters} LM iterations, {stats['cg_iterations']} CG "
          f"iterations; LM loop captures {stats['lm_graph_captures']}, restarts "
          f"{stats['lm_graph_restarts']}), total {stats['total_s']:.2f} s", file=sys.stderr)
    return stats


if __name__ == "__main__":
    main()
