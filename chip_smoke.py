#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (``--phases`` selects a subset, for bring-up; the default runs all):

  device   the card's name and power limit (nvidia-smi), torch and CUDA versions
  build    compiles the kernels K1 (csrc/window_factor_blocks.cu), K2
           (csrc/stereo_factor_blocks.cu), K3 (csrc/schur_uy.cu), K4
           (csrc/bilinear_sample_imgs.cu), P (csrc/double_kernel.cu), S
           (csrc/subspace_step.cu, the dogleg's 2x2 subproblem, a kernel of
           the port), AR (csrc/peer_allreduce.cu, the sharded solves'
           all-reduce on the ranks of one host, a kernel of the port), CG
           (csrc/cg_step.cu, the fused CG iteration's update, a kernel of
           the port) and the device WHILE loop (csrc/graph_while.cu) with nvcc, one
           process each, all started together; the loop's build checks that
           the toolkit, the driver and PyTorch's runtime are CUDA 12.3 or
           newer (conditional graph nodes; 12.4 for a node nested in
           another, which the full-batch LM loop builds)
  kernels  each kernel against its plain PyTorch version on the card, in
           float64 and float32, with median times per call (CUDA events
           around the wrapper, host included): K1 at the flagship window
           shape (K=2, J=192, O=2) and the S scale (K=64, J=2048, 16,384
           slots), called twice for equal bits; the batched K1 (one launch
           for B windows) at the sliding-window grid's padded window (B=15,
           K=2, J=128, O=2) and at kitti1100's (B=2, K=2, J=192, O=2): each
           window bit-equal to its single-window launch, within the same
           tolerance of the batched plain version, beside B single launches
           back to back; K2 (fused with its pose and
           landmark sums) and K3 (bound to the full-batch plan) at the
           full-batch shapes of triangle200 (N 12,992, J 448, K 200) and
           kitti1100 (N 124,480, J 16,640, K 1,100), called twice for equal
           bits, with host time per call back to back; K4 at the photometric shape
           (3x240x320, N 68,096) and at KITTI's full resolution (3x375x1242,
           N 440,134), equal to its plain versions bit for bit, its packing
           (once per solve) timed apart, beside one
           torch.nn.functional.grid_sample call (its yardstick, which the
           port never calls); P (o = 2 x on [2, 512] float32) in both launch
           forms, eager and captured in a CUDA graph, equal to x * 2 (x * 8
           after 3 launches) bit for bit, host us per launch eager and per
           replayed launch, and P in a conditional WHILE node: host us per
           launch of the whole loop, device us per iteration; P's path, the
           graph probe's six P cases (apps/probe_graph_loop.py), run in this
           process with P's launches counted, the two while cases
           (grid_in_while: a counter on the device stops the loop at 3;
           grid_in_while_data: while sum(x) < 8 sum(x0)) bit-equal to x * 8
           and to the same loop on the host; S (subspace_step) at B 1, 2
           and 15 and each of its seven cases alone (interior, boundary,
           indefinite, hard case, degenerate basis, zero gradient, not
           finite), float64 and float32, bit-equal to its plain version,
           with its latency bound (a window's chain counted from the
           source at the latencies apps/probe_op_latency measures on the
           card) and, in the profile phase, each case's device time alone;
           the fused CG iteration at kitti1100's shape (pcg.random_system),
           float64 and float32: schur_sp (K3 with Hpp p - and the first dot
           in its pose phase) against the plan's matvec, cg_update against
           cg_body's in-place iteration given the same S p, and 30 fused
           iterations against cg_body with schur_matvec_plan and the
           block-Jacobi preconditioner, each from the plain iterate, two
           calls bit-equal, with their bounds; and
           the host cost of the two ways to read PyTorch's current stream
  slice    generates triangle200 and kitti1100 with the port's make_sim and
           runs both CLIs on CUDA: the flagship sliding window (dataset_vo_sun,
           its two passes one batch of two; triangle200 float64 and float32,
           kitti1100 float64), each with its trust-region loop in the WHILE
           node and on the host in turns (--tr-loop device, host, device;
           kitti1100 device, host),
           which must write byte-identical *_poses.csv with the same
           iterations in every window (the windows K1 served at least the
           windows solved in both forms; ATE against the JAX figures; the
           pass walls, the captures' and restarts' host times), and
           full-batch BA
           (dataset_vo --window 0, the same three runs, with its defaults on
           the card: the LM loop in a WHILE node, the CG loop's WHILE node
           nested in it; K2 once per LM iteration and K3 once per CG
           iteration, in either form, and cg_update once per schur_sp,
           one capture, final cost and ATE against the JAX
           figures), then solve_ba_pcg on the same problems with its loops
           in turns (CG / LM: host / host, device / host, device / device
           twice, the second a restart of the first's capture, device /
           host, host / host) at triangle200 float64 and float32,
           triangle200 float64 with the banded preconditioner forced and
           kitti1100 float64: the same LM and CG iterations and the same
           bits in all six, K2 once per LM iteration, K3 once per CG
           iteration and, with block-Jacobi, the fused schur_sp and
           cg_update too (none banded), and the CLI's final cost; and a checkpoint resume:
           the triangle200 float64 sun pass
           (--sun-only --checkpoint PATH --checkpoint-every 25) killed in a
           child process once its checkpoint holds window 100 or later,
           then run again, resuming, which must write the uninterrupted
           run's *_poses.csv byte for byte (K1 launches in the resumed part)
  batch    the batched grid: make_sim writes triangle200, square200 and
           penta200 with --sun-noise 0 10 20 30 into a grid directory, and
           dataset_vo_sun_batch --sims solves its 15 chains (VO-only + 4 sun
           configurations a sequence, 199 windows each) in lockstep, float64,
           its trust-region loop in the WHILE node, then on the host and in
           the node again (byte-identical files, the same iterations; walls in
           turns): each chain's ATE within 15% of the JAX figures, the triangle200 VO
           and gtsun10 chains within 1e-6 (poses) of one sequential
           solve_sliding_window pass each, K1 launched at least once per
           batched trust-region iteration and never alone; the wall,
           aggregate windows/s, launches and windows per launch
  dense    dense photometric alignment through the dense_stereo CLI at
           240x320 (68,096 aligned pixels), float64: rendered disparities
           (--gt-disparity) against the JAX figures, the full chain (SGM,
           Sobel, alignment) against the JAX figures, both as --pairs 3
           (pair 0 is the JAX figures' seed), and --images on three
           rendered .npy files, each run with --lm-loop device --match-loop
           device (the LM loop one WHILE node with K4 inside, the matcher
           one captured CUDA graph) and then both on the host: the same
           iterations, costs, pose and valid pixels bit for bit in every
           pair, in the device form one capture each in the first pair and
           a restart of the node and a replay of the matcher in every later
           one, the CLI walls of every pair in both forms; K4 launched
           twice an LM iteration plus once a pair in either form; the
           matcher at 240x320 (float32) as a graph and eagerly in turns:
           capture and instantiation seconds, the walls, the replays
           bit-equal; then
           the photometric rate of scripts/bench_xl.py (float32, 20 LM
           iterations under run_full_budget) in both LM loop forms, the
           node restarted through one LMGraph, 3 timed repetitions each in
           turns, and the node's device us per LM iteration (CUDA events)
  phong    Phong-illumination BA through the dataset_ba_phong CLI: phong200
           (make_sim --kind phong --num-states 200 --num-points 1000: K=200,
           J=1,000 vertices, ~31k observations, 3 materials, a point light)
           --multistage in float64 and float32 (auto picks the vertex-Schur
           solver), phong60 --dirlight (directional light) and phong30
           --window 5, each with each stage's LM loop in its conditional
           WHILE node and on the host in turns (--lm-loop device, host; the
           next case host, device): the same LM iterations per stage and
           byte-identical _poses.csv, _map.csv and _lights.csv in both
           forms, one capture a stage restarted for every later window
           (phong30: 1 capture, 25 restarts), each stage's final cost and
           the ATE against the JAX figures; LM iterations/s of both forms
           with the card's name and power limit
  graph    the FactorGraph API (solver/graph.py) in float64: triangle200
           built from the VO initial guess (every state a pose, pose 0
           fixed; every initialized landmark a point; every observation a
           factor with the sim's covariance, added landmark by landmark),
           solved with dense, schur, pcg (K2 and K3 through the full-batch
           plan of that row order) and dense + dogleg, the final costs
           against each other and the JAX figures (dogleg: 6 iterations),
           covariance(1) against the CPU's; dense, schur and the dense
           dogleg with their loop in its WHILE node (the default on the
           card, one capture a solve), then on the host and in the node
           again: the same iterations and bits, the walls in turns; kitti1100 (N 124,480, J 16,640) with pcg against the
           JAX figure, K2's and K3's launches printed (pcg's CG loop runs
           in the WHILE node on the card); then triangle200's dataset_vo
           --window 2 --linear-solver dense (199 windows) with --lm-loop
           device, host, device: byte-identical CSVs, the same LM
           iterations, in the node one capture and 198 restarts
  blowup   the covariance blow-up experiment (apps/blowup.py) at the
           reference's 1,000 poses on the card, the chain in its WHILE node
           (each step's LM loop a node nested in it), on the host and in
           the node again: bit-identical covariances and LM iterations, each
           run's max relative deviation from the closed form against the
           JAX figure, the wall, solves/s, LM iterations and captures of
           each form, the node's device time (CUDA events)
  live_vo  live stereo VO (apps/stereo_vo.py): 100 frames rendered by the
           port at 319x1056 with KITTI's sequence-00 camera scaled by 0.85
           (the JAX package does not track at 375x1242: its Harris
           response threshold finds ~10-20 corners on the rendered wall),
           written as .npy files and run through the CLI's glob mode with
           --frame-loop device / host / device in turns (each tracked frame
           two captured graphs around the eager SVD, or launch by launch):
           the three runs' _poses.csv byte-identical, ATE against the JAX
           figure, frames/s, capture and instantiation seconds, median
           corners and matches, and each form's launches, syncs and copies
           per frame (profiled); then 10 frames at 375x1242 with the camera
           unscaled, counts only
  dist     the distributed layer (parallel/*) with its ranks as child
           processes of this script, each joined through
           multihost.initialize and the CERES_* environment: (a) kitti1100's
           full batch (N 124,480, J 16,640, f64) on one NCCL rank: first AR
           (the peer all-reduce, psum's route on NCCL ranks of one host)
           against its plain version at the path's sizes (a CG iteration's
           U^T v and U y, the LM step's blocks, f64; U^T v in f32):
           bit-equal, also after 3 replays of a captured graph and in a
           WHILE node run and restarted; its time a call in a captured run
           of 21 in-place calls less a run of 1 (CUDA events; the device
           time by torch.profiler the same way) beside the plain version's
           and dist.all_reduce's (in place, back to back) and its bound; then
           solve_ba_pcg_sharded (block-Jacobi, solve_full's configuration)
           with the LM loop in a WHILE node (the CG node nested, the
           all-reduces captured), on the host, and in the node again
           (restarted): the same bits, iterations and collectives, every
           collective one AR launch, against the JAX full-batch cost and
           ATE, K2 once per LM iteration on the rank's shard plan, ms per CG
           iteration of each form beside the single-card solve_ba_pcg's in
           this process, one CG iteration of each form profiled (the node:
           0 launches, syncs and copies);
           (b) triangle200 on two gloo ranks sharing the card (host form;
           the device form's refusal logged; AR checked across the two
           processes, bit-equal): the sharded normal equations against
           the single-card ones, gn_step_sharded, solve_ba_sharded and
           solve_ba_pcg_sharded (jacobi, banded) against the JAX sharded
           costs and the port's single-card solves, both ranks the same
           bits; (c) a 2x2 hybrid mesh of four gloo ranks: its normal
           equations against the single-card ones; (d) reported:
           gn_step_sharded at scripts/bench_scaling.py's default shape (64
           poses, 2,048 landmarks, 65,536 observations, f32) on the ranks of
           (a) and (b), eagerly and (NCCL) replayed from its captured graph
           (bit-equal), with the collectives and bytes per step; where more
           than one card is visible (a machine of several cards), the graph
           probe's psum_in_while on every card (must pass) and nccl_in_while
           (NCCL's own all-reduce in the same stages: its kernels and node
           types, reported), then (e) (a) on every card, one NCCL rank a
           card, every form gated as in (a) and on every rank the same bits,
           ms per CG iteration of each form beside the earlier figures
           of PERF.md, and (f) (c) as a 2 x n/2 mesh of NCCL ranks with its
           block-Jacobi solve in the node (the default) and host forms
  cpu      triangle200 float64 once more on the CPU, through both BA CLIs
           (poses must equal the CUDA runs' to 1e-6; all runs draw the same
           RANSAC hypotheses: seed 42 + pair, the threefry draw is integer
           arithmetic, the same bits on either device), FactorGraph(pcg)
           at triangle200 (poses equal the card's to 1e-6), and the dense
           --gt-disparity run (pose equal to the CUDA run's to 1e-8)
  profile  torch.profiler, last, so that no profiler session precedes a
           timed run: the device time per call (the sum of its kernels) of
           every kernel checked in the kernels phase (and of grid_sample)
           with the share of its bound, failing unless K1 runs one device
           kernel per call and K2 and K3 two; for K2 and K3 each kernel's
           (phase's) time and the device time per call of calls back to
           back, the gaps between kernels included; torch.mul(x, 2)'s device time
           beside P's; K4's device time on the path's own
           coordinates (the 240x320 problem's projections, float64 and
           float32); kitti1100's full problem (float64): one
           build_obs_blocks and one CG iteration (device time, kernels,
           launches, syncs, copies), and the CG loop in both forms side by
           side (host loop and WHILE node: per CG iteration device time,
           launches, syncs, copies; one LM iteration's CG solve in turns,
           the device loop captured for the call and captured once and
           reused, as solve_ba_pcg's host LM loop does; the capture, build
           and instantiation, against the reused loop's copies and
           restart); the LM loop in its WHILE node with the CG node nested:
           device us per LM iteration (CUDA events around the node, runs of
           3 and 12 LM iterations) and the host's launches, syncs and
           copies a solve, which must not grow with the iterations;
           a trace of one photometric rate
           solve with the host loop (device busy share, launches per LM
           iteration), the photometric LM node restarted for 3 and 12 LM
           iterations (host launches, graph launches, syncs and copies,
           which must be equal, with one graph launch), and one matcher
           pair eagerly and replayed (launches, graph launches, device
           kernels, busy share); and, after
           the phong phase, phong200's joint stage (float64, vertex-Schur)
           in both LM loop forms: 5 LM iterations of the host loop traced,
           and the WHILE node restarted for 5 and 15 LM iterations (host
           launches, graph launches, syncs and copies a solve, which must
           not grow with the iterations; the node's device us per LM
           iteration by CUDA events; the device busy share of both forms;
           unprofiled walls in turns), and after the blowup phase the chain
           in both forms: 10 solves of the host form traced, and the node
           at 11 and 31 poses traced (host launches, graph launches, syncs
           and copies, which must be equal, with one graph launch) and
           timed by CUDA events (device us a chain step, busy share), and after the batch phase (the slice phase)
           a trace of one step of the grid (kitti1100's two flagship passes),
           window 20 of its chains solved together, with the trust-region
           loop on the host and in the WHILE node: launches, graph launches,
           syncs and copies a step and an iteration, the device busy share,
           and the node's device us per trust-region iteration (CUDA events:
           the profiler sees a node's first pass only). It runs whenever the kernels phase
           runs with no main-path phase (slice, dense, phong) after it.

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
import contextlib
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
PHASES = ("device", "build", "kernels", "slice", "batch", "dense", "phong", "graph", "blowup",
          "live_vo", "dist", "cpu", "profile")

# JAX package reference ATEs [m] (f64, --window 2, gtsun10 obs file), and
# the relative bound each run is held to: the 1,100-window chain gets a
# looser one, its ATE is sensitive to small differences along the chain.
JAX_ATE = {"triangle200": {"vo": 0.3079, "sun": 0.3252},
           "kitti1100": {"vo": 10.1957, "sun": 9.4062}}
ATE_BOUND = {"triangle200": 0.15, "kitti1100": 0.30}

# JAX package reference ATEs [m] of the batched grid (dataset_vo_sun_batch
# --sims over triangle200, square200, penta200 with sun noise 0, 10, 20, 30
# degrees; float64, window 2, on a CPU; recorded by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_batch.py DIR
# ), each chain held to 15% as the flagship runs are. The batched K1's
# shapes: the grid's padded window (15 chains) and kitti1100's (the
# flagship's two passes).
JAX_GRID_ATE = {
    "triangle200": {"vo": 0.3078744672055887, "gtsun0": 0.11567067093296915,
                    "gtsun10": 0.3251794973471536, "gtsun20": 0.41141736284667246,
                    "gtsun30": 0.4396799674310402},
    "square200": {"vo": 0.2963890054012385, "gtsun0": 0.25597432105901646,
                  "gtsun10": 0.3630550779007953, "gtsun20": 0.42477540742171827,
                  "gtsun30": 0.4313725929705812},
    "penta200": {"vo": 0.3949418419645134, "gtsun0": 0.2521623397170816,
                 "gtsun10": 0.323058716224605, "gtsun20": 0.3314065003324104,
                 "gtsun30": 0.30362212687936857},
}
GRID_ATE_BOUND, GRID_SEQ_ATOL = 0.15, 1e-6
K1_BATCH_SHAPES = {"grid": (15, 2, 128, 2), "kitti1100": (2, 2, 192, 2)}

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
OPS_PER_ROW = {"K1": 750, "K2": 650, "K3": 90, "P": 1}
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

# JAX package reference figures of dataset_ba_phong (each stage's final
# cost, then the ATE [m] against ground truth; on a CPU, for the port's
# make_sim output at the same sizes and seed 0, with --max-iters 1000 and
# ftol 1e-6 as the app sets them). phong30 --window 5 solves 26 windows: its
# last window's final cost. The bounds (relative on the costs, absolute on
# the ATE): the port on the CPU lands within ~1e-9 of the float64 costs
# (it takes JAX's RANSAC hypotheses and every solve the same steps), so
# 1e-6 leaves room for the card's order of sums and stays far below any
# change of minimum; float32 sums round at ~6e-8 per term over ~31k
# observations, and JAX's own float32 run lands 2.3e-7 from its float64
# cost and 0.1 mm from its ATE, so 1e-4 and 1 mm; the 26 chained windows
# carry each window's rounding into the next, so 1e-5 and 1 mm.
JAX_PHONG = {
    "phong200 float64": ([44907.44617987456, 106159.62152712909, 106147.28045223694],
                         0.004005475743688968),
    "phong200 float32": ([44907.44140625, 106159.6015625, 106147.3046875], 0.00410522274851653),
    "phong60 dirlight": ([9259.855724445255], 0.01194270982689677),
    "phong30 window5": ([358.42567110045786], 0.06184270490929676),
}
PHONG_BOUNDS = {"phong200 float64": (1e-6, 1e-4), "phong200 float32": (1e-4, 1e-3),
                "phong60 dirlight": (1e-6, 1e-4), "phong30 window5": (1e-5, 1e-3)}
PHONG_WINDOWS = 26

# JAX package reference figures of the FactorGraph API (solver/graph.py,
# float64, on a CPU; tests/test_torch_graph.py's __main__ records them):
# LM (or dogleg) iterations and final cost per (linear solver, strategy),
# on the graph of DatasetProblem.factor_graph over the sims' VO initial
# guess. The bounds: the four triangle200 solves reach one minimum (the
# port on the CPU lands within 2e-15 of these costs), so rtol 1e-6 among
# them and against JAX; kitti1100's pcg (113,724 factors) stops at the
# graph's 100-iteration budget short of its minimum, where the order of
# the sums moves the path: 2%, as the full-batch run's bound.
JAX_GRAPH = {
    "triangle200": {("dense", "lm"): (6, 18365.436329814453), ("schur", "lm"): (6, 18365.43632981447),
                    ("pcg", "lm"): (7, 18365.436329814194),
                    ("dense", "dogleg"): (6, 18365.436329814238)},
    "kitti1100": {("pcg", "lm"): (100, 2234982.291090859)},
}
GRAPH_RTOL = {"triangle200": 1e-6, "kitti1100": 0.02}
GRAPH_COV_RTOL = 1e-9

# The JAX app's max relative deviation of the solver's covariance from the
# closed form over the 1,000-pose blow-up chain (float64, on a CPU;
# tests/test_torch_pose_graph.py's __main__); the port's is held to it
# within 1e-6 absolute.
JAX_BLOWUP_DEV, BLOWUP_ATOL = 1.1907235439453968e-09, 1e-6

# Live VO: the size and camera of the run, and the JAX app's ATE [m] on the
# same 100 rendered frames (float64, on a CPU; tests/test_torch_stereo_vo.py's
# __main__), held to 10%. KITTI's sequence-00 camera is scaled by 0.85 with
# the image: at 375x1242 the JAX package finds too few corners on the
# rendered wall to track, at 0.85 every frame keeps more than 30 matches.
LIVE_VO_SHAPE = (319, 1056)
LIVE_VO_CAMERA = (611.0276, 611.0276, 516.11388, 157.433345, 0.5372)
KITTI_CAMERA = (718.856, 718.856, 607.1928, 185.2157, 0.5372)
JAX_LIVE_VO_ATE, LIVE_VO_RTOL = 0.9849833301897621, 0.10

# The distributed layer: solve_full's float64 configuration, and the JAX
# package's sharded functions on the triangle200 full-batch problem
# (float64, on a CPU, 8 virtual devices: the dataset layer's VO initial
# guess, dataset_vo --window 0's problem), recorded by
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sharded.py DIR
# each run's final cost (gn_step: the cost after the one step from the
# initial guess; the solves take 6 LM iterations). The bounds: the card's
# sums run in another order than JAX's on 8 devices, which moves a converged
# cost by ~1e-15 and one GN step's by rounding; 1e-6 relative on the costs,
# 1e-6 on the poses against the port's single-card solves, and the sharded
# normal equations within 1e-9 of the single-card ones, relative to the
# largest entry (H reaches 1.5e8 here, where an absolute 1e-9 is below one
# ulp).
DIST_CONFIG = dict(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
# NVLink between the cards of one H100 host, each way (data sheet): the peer
# all-reduce's bound reads (n - 1) x the buffer from the peers over it
NVLINK_BYTES_PER_S = 450e9
# what the sharded CG iteration is read against: the earlier figures of
# PERF.md (4 ranks with the host loop; one NCCL rank, node restarted and
# host form)
DIST_CG_MS_BEFORE = ("PERF.md: 4 ranks, host loop: 1.500 ms; one rank: node 0.6265-0.6293 ms, "
                     "host 0.8771-1.1008 ms")
JAX_DIST = {"gn_step": 604221.8305333192, "solve_ba": 18365.436329814467,
            "jacobi": 18365.43632981848, "banded": 18365.436329814467}
DIST_COST_RTOL, DIST_POSE_ATOL, DIST_NORMAL_EQ_RTOL = 1e-6, 1e-6, 1e-9


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
    """One nvcc per source, all started together (the kernels and the
    device WHILE loop's library, whose build checks the CUDA versions)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(kernels)) as ex:
            paths = dict(zip(kernels, ex.map(lambda m: m.build(), kernels.values())))
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f} s")
    if "loop" in kernels:
        v = {k: ".".join(map(str, x)) for k, x in kernels["loop"].versions().items()}
        log(f"[build] CUDA for the device WHILE loop (conditional nodes need 12.3): toolkit "
            f"{v['toolkit']}, driver {v['driver']}, PyTorch's runtime {v['torch']}")
    for name, path in paths.items():
        log(f"[build] {name}: {os.path.relpath(path, ROOT)}")
        for ln in open(path[:-3] + ".log"):
            if "registers" in ln or "smem" in ln:
                log(f"[build]   {ln.strip()}")


def _medians_ms(torch, fns, reps=50, before=None):
    """Median time per call of each function, CUDA events around the call
    (host included), the functions taken in turns so that they share the
    host's and the card's state (pair only calls of like cost: a heavy one
    leaves the host's caches cold for the next). ``before(i)``, where
    given, runs ahead of the events of each call of function ``i``."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for i, (fn, t) in enumerate(zip(fns, times)):
            if before is not None:
                before(i)
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
            "graph_launches": sum(n.startswith("cudaGraphLaunch") for n in host),
            "syncs": sum("Synchronize" in n for n in host),
            "copies": sum(n.startswith("cudaMemcpy") for n in host), "wall_us": wall * 1e6}


def _profile_full_batch(torch, data):
    """kitti1100's full problem (the dataset_vo --window 0 problem, float64,
    from the CLI's initial guess): one build_obs_blocks, and the CG loop in
    both forms, side by side (block-Jacobi): the host loop (``cg``, loop=
    "host") and the WHILE node on the card (``device_cg``): per CG
    iteration (21 iterations less 1, tol 0, under the profiler) launches,
    syncs and copies, and device time (the host loop's from the profiler;
    the node's from CUDA events around its launch, since the profiler sees
    only the first pass of a conditional node's body); then one LM
    iteration's CG solve at pcg_step's settings (100 iterations, tol 1e-6)
    in turns: the host loop, the device loop captured for the call, and
    the device loop captured once and reused (solve_ba_pcg's CGGraph),
    with the first's set-up, capture, build and instantiation, run and
    close, and the second's copies and restart. The plan and the gather tables are built
    beforehand, as solve_ba_pcg builds them once per problem."""
    from ceres_slam_tpu_torch.ops import full_batch_plan, graph_loop
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

    def cg(n, loop, tol=0.0):
        return lambda: pcg.pcg_solve(b, rhs, n, tol, tables=tables, precond=precond, loop=loop)

    node_us = _node_us_per_iteration(torch, b, precond, rhs)
    for loop in ("host", "device"):
        cg(21, loop)()
        one, many = _trace(torch, cg(1, loop)), _trace(torch, cg(21, loop))
        d = {k: (many[k] - one[k]) / 20 for k in one}
        dev = (f"{d['device_us']:.2f} us of device time (profiler), {d['kernels']:g} device "
               "kernels" if loop == "host" else f"{node_us:.2f} us of device time (CUDA events "
               "around the node, gaps included)")
        log(f"[profile] full batch kitti1100 f64, CG loop {loop}: one CG iteration {dev}, "
            f"{d['launches']:g} launches, {d['syncs']:g} syncs, {d['copies']:g} copies, wall "
            f"{d['wall_us']:.1f} us (profiled); per CG solve {one['launches']:g} launches, "
            f"{one['syncs']:g} syncs, {one['copies']:g} copies (1 iteration)")
    graph = pcg.CGGraph()
    forms = {"host": cg(100, "host", 1e-6), "device": cg(100, "device", 1e-6),
             "reused": lambda: pcg.pcg_solve(b, rhs, 100, 1e-6, tables=tables, precond=precond,
                                             loop="device", graph=graph)}
    forms["reused"]()
    walls = {k: [] for k in forms}
    for _ in range(5):
        for form in ("host", "device", "reused", "reused", "device", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, n = forms[form]()
            torch.cuda.synchronize()
            walls[form].append(time.perf_counter() - t0)
    parts = {k: [] for k in ("setup", "capture", "build", "run", "close")}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = pcg.cg_loop(lambda v: pcg.schur_matvec_plan(b, v), precond, rhs, 100, 1e-6,
                         pcg.fused_inputs(b, precond))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop = graph_loop.DeviceWhile(lp.body, lp.pred)
        t2 = time.perf_counter()
        loop.run()
        t3 = time.perf_counter()
        loop.close()
        torch.cuda.synchronize()
        for k, v in zip(parts, (t1 - t0, loop.capture_s, loop.build_s, t3 - t2,
                                time.perf_counter() - t3)):
            parts[k].append(v * 1e3)
    restart = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for dst, src in zip(graph.inputs, pcg.loop_inputs(b, precond)):
            dst.copy_(src)
        graph.lp.restart(rhs)
        torch.cuda.synchronize()
        restart.append((time.perf_counter() - t0) * 1e3)
    graph.close()
    names = {"host": "host loop", "device": "device loop captured for the call",
             "reused": "device loop captured once, reused (solve_ba_pcg's)"}
    log(f"[profile] full batch kitti1100 f64: one LM iteration's CG solve ({n} iterations, "
        "block-Jacobi, tol 1e-6), wall in turns, median of 10 (min-max): " + "; ".join(
            f"{names[k]} {statistics.median(v) * 1e3:.2f} ms ({min(v) * 1e3:.2f}-"
            f"{max(v) * 1e3:.2f}), {statistics.median(v) / n * 1e6:.1f} us per CG iteration"
            for k, v in walls.items()))
    log("[profile] full batch kitti1100 f64: the device loop's parts per LM iteration, ms "
        "(median of 5): captured for the call: " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in parts.items())
        + f"; reused: copies and restart {statistics.median(restart):.3f}, then the run")
    _profile_lm_node(torch, problem, state, tables, plan, node_us)


def _lm_node_ms(torch, problem, state, tables, plan, n, max_cg_iters):
    """The LM node of ``n`` LM iterations (run_full_budget) at
    ``max_cg_iters``: captured by a first solve, then the device time of
    its launch after a restart (CUDA events, median of 5 after one
    discarded), its CG iterations, and one restarted solve under the
    profiler."""
    from ceres_slam_tpu_torch.solver import lm, pcg
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    cfg = SolveConfig(max_iters=n, run_full_budget=True)
    graph = lm.LMGraph()

    def solve():
        return pcg.solve_ba_pcg(problem, state, cfg, max_cg_iters=max_cg_iters, tables=tables,
                                plan=plan, precond="jacobi", graph=graph)

    _, summ = solve()
    t = _trace(torch, solve)
    _, lp, node = next(iter(graph.loops.values()))
    times = []
    for _ in range(6):
        lp.restart()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        node.launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    graph.close()
    if summ.iterations != n:
        fail(f"kitti1100 LM node, run_full_budget {n}: {summ.iterations} LM iterations")
    return statistics.median(times[1:]), summ.linear_iterations, t


def _profile_lm_node(torch, problem, state, tables, plan, cg_us):
    """kitti1100's LM loop in its WHILE node with the CG node nested
    (float64, block-Jacobi, from the CLI's initial guess), runs of 3 and of
    12 LM iterations (run_full_budget), each captured once and restarted
    (``_lm_node_ms``): the difference over 9 per LM iteration beside the
    CG iterations it holds, at solve_ba_pcg's 100 CG iterations at most
    and at 1 (the LM body outside CG, less one CG iteration; ``cg_us``: a
    CG iteration in the CG loop's own node); the host's launches, syncs
    and copies a solve must not grow with the LM iterations. Then the LM
    body's kernels (eager, one CG iteration) by device time."""
    from ceres_slam_tpu_torch.ops.full_batch_trace import kernel_ms
    from ceres_slam_tpu_torch.solver import lm, pcg

    for max_cg in (100, 1):
        res = {n: _lm_node_ms(torch, problem, state, tables, plan, n, max_cg) for n in (3, 12)}
        per_lm = (res[12][0] - res[3][0]) / 9 * 1e3
        cg = (res[12][1] - res[3][1]) / 9
        host = {k: res[12][2][k] - res[3][2][k] for k in ("launches", "syncs", "copies")}
        log(f"[profile] full batch kitti1100 f64, LM loop in its WHILE node (CG node nested, at "
            f"most {max_cg} CG iterations): node {res[3][0]:.3f} ms for 3 LM iterations "
            f"({res[3][1]} CG), {res[12][0]:.3f} ms for 12 ({res[12][1]} CG): {per_lm:.1f} us of "
            f"device time per LM iteration (CUDA events), {cg:.1f} CG iterations in it "
            f"({cg * cg_us:.1f} us at {cg_us:.2f} us each), the rest {per_lm - cg * cg_us:.1f} "
            f"us; per solve (profiled, restarted) 3 / 12 iterations: "
            f"{res[3][2]['launches']:g} / {res[12][2]['launches']:g} launches, "
            f"{res[3][2]['graph_launches']:g} / {res[12][2]['graph_launches']:g} graph launches, "
            f"{res[3][2]['syncs']:g} / {res[12][2]['syncs']:g} syncs, {res[3][2]['copies']:g} / "
            f"{res[12][2]['copies']:g} copies, wall {res[3][2]['wall_us'] / 1e3:.2f} / "
            f"{res[12][2]['wall_us'] / 1e3:.2f} ms")
        if any(host.values()):
            fail(f"kitti1100 LM node: host work grows with the LM iterations: {host} for 9 more")
    cfg = lm.SolveConfig(max_iters=1, run_full_budget=True)
    cost, step, retract = pcg.lm_functions(
        problem, *pcg.prepare(problem, state, tables, plan, "jacobi"), max_cg_iters=1,
        loop="host")
    carry = lm.lm_start(state, cfg, cost)
    by_name, kernels = kernel_ms(lambda: lm.lm_body(step, cost, retract, cfg, carry))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] full batch kitti1100 f64, one LM iteration eagerly (1 CG iteration): "
        f"{sum(by_name.values()) * 1e3:.1f} us of device time in {kernels:g} kernels; the "
        "largest: " + ", ".join(f"{n} {t * 1e3:.1f} us" for n, t in top))


def _node_us_per_iteration(torch, b, precond, rhs):
    """Device us per CG iteration inside the WHILE node, the iteration
    ``pcg_solve`` runs (fused with block-Jacobi): CUDA events around
    the loop's launch (its state reset before each), for 21 and 1
    iterations (tol 0), the difference over 20; median of 10 each."""
    from ceres_slam_tpu_torch.ops import graph_loop
    from ceres_slam_tpu_torch.solver import pcg

    s0, _ = pcg.cg_start(precond, rhs, 0.0)
    ms = {}
    for n in (1, 21):
        lp = pcg.cg_loop(lambda v: pcg.schur_matvec_plan(b, v), precond, rhs, n, 0.0,
                         pcg.fused_inputs(b, precond))
        loop = graph_loop.DeviceWhile(lp.body, lp.pred)
        times = []
        for _ in range(11):
            for buf, t in zip(lp.s, s0):
                buf.copy_(t)
            lp.i.zero_()
            lp.pred.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop.launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        loop.close()
        ms[n] = statistics.median(times[1:])
    return (ms[21] - ms[1]) / 20 * 1e3


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


def _kernel_k1_batch(torch, window_kernel, results, jobs):
    """The batched K1 (one launch for B windows) against the single-window
    launches on the same windows (bit for bit) and its plain version."""
    fn = window_kernel.window_factor_blocks_batch
    for shape, (B, K, J, O) in K1_BATCH_SHAPES.items():
        for dtype in (torch.float64, torch.float32):
            tag = "f64" if dtype == torch.float64 else "f32"
            label = f"K1 batch {shape} B={B} K={K} J={J} O={O} {tag}"
            plan, poses, points, single = window_kernel.random_batch_inputs(
                B, K, J, O, dtype, "cuda", seed=9)
            args = (plan, poses, points)
            out, again = fn(*args), fn(*args)
            alone = [window_kernel.window_factor_blocks(*a) for a in single]
            plain = window_kernel.window_factor_blocks_batch_plain(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                fail(f"{label}: two calls on the same inputs differ")
            for b, one in enumerate(alone):
                if not all(torch.equal(x[b], y) for x, y in zip(out, one)):
                    fail(f"{label}: window {b} differs from its single-window launch")
            worst = 0.0
            for b in range(B):
                kern = _split(tuple(x[b] for x in out))
                ref = _split(tuple(x[b] for x in plain))
                for name, r in ref.items():
                    err = (kern[name].double() - r.double()).abs().max().item()
                    worst = max(worst, err)
                    tol = TOL64 if dtype == torch.float64 else TOL32[name]
                    if not torch.isfinite(kern[name]).all() or not err <= tol * r.double().abs().max().item():
                        fail(f"{label}: window {b} {name} max|err| {err:.3e}")
            ms, singles_ms = _medians_ms(torch, [
                lambda: fn(*args), lambda: [window_kernel.window_factor_blocks(*a) for a in single]])
            plain_ms = _median_ms(torch, lambda: window_kernel.window_factor_blocks_batch_plain(*args),
                                  reps=10)
            host_us = _host_us(torch, lambda: fn(*args))
            S = int(plan.pose_start[-1, -1])  # the by-pose tables are padded past S
            inputs = (poses, points, plan.pose_idx, plan.obs[:, :14], plan.pose_start,
                      plan.point_by_pose[:S], plan.cams)
            row = results[("K1 batch", shape, tag)] = {
                "B": B, "max_abs_err": worst, "ms": ms, "singles_ms": singles_ms,
                "plain_ms": plain_ms, **_bound(inputs, out, OPS_PER_ROW["K1"] * B * J * O, tag),
                "library_ms": None}
            jobs.append((label, lambda a=args: fn(*a), row))
            log(f"[kernels] {label}: kernel {ms * 1e3:.1f} us (host {host_us:.1f} us per call "
                f"back to back) for {B} windows, {B} single-window launches {singles_ms * 1e3:.1f} "
                f"us, plain {plain_ms * 1e3:.1f} us, {_bound_str(row)}, every window bit-equal to "
                f"its single launch, two calls bit-equal, max|err| vs plain {worst:.3e}")


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


def _kernel_p(torch, P, results, jobs):
    """P in both launch forms, eager and captured in a CUDA graph (3
    launches), against its plain version bit for bit; wrapper, plain and
    library times; host us per launch eager and per replayed launch."""
    x = torch.arange(1024, dtype=torch.float32, device="cuda").reshape(2, 512)
    plain = P.double_kernel_plain(x)
    graphs = {}
    for one_block in (False, True):
        form = "1 block" if one_block else "4 blocks"
        got = P.double_kernel(x, one_block=one_block)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            fail(f"P ({form}): eager launch differs from x * 2")
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = x
            for _ in range(3):
                y = P.double_kernel(y, one_block=one_block)
        g.replay()
        torch.cuda.synchronize()
        if not torch.equal(y, plain * 4):
            fail(f"P ({form}): 3 graph-captured launches differ from x * 8")
        graphs[one_block] = g
    ms, plain_ms, library_ms = _medians_ms(torch, [
        lambda: P.double_kernel(x), lambda: P.double_kernel_plain(x), lambda: torch.mul(x, 2)])
    one_ms = _median_ms(torch, lambda: P.double_kernel(x, one_block=True))
    eager_us = _host_us(torch, lambda: P.double_kernel(x))
    replay_us = _host_us(torch, graphs[False].replay) / 3
    results[("P", "2x512", "f32")] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                      **_bound(x, plain, OPS_PER_ROW["P"] * x.numel(), "f32"),
                                      "library_ms": library_ms}
    jobs.append(("P 2x512 f32 (4 blocks)", lambda: P.double_kernel(x), results[("P", "2x512", "f32")]))
    jobs.append(("P 2x512 f32 (1 block)", lambda: P.double_kernel(x, one_block=True), None))
    jobs.append(("P 2x512 f32 torch.mul(x, 2)", lambda: torch.mul(x, 2), None))
    log(f"[kernels] P [2, 512] f32: kernel {ms * 1e3:.1f} us (1 block {one_ms * 1e3:.1f} us), "
        f"plain {plain_ms * 1e3:.1f} us, torch.mul {library_ms * 1e3:.1f} us, "
        f"{_bound_str(results[('P', '2x512', 'f32')])}; host {eager_us:.2f} us per launch eager, "
        f"{replay_us:.2f} us per replayed launch (a graph of 3); eager and graph-captured "
        "launches equal x * 2 (x * 8 after 3) bit for bit in both forms")
    _p_while_times(torch, x)


SUBSPACE_BATCHES = (1, 2, 15)
# operations of one window's 2x2 subproblem: the interior test and the
# eigen-split (~40), 64 bisection steps of 11, the fill and the projection
# (~15), four candidates' model values (~40)
SUBSPACE_OPS = 40 + 64 * 11 + 15 + 40


def _kernel_subspace(torch, sk, results, jobs):
    """The subspace_step kernel (the 2x2 subproblem of SUBSPACE_DOGLEG, one
    warp a window, the bisection in 13 rounds) against its plain version bit
    for bit, float64 and float32, at B 1, 2 (the flagship's two passes) and
    15 (the grid), and each of the subproblem's cases alone (interior,
    boundary, indefinite, hard case, degenerate basis, zero gradient, not
    finite). Its latency bound: one window's dependent chain
    (``apps/probe_op_latency.CHAIN``, counted from the source) at the
    operations' latencies the probe measures on this card."""
    from ceres_slam_tpu_torch.apps import probe_op_latency as probe

    cases = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        every, every_r = sk.random_models(7, dtype, "cuda", seed=3)
        for i in range(7):  # each case alone, as a batch of one
            cases[(tag, i)] = (every[i:i + 1].contiguous(), every_r[i:i + 1].contiguous())
        for B in SUBSPACE_BATCHES:
            cases[(tag, f"B={B}")] = sk.random_models(B, dtype, "cuda", seed=B)
    for (tag, what), (m, r) in cases.items():
        got, plain = sk.subspace_step(m, r), sk.subspace_step_plain(m, r)
        torch.cuda.synchronize()
        same = (torch.equal(torch.isnan(got), torch.isnan(plain))
                and torch.equal(torch.nan_to_num(got), torch.nan_to_num(plain)))
        if not same:
            fail(f"subspace_step {tag} {what}: kernel differs from its plain version "
                 f"({got.tolist()} vs {plain.tolist()})")
    names = ("interior", "boundary", "indefinite", "hard case", "degenerate basis",
             "zero gradient", "not finite")
    for i, name in enumerate(names):  # device time of each case alone, and of random windows
        m, r = cases[("f64", i)]
        jobs.append((f"S subspace_step B=1 {name} f64", lambda m=m, r=r: sk.subspace_step(m, r),
                     None))
    m, r = (t[7:].contiguous() for t in sk.random_models(22, torch.float64, "cuda", seed=15))
    jobs.append(("S subspace_step B=15 random models only f64",
                 lambda m=m, r=r: sk.subspace_step(m, r), None))
    lat = {}
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        lat[tag] = probe.op_latencies(dtype)
        log(f"[kernels] subspace_step {tag} latencies (apps/probe_op_latency, ns an operation): "
            + ", ".join(f"{k} {lat[tag][k]:.3f}" for k in probe.CHAIN) + f"; a window's chain "
            f"{probe.CHAIN}: latency bound {probe.latency_bound_us(lat[tag]):.3f} us")
    for B in SUBSPACE_BATCHES:
        for tag in ("f64", "f32"):
            m, r = cases[(tag, f"B={B}")]
            out = sk.subspace_step(m, r)
            ms, plain_ms = _medians_ms(torch, [lambda: sk.subspace_step(m, r),
                                               lambda: sk.subspace_step_plain(m, r)])
            host_us = _host_us(torch, lambda: sk.subspace_step(m, r))
            row = results[("S", f"B={B}", tag)] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                **_bound((m, r), out, SUBSPACE_OPS * B, tag), "library_ms": None,
                "latency_bound_ms": probe.latency_bound_us(lat[tag]) / 1e3}
            jobs.append((f"S subspace_step B={B} {tag}", lambda m=m, r=r: sk.subspace_step(m, r),
                         row))
            log(f"[kernels] subspace_step B={B} {tag}: kernel {ms * 1e3:.1f} us (host "
                f"{host_us:.1f} us per call back to back), plain {plain_ms * 1e3:.1f} us, "
                f"{_bound_str(row)}, latency bound {row['latency_bound_ms'] * 1e3:.3f} us; "
                "bit-equal to its plain version, and so is each of the 7 cases alone, in "
                "float64 and float32")


# the fused CG iteration's checks: iterations against cg_body; the update's
# bytes a pose (x, r, p, Sp, the factors' lower triangle and the dot share
# read; x, r, z written; z and p read and p written) and operations a pose
# (the step, two triangular solves, two dots, the direction)
CG_ITERATIONS = 30
CG_BYTES_PER_POSE = 82
CG_OPS_PER_POSE = 132


def _fb_counters(kernels) -> dict:
    """The launch counters of the full-batch path's kernels: K2, K3 in
    either form (``schur_sp`` counts as a K3 launch too), and the fused CG
    iteration's ``schur_sp`` (SP) and ``cg_update`` (CG)."""
    return {"K2": kernels["K2"].stereo_factor_sums, "K3": kernels["K3"].schur_uy,
            "SP": kernels["K3"].schur_sp, "CG": kernels["CG"].cg_update}


def _fb_zero(kernels) -> None:
    for w in _fb_counters(kernels).values():
        w.launches = 0


def _fb_launches(kernels) -> dict:
    """The full-batch kernels' launches since ``_fb_zero``."""
    return {name: w.launches for name, w in _fb_counters(kernels).items()}


def _kernel_cg(torch, kernels, results, jobs):
    """The fused CG iteration at kitti1100's shape (``pcg.random_system``,
    S SPD), float64 and float32: ``schur_sp`` against the plan's matvec
    and its dot shares, ``cg_update`` against ``cg_body``'s in-place
    iteration given the same ``Sp``, and 30 fused iterations against 30 of
    ``cg_body`` with ``schur_matvec_plan`` and ``_block_precond``, each
    from the plain iterate: within 1e-12 (float64) or 1e-5 (float32) of
    each vector's largest entry, two calls bit-equal. Wrapper and plain
    times (``cg_update``'s from the same iterate every call, reset outside
    the events) and the bounds of the kernels' own bytes; host us of a
    fused iteration back to back."""
    from ceres_slam_tpu_torch.solver import pcg

    sp, update = kernels["K3"].schur_sp, kernels["CG"].cg_update
    N, J, K = FULL_SHAPES["kitti1100"]
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        e, tol = (8, TOL64) if dtype == torch.float64 else (4, 1e-5)
        b, tables, rhs = pcg.random_system(N, J, K, dtype, "cuda", seed=7)
        precond = pcg._block_precond(pcg.schur_diag_blocks(b, tables))
        fused = pcg.fused_inputs(b, precond)
        if fused is None:
            fail(f"CG kitti1100 {tag}: blocks bound to K3 with block-Jacobi do not run fused")

        def matvec(v):
            return pcg.schur_matvec_plan(b, v)

        s0 = pcg.cg_start(precond, rhs, 0.0)[0]
        errs = {}

        def close(what, got, ref):
            got, ref = got.double(), ref.double()
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            errs[what] = max(errs.get(what, 0.0), err)
            if not (got.isfinite().all() and err <= tol * scale):
                fail(f"CG kitti1100 {tag}: {what} max|err| {err:.3e} vs max|ref| {scale:.3e}")

        p = s0.p
        Sp, dots = sp(b.uy, p, b.Hpp)
        again = sp(b.uy, p, b.Hpp)
        ref = matvec(p)
        torch.cuda.synchronize()
        if not (torch.equal(Sp, again[0]) and torch.equal(dots, again[1])):
            fail(f"schur_sp kitti1100 {tag}: two calls on the same inputs differ")
        close("Sp", Sp, ref)
        close("dots", dots, (p * ref).sum(1))

        def loop(step):
            """``(bufs, put(s), body)``: a CG loop's buffers, a reset of them
            to the iterate ``s``, and one iteration in place: fused where
            ``step`` is None, else ``cg_body`` with the matvec ``step``."""
            bufs = pcg.cg_buffers(rhs)
            restart, body = pcg._cg_in_place(step, precond, bufs, 10 ** 6, 0.0,
                                             fused if step is None else None)
            restart(rhs)

            def put(s):
                for buf, t in zip(bufs.s, s):
                    buf.copy_(t)
                bufs.i.zero_()

            return bufs, put, body

        fb, fput, fbody = loop(None)
        pb, pput, pbody = loop(lambda v: Sp)

        def update_call():
            update(fb.s, Sp, dots, precond.chol, fb.bound, fb.i, fb.pred, 10 ** 6)

        outs = []
        for _ in range(2):
            fput(s0)
            update_call()
            outs.append([t.clone() for t in (*fb.s, fb.i, fb.pred)])
        pput(s0)
        pbody()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            fail(f"cg_update kitti1100 {tag}: two calls on the same inputs differ")
        for name, got, want in zip((*pcg.CGState._fields, "i", "pred"), outs[0],
                                   (*pb.s, pb.i, pb.pred)):
            close(f"update {name}", got, want)
        s = s0
        for _ in range(CG_ITERATIONS):
            fput(s)
            fbody()
            s = pcg.cg_body(matvec, precond, s)
            for name, got, want in zip(pcg.CGState._fields, fb.s, s):
                close(f"iteration {name}", got, want)
        sp_ms, sp_plain_ms = _medians_ms(torch, [
            lambda: sp(b.uy, p, b.Hpp), lambda: (lambda y: (y, (p * y).sum(1)))(matvec(p))])
        cg_ms, cg_plain_ms = _medians_ms(torch, [update_call, pbody],
                                         before=lambda i: (fput, pput)[i](s0))
        fput(s0)
        iter_ms = _median_ms(torch, fbody)
        fput(s0)  # 100 more iterations: CG's residual stays far from underflow
        host_us = _host_us(torch, fbody, n=100)
        sp_row = results[("SP", "kitti1100", tag)] = {
            "max_abs_err": max(errs["Sp"], errs["dots"]), "ms": sp_ms, "plain_ms": sp_plain_ms,
            **_bound_of((18 * N + 9 * J + 49 * K) * e + 8 * N,
                        OPS_PER_ROW["K3"] * N + 84 * K, tag), "library_ms": None}
        cg_row = results[("CG", "kitti1100", tag)] = {
            "max_abs_err": max(v for k, v in errs.items() if k.startswith("update")),
            "ms": cg_ms, "plain_ms": cg_plain_ms,
            **_bound_of(CG_BYTES_PER_POSE * K * e, CG_OPS_PER_POSE * K, tag),
            "library_ms": None}
        both = {"bound_ms": sp_row["bound_ms"] + cg_row["bound_ms"], "bound_by": "bytes"}
        jobs.append((f"SP schur_sp kitti1100 {tag}", lambda a=(b.uy, p, b.Hpp): sp(*a), sp_row))
        jobs.append((f"CG kitti1100 {tag}, a fused iteration (schur_sp, cg_update)", fbody, both))
        worst = max(v for k, v in errs.items() if k.startswith("iteration"))
        log(f"[kernels] schur_sp kitti1100 N={N} J={J} K={K} {tag}: kernel {sp_ms * 1e3:.1f} us, "
            f"plain (schur_matvec_plan and the dot shares) {sp_plain_ms * 1e3:.1f} us, "
            f"{_bound_str(sp_row)}, two calls bit-equal, max|err| Sp {errs['Sp']:.3e}, dots "
            f"{errs['dots']:.3e}")
        log(f"[kernels] cg_update kitti1100 K={K} {tag}: kernel {cg_ms * 1e3:.1f} us, plain "
            f"(cg_body in place given Sp) {cg_plain_ms * 1e3:.1f} us, {_bound_str(cg_row)}, two "
            f"calls bit-equal, max|err| {cg_row['max_abs_err']:.3e}; a fused iteration "
            f"{iter_ms * 1e3:.1f} us (host {host_us:.1f} us back to back); "
            f"{CG_ITERATIONS} iterations against cg_body with schur_matvec_plan, each from the "
            f"plain iterate, within {tol:g} of each vector's largest entry: max|err| {worst:.3e}")


def _p_while_times(torch, x):
    """P's while form (a DeviceWhile: P's in-place 4-block launch, a
    counter and the condition in the body): host us per launch of the
    whole loop, and device us per iteration inside the node from CUDA
    events around reset + launch, 101 iterations less 1, over 100."""
    from ceres_slam_tpu_torch.apps import probe_graph_loop

    ms, host = {}, None
    for stop in (1, 101):
        loop, buf, reset = probe_graph_loop.p_while(torch, x, stop=stop)

        def go(loop=loop, reset=reset):
            reset()
            loop.launch()

        ms[stop] = _median_ms(torch, go, reps=20)
        if stop == 101 and not torch.equal(buf, x * 2.0 ** 101):
            fail("P while (101 iterations): result differs from x * 2**101")
        host = _host_us(torch, loop.launch) if stop == 1 else host
        loop.close()
    log(f"[kernels] P while (a conditional WHILE node): host {host:.2f} us per launch of the "
        f"whole loop; device {(ms[101] - ms[1]) * 1e3 / 100:.2f} us per iteration (P, the "
        f"counter's add, compare and copy, the node's condition kernel; {ms[1] * 1e3:.1f} us "
        f"for reset + a 1-iteration loop, {ms[101] * 1e3:.1f} us for 101)")


def _p_path(torch, P):
    """P's path: the graph probe's six P cases (apps/probe_graph_loop.py)
    in this process, the two while cases in a conditional WHILE node, each
    bit-equal to x * 8 and to the same loop on the host; returns P's
    launches (the while cases' counted per iteration the device ran)."""
    from ceres_slam_tpu_torch.apps import probe_graph_loop

    P.double_kernel.launches = 0
    for case in probe_graph_loop.P_CASES:
        try:
            total = probe_graph_loop.p_case(torch, case)
        except (AssertionError, RuntimeError) as e:
            fail(f"P probe case {case}: {e}")
        log(f"[kernels] P probe {case} OK {total}")
    return P.double_kernel.launches


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
    _kernel_k1_batch(torch, kernels["K1"], results, jobs)
    _kernel_full_batch(torch, kernels, results, jobs)
    _kernel_k4(torch, kernels["K4"], results, jobs)
    _kernel_p(torch, kernels["P"], results, jobs)
    _kernel_subspace(torch, kernels["S"], results, jobs)
    _kernel_cg(torch, kernels, results, jobs)
    return results, jobs, _p_path(torch, kernels["P"])


def phase_profile(torch, jobs, dense: bool, phong: bool, data, smi, blowup: bool = False,
                  grid: bool = False, flagship: bool = False):
    """torch.profiler measurements, run last so that no profiler session
    precedes the timed main-path runs: each kernel call's device time and
    kernels per call (K1 must run one, K2, K3 and schur_sp two, a fused
    CG iteration four), K4 on the path's own
    coordinates, kitti1100's build_obs_blocks and CG iteration, and a trace
    of one photometric solve."""
    from ceres_slam_tpu_torch.ops.full_batch_trace import device_span_ms

    for label, fn, row in jobs:
        ms, kernels, by_name = _device_ms(fn)
        share = f", {100 * row['bound_ms'] / ms:.1f}% of its bound" if row else ""
        more = ""
        if label.split()[0] in ("K2", "K3", "SP", "CG"):
            span = device_span_ms(fn)
            more = (" (" + ", ".join(f"{n} {t * 1e3:.2f} us" for n, t in by_name.items())
                    + f"); {span * 1e3:.2f} us per call back to back, gaps included")
        log(f"[profile] {label}: {ms * 1e3:.2f} us of device time per call, {kernels:g} device "
            f"kernels per call{more}{share}")
        want = {"K1": 1, "K2": 2, "K3": 2, "P": 1, "S": 1, "SP": 2, "CG": 4}.get(
            label.split()[0])
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
        _profile_solve(torch, lambda: photometric.solve_photometric(problem, state0, cfg,
                                                                    lm_loop="host"))
        _profile_photometric_node(torch, smi)
    if phong:
        _profile_phong(torch, data, smi)
    if grid:
        _profile_grid_step(torch, data, smi)
    if flagship:
        _profile_flagship_step(torch, data, smi)
    if blowup:
        _profile_blowup(torch, smi)


def _profile_blowup(torch, smi):
    """The blow-up chain in both forms. The host form: 10 solves under the
    profiler (wall, device busy, kernels, launches, syncs, copies a solve).
    The WHILE node: chains of 11 and 31 poses under the profiler, whose
    host launches, graph launches, syncs and copies must be equal (none per
    chain step or LM iteration) with one graph launch; the node's device us
    a chain step from CUDA events around its launch (31 less 11 poses, over
    20 steps; median of 3 chains each) and its busy share of the
    unprofiled wall."""
    from ceres_slam_tpu_torch.apps import blowup as blowup_app

    def chain(n, loop="device"):
        return blowup_app.run_chain(n, device="cuda", chain_loop=loop)

    chain(11, "host")
    t = _trace(torch, lambda: chain(11, "host"))
    log(f"[profile] blowup, chain loop host ({smi}), 10 solves, per solve: wall "
        f"{t['wall_us'] / 1e4:.2f} ms (profiled), device busy {t['device_us'] / 1e4:.3f} ms "
        f"({100 * t['device_us'] / t['wall_us']:.2f}%), {t['kernels'] / 10:g} device kernels, "
        f"{t['launches'] / 10:g} launches, {t['syncs'] / 10:g} syncs, {t['copies'] / 10:g} copies")
    keys = ("launches", "graph_launches", "syncs", "copies")
    res = {}
    for n in (11, 31):
        chain(n)
        tr = _trace(torch, lambda: chain(n))
        stats = [chain(n)[3] for _ in range(3)]
        res[n] = (tr, statistics.median(st["node_ms"] for st in stats),
                  statistics.median(st["wall_s"] for st in stats))
    per_step = (res[31][1] - res[11][1]) / 20 * 1e3
    grow = {k: res[31][0][k] - res[11][0][k] for k in keys}
    log(f"[profile] blowup, chain loop in its WHILE node ({smi}): 11 / 31 poses (profiled): " +
        ", ".join(f"{res[11][0][k]:g} / {res[31][0][k]:g} {k.replace('_', ' ')}" for k in keys)
        + f"; the node {res[11][1]:.3f} / {res[31][1]:.3f} ms (CUDA events, median of 3): "
        f"{per_step:.1f} us of device time a chain step; unprofiled wall {res[11][2] * 1e3:.2f} / "
        f"{res[31][2] * 1e3:.2f} ms, the node {100 * res[11][1] / (res[11][2] * 1e3):.2f}% / "
        f"{100 * res[31][1] / (res[31][2] * 1e3):.2f}% of it; device busy by the profiler "
        f"{100 * res[31][0]['device_us'] / res[31][0]['wall_us']:.2f}% at 31 poses")
    if any(grow.values()):
        fail(f"blowup node: host work grows with the chain's steps: {grow} for 20 more")
    if res[11][0]["graph_launches"] != 1:
        fail(f"blowup node: {res[11][0]['graph_launches']:g} graph launches for the chain, not 1")


def _profile_phong(torch, data, smi):
    """phong200's joint stage (float64, vertex-Schur, from the VO initial
    guess, run_full_budget) in both LM loop forms. The host loop: 5 LM
    iterations under the profiler (wall, device busy, kernels, launches,
    syncs, copies). The WHILE node, captured by a first solve in an
    LMGraph and restarted after: solves of 5 and of 15 LM iterations under
    the profiler, whose host launches, graph launches, syncs and copies
    must be equal (none per LM iteration); the node's device us per LM
    iteration from CUDA events around its launch (15 less 5, over 10;
    the profiler sees a node's first pass only), and the device busy
    share with the node's later passes counted at that rate; the walls of
    unprofiled solves of 15 LM iterations in both forms, in turns."""
    from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
    from ceres_slam_tpu_torch.solver import lm, phong, phong_schur
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    ds = DatasetProblemPhong.read_csv(os.path.join(data, "phong200.csv"))
    ds.compute_initial_guess()
    problem, state, _ = ds.build_window_problem(0, ds.num_states,
                                                *ds._window_budget(ds.num_states))
    layout = phong_schur.build_phong_layout(problem)
    graphs = {n: lm.LMGraph() for n in (5, 15)}

    def solve(n, loop):
        cfg = SolveConfig(max_iters=n, ftol=0.0, gtol=0.0, run_full_budget=True)
        return phong.solve_phong_ba(problem, state, cfg, linear_solver="schur", layout=layout,
                                    lm_loop=loop, graph=graphs[n] if loop == "device" else None)

    solve(5, "host")
    t = _trace(torch, lambda: solve(5, "host"))
    log(f"[profile] phong200 joint stage float64, 5 LM iterations (vertex-Schur), LM loop host "
        f"({smi}): wall {t['wall_us'] / 5e3:.2f} ms per iteration (profiled), device busy "
        f"{t['device_us'] / 5e3:.2f} ms ({100 * t['device_us'] / t['wall_us']:.2f}%), "
        f"{t['kernels'] / 5:g} device kernels, {t['launches'] / 5:g} launches, "
        f"{t['syncs'] / 5:g} syncs, {t['copies'] / 5:g} copies per LM iteration; per solve "
        f"{t['launches']:g} launches, {t['graph_launches']:g} graph launches, {t['syncs']:g} "
        f"syncs, {t['copies']:g} copies")
    res = {}
    for n in (5, 15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, summ = solve(n, "device")  # the capture
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        if summ.iterations != n:
            fail(f"phong200 LM node, run_full_budget {n}: {summ.iterations} LM iterations")
        tr = _trace(torch, lambda: solve(n, "device"))
        _, lp, node = next(iter(graphs[n].loops.values()))
        times = []
        for _ in range(6):
            lp.restart()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            node.launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        res[n] = (statistics.median(times[1:]), tr, first)
    per_it = (res[15][0] - res[5][0]) / 10 * 1e3
    keys = ("launches", "graph_launches", "syncs", "copies")
    grow = {k: res[15][1][k] - res[5][1][k] for k in keys}
    walls = {"host": [], "device": []}
    for _ in range(3):
        for loop in ("device", "host", "host", "device"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(15, loop)
            torch.cuda.synchronize()
            walls[loop].append(time.perf_counter() - t0)
    for g in graphs.values():
        g.close()
    tr = res[5][1]
    log(f"[profile] phong200 joint stage float64 (vertex-Schur), LM loop in its WHILE node "
        f"({smi}): node {res[5][0]:.3f} ms for 5 LM iterations, {res[15][0]:.3f} ms for 15: "
        f"{per_it:.1f} us of device time per LM iteration (CUDA events); per solve (profiled, "
        f"restarted) 5 / 15 iterations: " + ", ".join(
            f"{res[5][1][k]:g} / {res[15][1][k]:g} {k.replace('_', ' ')}" for k in keys)
        + "; per LM iteration " + ", ".join(f"{grow[k] / 10:g} {k.replace('_', ' ')}"
                                            for k in keys)
        + f"; wall of the 5-iteration solve {tr['wall_us'] / 1e3:.2f} ms (profiled), device "
        f"busy {tr['device_us'] / 1e3:.2f} ms by the profiler "
        f"({100 * tr['device_us'] / tr['wall_us']:.2f}%), the node {res[5][0]:.2f} ms by CUDA "
        f"events ({100e3 * res[5][0] / tr['wall_us']:.2f}%); first solve with its capture "
        f"{res[5][2]:.3f} / {res[15][2]:.3f} s")
    log(f"[profile] phong200 joint stage float64, 15 LM iterations, unprofiled walls in turns "
        f"(median of 6, min-max): " + "; ".join(
            f"LM loop {k} {statistics.median(v) * 1e3:.2f} ms ({min(v) * 1e3:.2f}-"
            f"{max(v) * 1e3:.2f}), {15 / statistics.median(v):.2f} LM iterations/s"
            for k, v in walls.items()))
    if any(grow.values()):
        fail(f"phong200 LM node: host work grows with the LM iterations: {grow} for 10 more")


def _make_sims(data):
    """triangle200 and kitti1100 (once per run of the script)."""
    from ceres_slam_tpu_torch.apps import make_sim

    if os.path.exists(os.path.join(data, "kitti1100.csv")):
        return
    t0 = time.perf_counter()
    make_sim.main([data, "--kind", "triangle", "--num-states", "200", "--sun-noise", "10"])
    make_sim.main([data, "--kind", "kitti", "--num-states", "1100", "--sun-noise", "10"])
    log(f"[slice] sims (triangle200, kitti1100): {time.perf_counter() - t0:.2f} s")


def _reset_k1(window_kernel):
    """K1's counts and the subspace_step kernel's (the window loop's
    kernels) to 0, and the window loops' capture and restart counts."""
    from ceres_slam_tpu_torch.ops import subspace_kernel
    from ceres_slam_tpu_torch.solver import window

    single, batch = window_kernel.window_factor_blocks, window_kernel.window_factor_blocks_batch
    single.launches = batch.launches = batch.windows = subspace_kernel.subspace_step.launches = 0
    for k in window.GRAPH_STATS:
        window.GRAPH_STATS[k] = 0


def _k1_launches(window_kernel) -> dict:
    """K1's launches since ``_reset_k1``, single-window and batched, the
    windows they served, and the subspace_step kernel's launches."""
    from ceres_slam_tpu_torch.ops import subspace_kernel

    single, batch = window_kernel.window_factor_blocks, window_kernel.window_factor_blocks_batch
    return {"single": single.launches, "batch": batch.launches,
            "total": single.launches + batch.launches,
            "windows": single.launches + batch.windows,
            "S": subspace_kernel.subspace_step.launches}


def _graph_str() -> str:
    """The window loops' captures and restarts since ``_reset_k1``."""
    from ceres_slam_tpu_torch.solver import window

    g = window.GRAPH_STATS
    if not g["captures"]:
        return "no capture"
    return (f"{g['captures']} capture(s): capture {1e3 * g['capture_s'] / g['captures']:.2f} ms, "
            f"build and instantiation {1e3 * g['build_s'] / g['captures']:.2f} ms each; "
            f"{g['restarts']} restarts, {1e3 * g['restart_s'] / max(g['restarts'], 1):.3f} ms "
            "each (host)")


def _run_cli(data, seq, dtype, device, window_kernel, extra=()):
    import numpy as np

    from ceres_slam_tpu_torch.apps import dataset_vo_sun
    from ceres_slam_tpu_torch.utils import csvio, metrics

    base = os.path.join(data, seq)
    _reset_k1(window_kernel)
    stats = dataset_vo_sun.main([base + ".csv", base + "_sun_ref.csv",
                                 base + "_sun_dir_gtsun10.csv", "--window", "2",
                                 "--dtype", dtype, "--device", device, *extra])
    launches = _k1_launches(window_kernel)
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
    _fb_zero(kernels)
    stats = dataset_vo.main([base + "_vo.csv", "--window", "0", "--dtype", dtype,
                             "--device", device])  # on the card: both loops there, nested
    launches = _fb_launches(kernels)
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


# (sequence, dtype, the trust-region loop's forms in turns): kitti1100's host
# run takes ~80 s, so it runs once, beside one device run
WINDOW_TURNS = (("triangle200", "float64", ("device", "host", "device")),
                ("triangle200", "float32", ("device", "host", "device")),
                ("kitti1100", "float64", ("device", "host")))


def _slice_window(data, kernels, smi):
    """The flagship sliding-window CLI (its two passes one batch), with the
    trust-region loop on the card (``--tr-loop device``, the default) and
    on the host in turns (``WINDOW_TURNS``). The host run and the second
    device run must write the first device run's *_poses.csv byte for byte
    with the same iterations in every window; each launch of the
    batched K1 serves a window of both passes (the gate counts the windows
    served, at least one for each window solved, in both forms); every ATE
    against the JAX figures. Returns K1's and the subspace kernel's
    launches in the device runs and the triangle200 float64 poses."""
    launches, keep = {"K1": 0, "S": 0}, None
    for seq, dtype, turns in WINDOW_TURNS:
        runs = []
        for loop in turns:
            stats, k1, poses, ate = _run_cli(data, seq, dtype, "cuda", kernels["K1"],
                                             ("--tr-loop", loop))
            files = {n: open(p["output"], "rb").read() for n, p in stats["passes"].items()}
            iters = {n: p["iterations_by_window"] for n, p in stats["passes"].items()}
            runs.append((loop, stats, k1, files, iters, _graph_str()))
            windows = sum(p["windows"] for p in stats["passes"].values())
            if k1["windows"] < windows or not stats["batched"] or k1["single"]:
                fail(f"{seq} {dtype} {loop}: K1 served {k1['windows']} windows ({k1}) for "
                     f"{windows} solved windows of the batched passes")
            if loop == "device":
                if not k1["S"]:
                    fail(f"{seq} {dtype}: the dogleg's subspace_step kernel never launched")
                launches["K1"] += k1["total"]
                launches["S"] += k1["S"]
        _, ref, _, files, iters, _ = runs[0]
        for loop, stats, _, f, it, _ in runs[1:]:
            if f != files or it != iters:
                fail(f"{seq} {dtype}: --tr-loop {loop} wrote other poses or iterations than "
                     "the first device run")
        for name, r in JAX_ATE[seq].items():
            dev = abs(ate[name] - r) / r
            log(f"[slice] {seq} {dtype} {name}: ATE {ate[name]:.4f} m (JAX {r:.4f}, "
                f"{100 * dev:.2f}% off, bound {100 * ATE_BOUND[seq]:.0f}%)")
            if dev > ATE_BOUND[seq]:
                fail(f"{seq} {dtype} {name}: ATE {ate[name]:.4f} vs JAX {r:.4f}")
        walls = " / ".join(f"{loop} {st['batch_wall_s']:.2f}" for loop, st, *_ in runs)
        log(f"[slice] {seq} {dtype} ({smi}): both passes as one batch, trust-region loop in "
            f"turns: {walls} s; byte-identical *_poses.csv and the same iterations in every "
            f"window in all {len(runs)}; load {ref['load_s']:.2f} s, RANSAC "
            f"{ref['ransac_s']:.2f} s")
        for loop, st, k, *_, g in runs[:2]:
            log(f"[slice]   {loop}: K1 launches {k['total']} serving {k['windows']} windows "
                f"({k['windows'] / max(k['total'], 1):.2f} a launch), subspace_step {k['S']}; "
                f"{g}")
        for name, p in ref["passes"].items():
            log(f"[slice]   pass {name}: {p['windows']} windows, {p['mean_iters']:.2f} "
                f"iterations/window")
        if (seq, dtype) == ("triangle200", "float64"):
            keep = poses
    return launches, keep


def _slice_full(data, kernels):
    """Full-batch BA through dataset_vo (its defaults on the card: the LM
    loop in a WHILE node with the CG loop's nested in it); K2 must launch
    once per LM iteration, K3 (either form) once per CG iteration and
    cg_update once per schur_sp. Returns the full-batch kernels' launches
    (``_fb_launches``), the triangle200 float64 poses and that run's
    final cost, and each run's final cost."""
    total = dict.fromkeys(("K2", "K3", "SP", "CG"), 0)
    keep, costs = None, {}
    for seq, dtype in (("triangle200", "float64"), ("triangle200", "float32"),
                       ("kitti1100", "float64")):
        stats, launches, poses, ate = _run_full(data, seq, dtype, "cuda", kernels)
        lm_it, cg_it = stats["lm_iterations"], stats["cg_iterations"]
        if (launches["K2"] != lm_it or launches["K3"] != cg_it or not cg_it
                or launches["CG"] != launches["SP"]):
            fail(f"{seq} full batch {dtype}: {launches} launches for {lm_it} LM and {cg_it} "
                 "CG iterations")
        if stats["lm_graph_captures"] != 1:
            fail(f"{seq} full batch {dtype}: {stats['lm_graph_captures']} captures of the LM "
                 "loop, not 1 (the device LM loop is dataset_vo's default on the card)")
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
            f"K3 {launches['K3']} (of which fused, schur_sp {launches['SP']}), cg_update "
            f"{launches['CG']}; LM loop in the WHILE node, captured "
            f"{stats['lm_graph_captures']} time(s)")
        if not (cost_dev <= rtol and abs(ate - ate_ref) <= ate_atol):
            fail(f"{seq} full batch {dtype}: cost {stats['final_cost']:.6e} / ATE {ate:.6f} "
                 f"vs JAX {cost_ref:.6e} / {ate_ref:.4f}")
        if (seq, dtype) == ("triangle200", "float64"):
            keep = (poses, stats["final_cost"])
        costs[(seq, dtype)] = stats["final_cost"]
    return total, keep, costs


LOOP_TURNS = (("triangle200", "float64", "jacobi"), ("triangle200", "float32", "jacobi"),
              ("triangle200", "float64", "banded"), ("kitti1100", "float64", "jacobi"))
# (CG loop, LM loop) in turns: both on the host, the LM loop on the host
# around the CG loop's node, the LM loop's node with the CG node nested
# (twice: the second a restart of the first's capture), then back
LOOP_FORMS = (("host", "host"), ("device", "host"), ("device", "device"), ("device", "device"),
              ("device", "host"), ("host", "host"))


def _loop_turns(data, kernels, seq, dtype, precond, cli_cost):
    """solve_ba_pcg on ``seq``'s full problem, from the CLI's initial guess
    and with its settings, with its loops in turns (``LOOP_FORMS``): the CG
    loop on the host (``cg``) or in its WHILE node, the LM loop on the host
    or in its WHILE node with the CG node nested in it (one ``LMGraph``:
    the second device run restarts the first's capture). Every run must
    give the same LM and CG iterations and the same bits (poses, points,
    final cost); K2 must launch once per LM iteration and K3 once per CG
    iteration, and with block-Jacobi schur_sp and cg_update too (banded:
    neither). The block-Jacobi float64 runs must give the CLI's final
    cost (its solve ran the device loops) and the banded one the same
    minimum (rtol 1e-6). Returns the full-batch kernels' launches."""
    import torch

    from ceres_slam_tpu_torch.apps import common
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
    from ceres_slam_tpu_torch.solver import dense, lm, pcg
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    ds = DatasetProblem.read_csv(os.path.join(data, f"{seq}_vo.csv"))
    ds.dtype, ds.device = dtype, "cuda"
    ds.compute_initial_guess()
    problem, state, _ = ds.build_window_problem(0, ds.num_states,
                                                *ds._window_budget(ds.num_states)[:2])
    problem = dense.to_device(problem, "cuda")
    tol = common.solver_tolerance(dtype, 1)
    config = SolveConfig(max_iters=1000, nonmonotonic=True, ftol=tol, xtol=tol)
    total, runs, graph = dict.fromkeys(("K2", "K3", "SP", "CG"), 0), [], lm.LMGraph()
    g0 = dict(lm.GRAPH_STATS)
    for cg_loop, lm_loop in LOOP_FORMS:
        _fb_zero(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol, summ = pcg.solve_ba_pcg(problem, state, config, precond=precond, loop=cg_loop,
                                     lm_loop=lm_loop, graph=graph if lm_loop == "device" else None)
        torch.cuda.synchronize()
        runs.append(((cg_loop, lm_loop), sol, summ, time.perf_counter() - t0))
        n = _fb_launches(kernels)
        for name in total:
            total[name] += n[name]
        fused = summ.linear_iterations if precond == "jacobi" else 0
        if (n["K3"] != summ.linear_iterations or n["K2"] != summ.iterations
                or n["SP"] != fused or n["CG"] != fused):
            fail(f"{seq} {dtype} {precond} CG loop {cg_loop}, LM loop {lm_loop}: launches "
                 f"{n} for {summ.iterations} LM and {summ.linear_iterations} CG iterations")
    graph.close()
    captures = lm.GRAPH_STATS["captures"] - g0["captures"]
    restarts = lm.GRAPH_STATS["restarts"] - g0["restarts"]
    _, ref, rs, _ = runs[0]
    same = all(s.iterations == rs.iterations and s.linear_iterations == rs.linear_iterations
               and s.final_cost == rs.final_cost and torch.equal(x.poses, ref.poses)
               and torch.equal(x.points, ref.points) for _, x, s, _ in runs)
    walls = {form: [w for f2, _, _, w in runs if f2 == form] for form in dict.fromkeys(LOOP_FORMS)}
    dev = abs(rs.final_cost - cli_cost) / cli_cost
    log(f"[slice] {seq} full batch {dtype} {precond}, loops in turns (CG/LM: host/host, "
        f"device/host, device/device x2, device/host, host/host): {rs.iterations} LM, "
        f"{rs.linear_iterations} CG iterations, cost {rs.final_cost:.9e} ({dev:.2e} from the "
        f"CLI's device-loop solve), {'bit-equal' if same else 'DIFFERENT'} poses, points and "
        f"costs in all {len(runs)} runs; LM loop captures {captures}, restarts {restarts}; "
        "solve s " + ", ".join(f"{c}/{m} " + " ".join(f"{w:.3f}" for w in ws)
                               for (c, m), ws in walls.items()))
    if not same:
        fail(f"{seq} {dtype} {precond}: the loops' forms disagree")
    if (captures, restarts) != (1, 1):
        fail(f"{seq} {dtype} {precond}: {captures} captures and {restarts} restarts of the LM "
             "loop, not 1 and 1")
    if not (dev <= 1e-6 if precond == "banded" or dtype == "float32" else dev == 0.0):
        fail(f"{seq} {dtype} {precond}: cost {rs.final_cost:.9e} vs the CLI's {cli_cost:.9e}")
    return total


def _checkpoint_resume(data, window_kernel):
    """The triangle200 float64 sun pass with --checkpoint: uninterrupted
    once, then killed in a child process once its checkpoint holds window
    100 or later, and run again, resuming; the resumed run must write the
    uninterrupted run's *_poses.csv byte for byte. Returns K1's and the
    subspace kernel's launches in the two runs of this process (the
    sequential pass: one window a launch, its loop in the WHILE node)."""
    from ceres_slam_tpu_torch.utils import checkpoint

    base = os.path.join(data, "triangle200")
    path = os.path.join(data, "ckpt", "triangle200")
    argv = [base + ".csv", base + "_sun_ref.csv", base + "_sun_dir_gtsun10.csv", "--window", "2",
            "--dtype", "float64", "--device", "cuda", "--sun-only"]
    stats, launches, _, _ = _run_cli(data, "triangle200", "float64", "cuda", window_kernel,
                                     ("--sun-only",))
    out = stats["passes"]["sun"]["output"]
    first = open(out, "rb").read()
    os.unlink(out)
    cmd = [sys.executable, "-m", "ceres_slam_tpu_torch.apps.dataset_vo_sun", *argv,
           "--checkpoint", path, "--checkpoint-every", "25"]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    step = None
    try:
        while child.poll() is None and time.perf_counter() - t0 < 300:
            restored = checkpoint.load(path + ".sun")
            if restored is not None and restored[0] >= 100:
                step = restored[0]
                break
            time.sleep(0.05)
    finally:
        child.kill()
        child.wait()
    if step is None:
        fail(f"checkpoint resume: the child exited ({child.returncode}) or timed out before its "
             "checkpoint held window 100")
    from ceres_slam_tpu_torch.apps import dataset_vo_sun

    _reset_k1(window_kernel)
    resumed = dataset_vo_sun.main(argv + ["--checkpoint", path, "--checkpoint-every", "25"])
    counts = _k1_launches(window_kernel)
    k1 = counts["total"]
    windows = resumed["passes"]["sun"]["windows"]
    same = open(out, "rb").read() == first
    log(f"[slice] checkpoint resume (triangle200 float64 sun pass): killed at checkpoint "
        f"{step} after {time.perf_counter() - t0:.2f} s, resumed {windows} windows (K1 "
        f"launches {k1}) in {resumed['passes']['sun']['wall_s']:.2f} s; "
        f"{'byte-identical' if same else 'DIFFERENT'} {os.path.basename(out)}")
    if not same or not 0 < windows <= 199 - step or not k1 or os.path.exists(path + ".sun"):
        fail("the resumed pass differs from the uninterrupted one, or did not resume")
    return {"K1": launches["total"] + k1, "S": launches["S"] + counts["S"]}


def phase_slice(kernels, data, smi):
    _make_sims(data)
    window_launches, window_poses = _slice_window(data, kernels, smi)
    for name, n in _checkpoint_resume(data, kernels["K1"]).items():
        window_launches[name] += n
    full_launches, (full_poses, _), cli_costs = _slice_full(data, kernels)
    for seq, dtype, precond in LOOP_TURNS:
        ref = cli_costs[(seq, "float64" if precond == "banded" else dtype)]
        for name, n in _loop_turns(data, kernels, seq, dtype, precond, ref).items():
            full_launches[name] += n
    return {**window_launches, **full_launches}, window_poses, full_poses


def _grid_dir(data):
    """triangle200, square200 and penta200 with the four sun-noise files, in
    the grid's own directory (once per run of the script)."""
    from ceres_slam_tpu_torch.apps import make_sim

    grid = os.path.join(data, "grid")
    if not os.path.exists(os.path.join(grid, "penta200.csv")):
        t0 = time.perf_counter()
        for seq in ("triangle", "square", "penta"):
            make_sim.main([grid, "--kind", seq, "--num-states", "200", "--sun-noise", "0", "10",
                           "20", "30"])
        log(f"[batch] sims (triangle200, square200, penta200, 4 sun files each): "
            f"{time.perf_counter() - t0:.2f} s")
    return grid


def phase_batch(kernels, data, smi):
    """The 15-chain grid through dataset_vo_sun_batch --sims on the card;
    returns K1's launches."""
    import numpy as np

    import torch

    from ceres_slam_tpu_torch.apps import dataset_vo_sun_batch
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
    from ceres_slam_tpu_torch.solver.lm import SolveConfig
    from ceres_slam_tpu_torch.utils import csvio, metrics

    grid = _grid_dir(data)
    wk = kernels["K1"]
    argv = ["--sims", grid, "--dtype", "float64", "--device", "cuda"]
    _reset_k1(wk)
    stats = dataset_vo_sun_batch.main(argv)
    torch.cuda.synchronize()
    launches, graph = _k1_launches(wk), _graph_str()
    files = {r["output"]: open(r["output"], "rb").read() for r in stats["runs"]}
    # the same grid with the loop on the host, then on the card again, in turns
    walls = [stats["wall_s"]]
    for loop in ("host", "device"):
        again = dataset_vo_sun_batch.main(argv + ["--tr-loop", loop])
        walls.append(again["wall_s"])
        same = all(open(r["output"], "rb").read() == files[r["output"]] for r in again["runs"])
        if not same or [r["iterations_by_window"] for r in again["runs"]] != [
                r["iterations_by_window"] for r in stats["runs"]]:
            fail(f"grid --tr-loop {loop}: other poses or iterations than the first device run")
    log(f"[batch] grid ({smi}), trust-region loop device / host / device in turns: "
        f"{walls[0]:.2f} / {walls[1]:.2f} / {walls[2]:.2f} s, byte-identical poses files and "
        f"the same iterations in every window; device: {graph}")
    runs = stats["runs"]
    steps = max(len(r["iterations_by_window"]) for r in runs)
    # a step's loops run until its slowest chain stops: one K1 launch each
    # iteration, and one for the initial cost
    iterations = sum(max(r["iterations_by_window"][w] for r in runs if w < len(r["iterations_by_window"]))
                     for w in range(steps))
    log(f"[batch] grid of {len(runs)} chains ({smi}): {stats['windows']} windows in "
        f"{stats['wall_s']:.2f} s ({stats['windows_per_s']:.1f} windows/s aggregate; set-up "
        f"{stats['setup_s']:.2f} s); K1 launches {launches['total']} (batched "
        f"{launches['batch']}), {launches['windows']} windows served, "
        f"{launches['windows'] / max(launches['total'], 1):.2f} windows per launch; "
        f"{steps} steps, {iterations} batched trust-region iterations, "
        f"{sum(r['iterations'] for r in runs)} chain iterations")
    if (launches["single"] or launches["total"] < iterations or len(runs) != 15
            or launches["windows"] < stats["windows"]):
        fail(f"grid: {len(runs)} chains, K1 launches {launches} for {iterations} batched "
             "trust-region iterations")
    for r in runs:
        name = os.path.basename(r["output"])[:-len("_poses.csv")]
        seq, _, method = name.partition("_")
        method = method or "vo"
        gt = csvio.read_poses_csv(os.path.join(grid, f"{seq}_gt_poses.csv"))
        poses = csvio.read_poses_csv(r["output"])
        if poses.shape != gt.shape or not np.all(np.isfinite(poses)):
            fail(f"grid {name}: poses not finite or of shape {gt.shape}")
        ate, ref = metrics.ate_translation(poses, gt), JAX_GRID_ATE[seq][method]
        dev = abs(ate - ref) / ref
        log(f"[batch]   {seq} {method}: ATE {ate:.4f} m (JAX {ref:.4f}, {100 * dev:.2f}% off, "
            f"bound {100 * GRID_ATE_BOUND:.0f}%), {r['windows']} windows, {r['iterations']} "
            "iterations")
        if dev > GRID_ATE_BOUND:
            fail(f"grid {name}: ATE {ate:.4f} vs JAX {ref:.4f}")
    # two chains again, each alone through the sequential pass
    base = os.path.join(grid, "triangle200")
    config = SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    for method, use_sun in (("vo", False), ("gtsun10", True)):
        ds = DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                        base + "_sun_dir_gtsun10.csv")
        ds.device = "cuda"
        ds.precompute_pair_alignments()
        t0 = time.perf_counter()
        summaries = ds.solve_sliding_window(window=2, use_sun=use_sun, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = base + ("_poses.csv" if method == "vo" else f"_{method}_poses.csv")
        d = float(np.max(np.abs(csvio.read_poses_csv(out) - ds.poses)))
        log(f"[batch] triangle200 {method} alone (solve_sliding_window): {len(summaries)} windows "
            f"in {wall:.2f} s ({len(summaries) / wall:.1f} windows/s); max |pose(grid) - "
            f"pose(alone)| = {d:.3e} (bound {GRID_SEQ_ATOL:g})")
        if not d <= GRID_SEQ_ATOL:
            fail(f"grid triangle200 {method}: the batched chain differs from its pass alone by "
                 f"{d:.3e}")
    return {"K1": launches["total"], "S": launches["S"]}


def _window_node_us(torch, layout, state, strategy):
    """Device us per trust-region iteration inside the WHILE node: CUDA
    events around the loop's launch (restarted before each, outside the
    events) for 21 and 1 iterations (run_full_budget), the difference over
    20; median of 10 each. torch.profiler sees only the node's first pass."""
    from ceres_slam_tpu_torch.solver import window
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    ms = {}
    for n in (1, 21):
        graph = window.WindowGraph()
        window.run_loop(layout, state, SolveConfig(max_iters=n, run_full_budget=True), strategy,
                        loop="device", graph=graph)
        _, _, node, restart = next(iter(graph.loops.values()))
        times = []
        for _ in range(11):
            restart.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            node.launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        graph.close()
        ms[n] = statistics.median(times[1:])
    return (ms[21] - ms[1]) / 20 * 1e3


def _profile_window_step(torch, label, runs, smi, k1=20):
    """One lockstep step (window ``k1`` of every chain, float64 dogleg,
    after ``k1`` steps untraced) under the profiler, with the trust-region
    loop on the host and in the WHILE node: wall, launches, syncs and
    copies a step and an iteration, the device busy share; and the node's
    device us per iteration (CUDA events) at the step's next window."""
    from ceres_slam_tpu_torch.problems import batch_scan
    from ceres_slam_tpu_torch.solver import window
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    cfg = SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    for loop in ("host", "device"):
        solver = batch_scan.BatchSolve(runs, 2, cfg, loop=loop)
        for k in range(k1):
            solver.step(k)
        torch.cuda.synchronize()
        t = _trace(torch, lambda: solver.step(k1))
        done = [c for c in solver.chains if len(c.ok) == k1 + 1 and c.ok[-1]]
        its = max(c.summaries[-1].iterations for c in done)
        busy, note = t["device_us"], ""
        if loop == "device":
            k = k1 + 1
            solve = [c for c in solver.chains if c.ds.compute_initial_guess(k, k + 2)]
            hosts = solver._hosts(solve, k)
            layout, state = window.build_batch_layout(
                [h for h, _ in hosts], solver._per_window(solve, [x for _, x in hosts], k),
                solver.dtype, solver.device)
            us = {st: _window_node_us(torch, layout, state, st) for st in ("dogleg", "lm")}
            busy += (its - 1) * us["dogleg"]  # the profiler sees the node's first pass only
            note = (f"; in the node {us['dogleg']:.1f} us of device time a dogleg iteration "
                    f"({us['lm']:.1f} LM), CUDA events; device busy counts the node's "
                    "iterations at that rate")
        solver.close()
        per_it = "" if loop == "device" else (
            f"; per iteration {t['launches'] / (its + 1):.1f} launches, "
            f"{t['syncs'] / (its + 1):.2f} syncs, {t['copies'] / (its + 1):.2f} copies")
        log(f"[profile] {label} step (window {k1} of {len(done)} chains, float64 dogleg, {its} "
            f"trust-region iterations), loop {loop} ({smi}): wall {t['wall_us'] / 1e3:.2f} ms "
            f"(profiled), device busy {busy / 1e3:.3f} ms ({100 * busy / t['wall_us']:.2f}%), "
            f"{t['launches']:g} launches, {t['graph_launches']:g} graph launches, "
            f"{t['syncs']:g} syncs, {t['copies']:g} copies a step{per_it}{note}")


def _profile_grid_step(torch, data, smi):
    from ceres_slam_tpu_torch.apps import dataset_vo_sun_batch

    runs, _ = dataset_vo_sun_batch.load_runs(
        dataset_vo_sun_batch.grid_runs(os.path.join(data, "grid")), "float64", "cuda")
    _profile_window_step(torch, "grid", runs, smi)


def _profile_flagship_step(torch, data, smi):
    """kitti1100's two flagship passes (one batch of two, as the CLI runs
    them) at window 20."""
    from ceres_slam_tpu_torch.problems import batch_scan
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun

    base = os.path.join(data, "kitti1100")
    ds = DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                    base + "_sun_dir_gtsun10.csv")
    ds.device = "cuda"
    runs = [batch_scan.RunSpec(ds), batch_scan.RunSpec(ds, use_sun=True)]
    _profile_window_step(torch, "kitti1100 flagship", runs, smi)


def _graph_dataset(data, seq, device):
    """The sim's dataset after the VO initial guess (the graph's inputs)."""
    from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun

    base = os.path.join(data, seq)
    ds = DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                    base + "_sun_dir_gtsun10.csv")
    ds.device = device
    ds.compute_initial_guess()
    return ds


def _graph_solve(ds, linear_solver, strategy, device, kernels, lm_loop=None):
    """One FactorGraph solve with the full-batch kernels' launches counted
    from 0 (and the LM loop captures it made)."""
    import torch

    from ceres_slam_tpu_torch.solver import lm

    g = ds.factor_graph(device)
    _fb_zero(kernels)
    captures = lm.GRAPH_STATS["captures"]
    t0 = time.perf_counter()
    _, summ = g.solve(linear_solver=linear_solver, strategy=strategy, lm_loop=lm_loop)
    if device == "cuda":
        torch.cuda.synchronize()
    return g, summ, time.perf_counter() - t0, {**_fb_launches(kernels),
                                               "captures": lm.GRAPH_STATS["captures"] - captures}


def _graph_turns(ds, linear_solver, strategy, kernels, first, wall, smi):
    """A triangle200 FactorGraph solve (dense or schur LM, or the dense
    dogleg) whose default run (``first``, the loop in its WHILE node) is
    followed by the host loop and the node again: the same iterations,
    summary, poses and points bit for bit, one capture a node run; the
    walls of both forms."""
    import numpy as np

    g0, summ0 = first
    walls = {"device": [wall], "host": []}
    for loop in ("host", "device"):
        g, summ, w, launches = _graph_solve(ds, linear_solver, strategy, "cuda", kernels, loop)
        walls[loop].append(w)
        same = (summ == summ0 and np.array_equal(np.stack(g._poses), np.stack(g0._poses))
                and np.array_equal(np.stack(g._points), np.stack(g0._points)))
        if not same or launches["captures"] != (loop == "device"):
            fail(f"triangle200 FactorGraph({linear_solver}, {strategy}) with lm_loop={loop}: not "
                 f"the default run's bits ({summ.iterations} vs {summ0.iterations} iterations) or "
                 f"{launches['captures']} captures")
    log(f"[graph] triangle200 {linear_solver} {strategy}, the loop device / host / device in turns "
        f"({smi}): the same {summ0.iterations} iterations and bits; solve walls " + "; ".join(
            f"{k} " + ", ".join(f"{x:.3f}" for x in v) + " s" for k, v in walls.items()))


GRAPH_DENSE_TURNS = ("device", "host", "device")


def _dense_window_pass(data, smi):
    """dataset_vo --window 2 --linear-solver dense on triangle200 with the
    LM loop in its WHILE node and on the host in turns: byte-identical
    CSVs and the same LM iterations; in the node one capture for the pass
    and a restart for every later window."""
    from ceres_slam_tpu_torch.apps import dataset_vo
    from ceres_slam_tpu_torch.utils import csvio, metrics

    gt = csvio.read_poses_csv(os.path.join(data, "triangle200_gt_poses.csv"))
    runs = []
    for i, loop in enumerate(GRAPH_DENSE_TURNS):
        path = os.path.join(data, f"dense_window_{i}", "triangle200_vo.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copy(os.path.join(data, "triangle200_vo.csv"), path)
        with open(path[:-4] + "_stdout.txt", "w") as out, contextlib.redirect_stdout(out):
            st = dataset_vo.main([path, "--window", "2", "--linear-solver", "dense",
                                  "--lm-loop", loop])  # its 199 window lines go to the file
        ate = metrics.ate_translation(csvio.read_poses_csv(st["poses"]), gt)
        log(f"[graph] triangle200 dataset_vo --window 2 --linear-solver dense --lm-loop {loop} "
            f"({smi}): {st['windows']} windows, {st['lm_iterations']} LM iterations, solve "
            f"{st['solve_s']:.3f} s ({st['lm_iterations'] / st['solve_s']:.1f} LM it/s), load "
            f"{st['load_s']:.2f} s, RANSAC {st['ransac_s']:.2f} s; LM loop captures "
            f"{st['lm_graph_captures']}, restarts {st['lm_graph_restarts']}; ATE {ate:.4f} m")
        want = (1, st["windows"] - 1) if loop == "device" else (0, 0)
        if (st["lm_graph_captures"], st["lm_graph_restarts"]) != want:
            fail(f"dense window pass, --lm-loop {loop}: {st['lm_graph_captures']} captures and "
                 f"{st['lm_graph_restarts']} restarts, not {want}")
        out = tuple(open(st[k], "rb").read() for k in ("poses", "map"))
        runs.append((loop, out, st["lm_iterations"]))
    for loop, out, its in runs[1:]:
        if out != runs[0][1] or its != runs[0][2]:
            fail(f"dense window pass: --lm-loop {loop} wrote other bytes or ran {its} LM "
                 f"iterations ({runs[0][0]}: {runs[0][2]})")


def phase_graph(kernels, data, smi):
    """FactorGraph on the card (dense and schur with the LM loop in its node
    and on the host in turns), then the dense LM loop of dataset_vo's
    window pass in both forms; returns the full-batch kernels' launches,
    and the triangle200 pcg solve's poses."""
    import numpy as np

    _make_sims(data)
    total, keep = dict.fromkeys(("K2", "K3", "SP", "CG"), 0), None
    for seq in JAX_GRAPH:
        t0 = time.perf_counter()
        ds = _graph_dataset(data, seq, "cuda")
        log(f"[graph] {seq}: VO initial guess {time.perf_counter() - t0:.2f} s")
        costs = []
        for (linear_solver, strategy), (ref_it, ref_cost) in JAX_GRAPH[seq].items():
            g, summ, wall, launches = _graph_solve(ds, linear_solver, strategy, "cuda", kernels)
            if seq == "triangle200" and linear_solver in ("dense", "schur"):
                if launches["captures"] != 1:
                    fail(f"FactorGraph({linear_solver}, {strategy}) at its default: "
                         f"{launches['captures']} loop captures, not 1 (the WHILE node)")
                _graph_turns(ds, linear_solver, strategy, kernels, (g, summ), wall, smi)
            if strategy == "dogleg" and summ.iterations != ref_it:
                fail(f"{seq} dense dogleg: {summ.iterations} iterations, JAX {ref_it}")
            for name in total:
                total[name] += launches[name]
            dev = abs(summ.final_cost - ref_cost) / ref_cost
            costs.append(summ.final_cost)
            log(f"[graph] {seq} {linear_solver} {strategy}: {len(g._stereo)} factors, "
                f"{summ.iterations} iterations (JAX {ref_it}), {summ.linear_iterations} CG "
                f"iterations, cost {summ.initial_cost:.9e} -> {summ.final_cost:.9e} (JAX "
                f"{ref_cost:.9e}, {dev:.2e} relative, bound {GRAPH_RTOL[seq]:g}), solve "
                f"{wall:.3f} s; launches K2 {launches['K2']}, K3 {launches['K3']}")
            poses = np.stack(g._poses)
            if not np.all(np.isfinite(poses)) or dev > GRAPH_RTOL[seq]:
                fail(f"{seq} {linear_solver} {strategy}: cost {summ.final_cost:.9e} vs JAX "
                     f"{ref_cost:.9e}")
            if linear_solver == "pcg":
                if not (launches["K2"] >= summ.iterations > 0
                        and launches["K3"] >= summ.linear_iterations > 0):
                    fail(f"{seq} FactorGraph(pcg): {launches} launches for {summ.iterations} LM "
                         f"and {summ.linear_iterations} CG iterations")
                if seq == "triangle200":
                    keep = poses
            if (seq, linear_solver, strategy) == ("triangle200", "dense", "lm"):
                cov = g.covariance(1)
                cpu, _, cpu_wall, _ = _graph_solve(_graph_dataset(data, seq, "cpu"), "dense", "lm",
                                                   "cpu", kernels)
                ref = cpu.covariance(1)
                d = float(np.abs(cov - ref).max() / np.abs(ref).max())
                log(f"[graph] triangle200 covariance(1): {d:.2e} relative from the CPU's "
                    f"(bound {GRAPH_COV_RTOL:g}; the CPU solve {cpu_wall:.2f} s)")
                if not d <= GRAPH_COV_RTOL:
                    fail(f"triangle200 covariance(1) differs from the CPU's by {d:.2e}")
        spread = (max(costs) - min(costs)) / min(costs)
        if spread > GRAPH_RTOL[seq]:
            fail(f"{seq}: the solvers' final costs spread {spread:.2e}")
    _dense_window_pass(data, smi)
    return total, keep


BLOWUP_TURNS = ("device", "host", "device")


def phase_blowup(smi):
    """apps/blowup.py at the reference's 1,000 poses on the card, the chain
    in its WHILE node and on the host in turns: bit-identical covariances
    and LM iterations, each run's deviation from the closed form against
    the JAX figure."""
    import numpy as np
    import torch

    from ceres_slam_tpu_torch.apps import blowup

    runs = []
    for loop in BLOWUP_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        covs, manuals, iters, st = blowup.run_chain(1000, device="cuda", chain_loop=loop)
        wall = time.perf_counter() - t0
        rel_err = np.abs(covs - manuals).max(axis=(1, 2)) / np.abs(manuals).max(axis=(1, 2))
        dev = float(rel_err.max())
        node = ("" if st["node_ms"] is None else
                f"; the node {st['node_ms']:.3f} ms of device time by CUDA events for "
                f"{st['steps'] - 1} steps ({st['node_ms'] * 1e3 / (st['steps'] - 1):.1f} us a "
                f"step), {100 * st['node_ms'] / (wall * 1e3):.2f}% of the wall; capture and build "
                f"{st['capture_s']:.3f} s")
        log(f"[blowup] 1000 poses, chain loop {loop} on {smi}: max relative deviation from the "
            f"closed form {dev:.3e} (JAX {JAX_BLOWUP_DEV:.3e}, bound +-{BLOWUP_ATOL:g}); "
            f"{st['steps']} solves, {st['lm_iterations']} LM iterations in {wall:.3f} s = "
            f"{st['steps'] / wall:.1f} solves/s; captures {st['captures']}{node}; trace of the "
            f"last covariance {np.trace(covs[-1]):.6e}")
        if not (np.all(np.isfinite(covs)) and abs(dev - JAX_BLOWUP_DEV) <= BLOWUP_ATOL):
            fail(f"blowup ({loop}): max relative deviation {dev:.3e} vs JAX {JAX_BLOWUP_DEV:.3e}")
        if st["steps"] != 999 or st["captures"] != (loop == "device"):
            fail(f"blowup ({loop}): {st['steps']} steps, {st['captures']} captures")
        runs.append((loop, covs, iters))
    for loop, covs, iters in runs[1:]:
        if not (np.array_equal(covs, runs[0][1]) and np.array_equal(iters, runs[0][2])):
            fail(f"blowup: the chain loop {loop} differs from {runs[0][0]} (covariances or LM "
                 "iterations)")


LIVE_VO_FORMS = ("device", "host", "device")  # --frame-loop, in turns


def _live_vo_per_frame(files, cam, form, frames=5):
    """Host work per tracked frame of ``OnlineStereoVO`` in ``form`` on the
    saved frames (numpy: each pair one host-to-device copy through the
    staging buffer): launches, graph launches, syncs and copies of
    ``frames`` frames under the profiler, after three frames (the first, and
    the device form's capture)."""
    import numpy as np
    import torch

    from ceres_slam_tpu_torch.frontend.stereo_vo import OnlineStereoVO
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera

    pairs = [(np.load(left), np.load(right)) for left, right in files[:3 + frames]]
    vo = OnlineStereoVO(StereoCamera.create(*cam), device="cuda", frame_loop=form)
    for left, right in pairs[:3]:
        vo.process(left, right)

    def run():
        for left, right in pairs[3:]:
            vo.process(left, right)

    t = _trace(torch, run)
    vo.close()
    return {k: t[k] / frames for k in ("launches", "graph_launches", "syncs", "copies",
                                       "wall_us")}


def phase_live_vo(data, smi):
    """100 rendered frames through the stereo_vo CLI's glob mode on the
    card, each tracked frame as its captured graphs and launch by launch in
    turns (the same pose bytes), with the host work per frame of each form;
    then 10 frames at KITTI's full size, counts only."""
    import glob

    import numpy as np

    from ceres_slam_tpu_torch.apps import stereo_vo
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.utils import csvio, metrics

    for shape, cam, n in ((LIVE_VO_SHAPE, LIVE_VO_CAMERA, 100), ((375, 1242), KITTI_CAMERA, 10)):
        t0 = time.perf_counter()
        frames, gt = stereo_vo._render_synthetic(StereoCamera.create(*cam), n, shape=shape,
                                                 device="cuda")
        d = os.path.join(data, f"live_vo_{shape[0]}x{shape[1]}")
        os.makedirs(d)
        for i, (left, right) in enumerate(frames):
            np.save(os.path.join(d, f"{i:03d}_left.npy"), left.cpu().numpy())
            np.save(os.path.join(d, f"{i:03d}_right.npy"), right.cpu().numpy())
        render_s = time.perf_counter() - t0
        intrinsics = [f"--{k}={v!r}" for k, v in zip(("fu", "fv", "cu", "cv", "baseline"), cam)]
        forms = LIVE_VO_FORMS if shape == LIVE_VO_SHAPE else LIVE_VO_FORMS[:1]
        written = []
        for turn, form in enumerate(forms):
            stats = stereo_vo.main(["--left-glob", os.path.join(d, "*_left.npy"), "--right-glob",
                                    os.path.join(d, "*_right.npy"), "--out",
                                    os.path.join(d, f"vo{turn}_{form}"), *intrinsics,
                                    "--device", "cuda", "--frame-loop", form])
            with open(stats["poses"], "rb") as f:
                written.append(f.read())
            poses = csvio.read_poses_csv(stats["poses"])
            ate = metrics.ate_translation(poses, gt)
            log(f"[live_vo] {shape[0]}x{shape[1]} --frame-loop {form} on {smi}: "
                f"{stats['frames']} frames in {stats['wall_s']:.3f} s = "
                f"{stats['frames_per_s']:.2f} frames/s (files read included; render and write "
                f"{render_s:.2f} s); {stats['captures']} capture(s), capture "
                f"{stats['capture_s']:.3f} s, instantiation {stats['instantiate_s']:.3f} s; "
                f"median per frame: {stats['median_corners']:g} valid corners, "
                f"{stats['median_stereo_matches']:g} stereo matches, "
                f"{stats['median_temporal_matches']:g} temporal matches; ATE {ate:.6f} m")
        if any(w != written[0] for w in written[1:]):
            fail(f"live VO {shape[0]}x{shape[1]}: the frame loop's forms wrote other poses")
        if shape != LIVE_VO_SHAPE:
            continue
        log(f"[live_vo] the {len(forms)} runs' _poses.csv are byte-identical")
        files = list(zip(sorted(glob.glob(os.path.join(d, "*_left.npy"))),
                         sorted(glob.glob(os.path.join(d, "*_right.npy")))))
        for form in ("device", "host"):
            per = _live_vo_per_frame(files, cam, form)
            log(f"[live_vo] {shape[0]}x{shape[1]} --frame-loop {form}, per tracked frame "
                f"(profiled, 5 frames): {per['launches']:g} launches, {per['graph_launches']:g} "
                f"graph launches, {per['syncs']:g} syncs, {per['copies']:g} copies, wall "
                f"{per['wall_us']:.1f} us")
        dev = abs(ate - JAX_LIVE_VO_ATE) / JAX_LIVE_VO_ATE
        log(f"[live_vo] ATE {ate:.6f} m against JAX's {JAX_LIVE_VO_ATE:.6f} m: {100 * dev:.3f}% "
            f"off (bound {100 * LIVE_VO_RTOL:g}%)")
        if poses.shape != (n, 12) or not np.all(np.isfinite(poses)) or dev > LIVE_VO_RTOL:
            fail(f"live VO: ATE {ate:.6f} vs JAX {JAX_LIVE_VO_ATE:.6f}")


def _make_phong_sims(data):
    from ceres_slam_tpu_torch.apps import make_sim

    t0 = time.perf_counter()
    make_sim.main([data, "--kind", "phong", "--num-states", "200", "--num-points", "1000"])
    make_sim.main([os.path.join(data, "dir"), "--kind", "phong", "--num-states", "60",
                   "--num-points", "300", "--directional"])
    make_sim.main([os.path.join(data, "win"), "--kind", "phong", "--num-states", "30",
                   "--num-points", "200"])
    shutil.copy(os.path.join(data, "phong200.csv"), os.path.join(data, "phong200_f32.csv"))
    log(f"[phong] sims (phong200, phong60 directional, phong30): {time.perf_counter() - t0:.2f} s")


PHONG_RUNS = (("phong200 float64", "phong200.csv", ["--multistage"], "float64"),
              ("phong200 float32", "phong200_f32.csv", ["--multistage"], "float32"),
              ("phong60 dirlight", "dir/phong60.csv", ["--dirlight"], "float64"),
              ("phong30 window5", "win/phong30.csv", ["--window", "5"], "float64"))


def phase_phong(data, smi):
    """dataset_ba_phong on the card, every case with each stage's LM loop in
    its WHILE node and on the host, in turns (device, host, device; the
    next case host, device, host): the same LM iterations per stage and
    byte-identical _poses.csv, _map.csv and _lights.csv in every run; one
    capture a stage, restarted for every later window, in each run of the
    node's form; each stage's final cost and the ATE against the JAX
    figures; LM iterations per second of every run."""
    from ceres_slam_tpu_torch.apps import dataset_ba_phong

    _make_phong_sims(data)
    for i, (label, name, argv, dtype) in enumerate(PHONG_RUNS):
        path = os.path.join(data, name)
        keys = 3 if "--multistage" in argv else 1  # stages a window, each its own capture
        first = None
        for loop in ("device", "host", "device") if i % 2 == 0 else ("host", "device", "host"):
            stats = dataset_ba_phong.main([path, *argv, "--dtype", dtype, "--device", "cuda",
                                           "--lm-loop", loop])
            _check_phong(label, path, stats, loop, smi)
            run = ([st["iterations"] for st in stats["stages"]],
                   [open(stats[k], "rb").read() for k in ("poses", "map", "lights")])
            first = first or run
            if run[0] != first[0]:
                fail(f"{label}: LM iterations per stage {run[0]} with the LM loop {loop}, "
                     f"{first[0]} in the first run")
            for k, a, b in zip(("poses", "map", "lights"), run[1], first[1]):
                if a != b:
                    fail(f"{label}: the LM loop {loop} wrote other {k} bytes than the first run")
            got = (stats["lm_graph_captures"], stats["lm_graph_restarts"])
            want = (keys, len(stats["stages"]) - keys) if loop == "device" else (0, 0)
            if got != want:
                fail(f"{label}: LM loop {loop}: captures and restarts {got}, not {want}")
        log(f"[phong] {label}: the node and the host loop agree in turns: {sum(first[0])} LM "
            f"iterations, byte-identical poses, map and lights; {keys} capture(s) and "
            f"{len(first[0]) - keys} restarts a node run (a capture a stage, restarted for "
            "every later window)")


def _check_phong(label, path, stats, loop, smi):
    """One dataset_ba_phong run's outputs: the files written, finite poses,
    each stage's final cost and the ATE within PHONG_BOUNDS of JAX_PHONG;
    logs the LM iterations per second."""
    import numpy as np

    from ceres_slam_tpu_torch.utils import csvio, metrics

    for out in (stats["poses"], stats["map"], stats["lights"]):
        if not os.path.exists(out):
            fail(f"{label}: {out} was not written")
    poses = csvio.read_poses_csv(stats["poses"])
    gt = csvio.read_poses_csv(path.replace("_f32", "").rsplit(".", 1)[0] + "_gt_poses.csv")
    if poses.shape != gt.shape or not np.all(np.isfinite(poses)):
        fail(f"{label}: poses not finite or of shape {gt.shape}")
    ate = metrics.ate_translation(poses, gt)
    ref_costs, ref_ate = JAX_PHONG[label]
    rtol, ate_atol = PHONG_BOUNDS[label]
    stages = stats["stages"]
    if label == "phong30 window5":
        if len(stages) != PHONG_WINDOWS:
            fail(f"{label}: {len(stages)} window solves, not {PHONG_WINDOWS}")
        stages = stages[-1:]
    costs = [st["final_cost"] for st in stages]
    devs = [abs(c - r) / r for c, r in zip(costs, ref_costs)]
    log(f"[phong] {label}, LM loop {loop}: {stats['observations']} observations, stages "
        f"(iterations, final cost, JAX's) " + ", ".join(
            f"({st['iterations']}, {c:.9e}, {r:.9e}, {d:.2e} off)"
            for st, c, r, d in zip(stages, costs, ref_costs, devs))
        + f"; ATE {ate:.6f} m (JAX {ref_ate:.6f}); bounds rtol {rtol:g}, ATE +-{ate_atol:g} m")
    log(f"[phong] {label}, LM loop {loop}, on {smi}: {stats['lm_iterations']} LM iterations in "
        f"{stats['solve_s']:.3f} s of solve = {stats['it_s']:.2f} LM iterations/s; load "
        f"{stats['load_s']:.2f} s, initial guess {stats['init_s']:.2f} s, total "
        f"{stats['total_s']:.2f} s")
    if len(costs) != len(ref_costs) or max(devs) > rtol or abs(ate - ref_ate) > ate_atol:
        fail(f"{label}: costs {costs} / ATE {ate:.6f} outside the bounds of JAX's "
             f"{ref_costs} / {ref_ate:.6f}")


DENSE_FORMS = (("device", "device"), ("host", "host"))  # (--lm-loop, --match-loop)


def _run_dense(label, argv, device, k4, loops=None):
    """One dense_stereo CLI run with K4's launches counted from 0; on the
    card ``loops`` is (``--lm-loop``, ``--match-loop``). K4 must launch
    twice an LM iteration and once for the start in either form, in every
    pair of a ``--pairs`` run."""
    from ceres_slam_tpu_torch.apps import dense_stereo

    extra = ["--lm-loop", loops[0], "--match-loop", loops[1]] if loops else []
    k4.launches = 0
    stats = dense_stereo.main([*argv, *extra, "--device", device])
    stats["launches"] = k4.launches
    pairs = [stats, *stats.get("later_pairs", [])]
    if not all(math.isfinite(x) and st["final_cost"] < st["initial_cost"]
               for st in pairs for x in st["T"]):
        fail(f"dense_stereo {argv} on {device}: pose not finite or cost not decreased")
    want = sum(2 * st["iterations"] + 1 for st in pairs)
    if device == "cuda" and stats["launches"] != want:
        fail(f"dense_stereo {argv} {extra}: {stats['launches']} K4 launches for "
             f"{[st['iterations'] for st in pairs]} LM iterations (not 2 an iteration plus 1 "
             "a pair)")
    form = f" --lm-loop {loops[0]} --match-loop {loops[1]}" if loops else ""
    log(f"[dense] {label} {device}{form}: "
        f"{stats['size'][0]}x{stats['size'][1]}, {stats['pixels_valid']} / {stats['pixels_total']} "
        f"pixels, cost {stats['initial_cost']:.6e} -> {stats['final_cost']:.6e} in "
        f"{stats['iterations']} LM iterations, K4 launches {stats['launches']}; LM loop captures "
        f"{stats['lm_graph_captures']}, matcher captures {stats['match_graph_captures']}; matcher "
        f"{stats['matcher_s']:.3f} s, alignment {stats['align_s']:.3f} s, total {stats['total_s']:.3f} s")
    return stats


def _dense_forms(label, argv, k4, matched):
    """The run in both forms (``DENSE_FORMS``): the node and the captured
    matcher, then both on the host. They must give the same iterations,
    costs, pose and valid pixels bit for bit in every pair, and in the
    device form the first pair captures once each (the matcher only where
    the run matches: ``matched``) and every later pair of a ``--pairs`` run
    restarts the node and replays the matcher. Returns the device form's
    stats, with both forms' K4 launches summed."""
    runs = [_run_dense(label, argv, "cuda", k4, loops) for loops in DENSE_FORMS]
    keys = ("iterations", "initial_cost", "final_cost", "T", "pixels_valid",
            "matcher_median_derr")
    forms = [[st, *st.get("later_pairs", [])] for st in runs]
    for loops, pairs in zip(DENSE_FORMS, forms):
        for i, (st, ref) in enumerate(zip(pairs, forms[0])):
            want = ((1, 0, int(matched)) if i == 0 else (0, 1, 0)) if loops[0] == "device" else (
                0, 0, 0)
            got = (st["lm_graph_captures"], st["lm_graph_restarts"], st["match_graph_captures"])
            if got != want:
                fail(f"{label} with {loops}, pair {i}: (LM loop captures, restarts, matcher "
                     f"captures) {got}, not {want}")
            if any(st.get(k) != ref.get(k) for k in keys):
                fail(f"{label}, pair {i}: --lm-loop/--match-loop {loops} gave other bits than "
                     f"{DENSE_FORMS[0]}: " + ", ".join(f"{k} {st.get(k)} vs {ref.get(k)}"
                                                      for k in keys if st.get(k) != ref.get(k)))
    first = runs[0]

    def walls(pairs):
        return " / ".join(f"{st['matcher_s']:.3f} + {st['align_s']:.3f}" for st in pairs)

    log(f"[dense] {label}: the node and the captured matcher give the host forms' bits in "
        f"{len(forms[0])} pair(s) ({first['iterations']} LM iterations, cost "
        f"{first['final_cost']!r} in pair 0); CLI walls, matcher + alignment s a pair (the "
        f"device form's first pair includes its captures): device {walls(forms[0])}; host "
        f"{walls(forms[1])}")
    return {**first, "launches": sum(st["launches"] for st in runs)}


def _matcher_times(smi):
    """The matcher at 240x320 (float32, max_disp 48, 4 directions) as one
    captured graph and launch by launch: the capture's and the
    instantiation's host seconds, then 5 rounds over two pairs (the
    rendered one and the same with noise), each pair replayed and run
    eagerly in turns (host wall to a synchronize, median and range), every
    replay bit-equal to the eager run of its pair."""
    import numpy as np
    import torch

    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.frontend import dense_stereo as front

    out = dense_stereo.make_scene(240, 320, stereo=True, device="cuda")
    rng = np.random.default_rng(0)
    pair = (out[1].float(), out[7].float())
    pairs = [pair, tuple(x + torch.as_tensor(rng.normal(0, 0.02, x.shape), dtype=x.dtype,
                                             device="cuda") for x in pair)]
    graph, stats = front.MatcherGraph(), front.MATCH_STATS
    before = dict(stats)
    t0 = time.perf_counter()
    front.match_disparity(*pair, max_disp=48, loop="device", graph=graph)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    walls = {"device": [], "host": []}
    for _ in range(5):
        for left, right in pairs:
            res = {}
            for loop in ("device", "host"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[loop] = front.match_disparity(left, right, max_disp=48, loop=loop,
                                                  graph=graph if loop == "device" else None)
                torch.cuda.synchronize()
                walls[loop].append(time.perf_counter() - t0)
            if not all(torch.equal(a, b) for a, b in zip(res["device"], res["host"])):
                fail("the matcher's graph replay differs from its eager run")
    graph.close()
    if stats["captures"] - before["captures"] != 1:
        fail(f"the matcher captured {stats['captures'] - before['captures']} times, not once")
    log(f"[dense] matcher 240x320 float32, max_disp 48, 4 directions ({smi}): capture "
        f"{stats['capture_s'] - before['capture_s']:.3f} s, instantiation "
        f"{stats['instantiate_s'] - before['instantiate_s']:.3f} s, first call with its "
        f"warm-up and capture {first_s:.3f} s; wall per pair, two pairs in turns "
        "(median of 10, min-max): " + "; ".join(
            f"{k} {statistics.median(v) * 1e3:.2f} ms ({min(v) * 1e3:.2f}-{max(v) * 1e3:.2f})"
            for k, v in walls.items()) + "; every replay bit-equal to its pair's eager run")


def _photometric_rate(k4, smi):
    """scripts/bench_xl.py's photometric rate on the port: the 240x320
    --gt-disparity problem in float32, 20 LM iterations under
    run_full_budget (every iteration a full step and candidate cost), in
    both LM loop forms: the node through one LMGraph (captured by a warm-up
    solve, restarted after) and the host loop, 3 timed repetitions each in
    turns (device, host, host, device), the two forms' results bit-equal.
    For the node, its device time per LM iteration by CUDA events around
    the restarted node (the profiler sees a node's first pass only) and
    its share of the solve's wall. Returns K4's launches."""
    import torch

    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.solver import lm, photometric
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    problem, state0, _ = dense_stereo.synthetic_problem(240, 320, dtype=torch.float32,
                                                        device="cuda")
    cfg = SolveConfig(max_iters=20, ftol=0.0, gtol=0.0, run_full_budget=True)
    graph = lm.LMGraph()

    def solve(loop):
        return photometric.solve_photometric(problem, state0, cfg, lm_loop=loop,
                                             graph=graph if loop == "device" else None)

    k4.launches = 0
    warm = {}
    for loop in ("device", "host"):
        t0 = time.perf_counter()
        warm[loop] = solve(loop)
        torch.cuda.synchronize()
        warm[loop] += (time.perf_counter() - t0,)
    launches = k4.launches
    (sd, md, _), (sh, mh, _) = warm["device"], warm["host"]
    if not (md == mh and torch.equal(sd.T, sh.T) and torch.equal(sd.disparities, sh.disparities)):
        fail(f"photometric rate: the node and the host loop differ ({md} vs {mh})")
    if md.iterations != 20 or launches != 2 * 41:
        fail(f"photometric rate: {md.iterations} iterations, {launches} K4 launches in both "
             "forms (not 2 x 41)")
    walls = {"device": [], "host": []}
    for loop in ("device", "host", "host", "device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            _, summary = solve(loop)
        torch.cuda.synchronize()
        walls[loop].append(time.perf_counter() - t0)
    _, lp, node = next(iter(graph.loops.values()))
    times = []
    for _ in range(6):
        lp.restart()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        node.launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    node_ms = statistics.median(times[1:])
    graph.close()
    for loop, w in walls.items():
        solve_s = statistics.median(w) / 3
        rate = {"metric": "photometric_it_s", "lm_loop": loop, "pixels": problem.ref_uv.shape[0],
                "H": 240, "W": 320, "dtype": "float32", "it_s": 20 / solve_s,
                "solve_ms": solve_s * 1e3, "warmup_s": warm[loop][-1],
                "final_cost": summary.final_cost, "card": smi}
        if loop == "device":
            rate.update(node_us_per_iteration=node_ms * 1e3 / 20,
                        node_share_of_wall=node_ms / (solve_s * 1e3))
        log(f"[dense] {json.dumps(rate)}")
    log(f"[dense] photometric rate: K4 launches per solve {launches // 2} in either form; the "
        f"node {node_ms:.3f} ms for 20 LM iterations ({node_ms * 50:.1f} us each, CUDA events)")
    return launches


def _profile_photometric_node(torch, smi):
    """The photometric LM node (240x320 --gt-disparity, float32,
    run_full_budget), restarted through an LMGraph, under torch.profiler
    at 3 and at 12 LM iterations: the host's launches, graph launches,
    syncs and copies a solve must be equal (none per LM iteration), with
    one graph launch."""
    from ceres_slam_tpu_torch.apps import dense_stereo
    from ceres_slam_tpu_torch.solver import lm, photometric
    from ceres_slam_tpu_torch.solver.lm import SolveConfig

    problem, state0, _ = dense_stereo.synthetic_problem(240, 320, dtype=torch.float32,
                                                        device="cuda")
    keys = ("launches", "graph_launches", "syncs", "copies")
    res = {}
    for n in (3, 12):
        cfg = SolveConfig(max_iters=n, ftol=0.0, gtol=0.0, run_full_budget=True)
        graph = lm.LMGraph()
        photometric.solve_photometric(problem, state0, cfg, graph=graph)  # the capture
        res[n] = _trace(torch, lambda: photometric.solve_photometric(problem, state0, cfg,
                                                                     graph=graph))
        graph.close()
    grow = {k: res[12][k] - res[3][k] for k in keys}
    log(f"[profile] photometric LM node, float32 240x320, restarted ({smi}): 3 / 12 LM "
        "iterations: " + ", ".join(f"{res[3][k]:g} / {res[12][k]:g} {k.replace('_', ' ')}"
                                   for k in keys)
        + "; per LM iteration " + ", ".join(f"{grow[k] / 9:g} {k.replace('_', ' ')}"
                                            for k in keys))
    if any(grow.values()):
        fail(f"photometric LM node: host work grows with the LM iterations: {grow} for 9 more")
    if res[3]["graph_launches"] != 1:
        fail(f"photometric LM node: {res[3]['graph_launches']:g} graph launches, not 1")
    from ceres_slam_tpu_torch.frontend import dense_stereo as front

    out = dense_stereo.make_scene(240, 320, stereo=True, device="cuda")
    left, right = out[1].float(), out[7].float()
    graph = front.MatcherGraph()
    runs = {loop: (lambda loop=loop: front.match_disparity(
        left, right, max_disp=48, loop=loop, graph=graph if loop == "device" else None))
        for loop in ("host", "device")}
    runs["device"]()  # the capture
    tr = {loop: _trace(torch, fn) for loop, fn in runs.items()}
    graph.close()
    log(f"[profile] matcher 240x320 float32 ({smi}), one pair: " + "; ".join(
        f"{loop}: " + ", ".join(f"{t[k]:g} {k.replace('_', ' ')}" for k in keys)
        + f", {t['kernels']:g} device kernels, device busy {t['device_us'] / 1e3:.2f} ms of a "
        f"{t['wall_us'] / 1e3:.2f} ms wall (profiled)" for loop, t in tr.items()))
    if tr["device"]["graph_launches"] != 1 or tr["device"]["launches"] >= tr["host"]["launches"]:
        fail(f"the matcher's replay: {tr['device']} against the eager run's {tr['host']}")


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
    log(f"[profile] one 20-iteration photometric solve, LM loop host (float32, 240x320): wall "
        f"{wall_us / 1e3:.2f} ms (profiled), "
        f"device busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.2f}%), {len(events)} "
        f"device events ({len(events) / 20:.1f} per LM iteration); K4 {len(k4)} calls, "
        f"{sum(k4) / max(len(k4), 1):.2f} us of device time each")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {name[:100]}")


def phase_dense(kernels, data, smi):
    """The dense photometric slice on CUDA, each run in both forms (the LM
    node and the captured matcher, then both on the host); returns K4's
    launches and the --gt-disparity run's pose."""
    import numpy as np

    from ceres_slam_tpu_torch.apps import dense_stereo

    k4 = kernels["K4"].bilinear_sample_packed
    total = 0
    gt = _dense_forms("--gt-disparity", DENSE_ARGS + ["--gt-disparity", "--pairs", "3"], k4,
                      False)
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

    chain = _dense_forms("full chain", DENSE_ARGS + ["--pairs", "3"], k4, True)
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
    images = _dense_forms("--images", ["--images", *paths, "--pyrdown", "1", "--max-disp", "32",
                                       "--camera", "150", "150", "160", "120", "0.5"], k4, True)
    total += images["launches"]
    _matcher_times(smi)
    total += _photometric_rate(k4, smi)
    return total, gt["T"]


def _tree(fn, x):
    """``fn`` on every array leaf (torch or numpy) of a port container."""
    import numpy as np
    import torch

    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if isinstance(x, tuple):
        items = [_tree(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _dist_problem(data, seq):
    """The full-batch problem of dataset_vo --window 0 (its VO initial guess,
    the first pose fixed) on the card, also pickled as numpy for the ranks."""
    import pickle

    from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
    from ceres_slam_tpu_torch.solver import dense

    ds = DatasetProblem.read_csv(os.path.join(data, f"{seq}_vo.csv"))
    ds.device = "cuda"
    ds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = ds._window_budget(ds.num_states)
    problem, state, _ = ds.build_window_problem(0, ds.num_states, n_obs_pad, n_pts_pad)
    with open(os.path.join(data, f"dist_{seq}.pkl"), "wb") as f:
        pickle.dump(_tree(lambda t: t.cpu().numpy(), (problem, state)), f)
    return dense.to_device(problem, "cuda"), state


def _bench_problem():
    """scripts/bench_scaling.py's default shape (64 poses, 2,048 landmarks,
    65,536 observations, float32), seeded: poses stepping 0.3 m along the
    optical axis, each landmark seen by 32 consecutive poses (the track
    structure of the JAX script's example), 0.5 px of noise, pose 0 fixed,
    no sun or prior term."""
    import numpy as np
    import torch

    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver import dense

    K, J, d = 64, 2048, 32
    rng = np.random.default_rng(3)
    xi = np.zeros((K, 6))
    xi[:, 2] = -0.3 * np.arange(K)
    xi[:, 3:] = rng.normal(0, 0.01, (K, 3))
    T = lie.se3_exp(torch.as_tensor(xi))
    start = rng.integers(0, K - d + 1, J)
    pts = rng.uniform([-4, -3, 4], [4, 3, 30], (J, 3))
    pts[:, 2] += 0.3 * (start + d)
    pose_idx = torch.as_tensor((start[:, None] + np.arange(d)).reshape(-1))
    point_idx = torch.as_tensor(np.repeat(np.arange(J), d))
    camera = StereoCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)
    uvd = camera.project(lie.se3_transform_point(T[pose_idx], torch.as_tensor(pts)[point_idx]))
    uvd = uvd + torch.as_tensor(rng.normal(0, 0.5, tuple(uvd.shape)))
    device = "cuda"
    f32 = dict(dtype=torch.float32, device=device)
    N = pose_idx.shape[0]
    up = torch.zeros((K, 3), **f32)
    up[:, 2] = 1.0
    problem = dense.StereoBAProblem(
        camera, dense.StereoObs(uvd.to(**f32), torch.eye(3, **f32).expand(N, 3, 3).contiguous(),
                                pose_idx.to(device), point_idx.to(device),
                                torch.ones(N, dtype=torch.bool, device=device)),
        dense.SunObs(up, up.clone(), torch.eye(2, **f32).expand(K, 2, 2).contiguous(),
                     torch.zeros(K, dtype=torch.bool, device=device)),
        dense.PosePrior(0, T[0].to(**f32), torch.eye(6, **f32), False),
        torch.arange(K, device=device) == 0, torch.ones(J, dtype=torch.bool, device=device),
        0.0, 1.0, 1.0)
    return problem, dense.BAState(T.to(**f32), torch.as_tensor(pts).to(**f32))


def _time_gn_step(mesh, reps=5):
    """Median and least wall of ``gn_step_sharded`` at the bench shape (after
    a warm-up), with its collectives and bytes per step: launch by launch,
    and on NCCL ranks also replayed (``sharded_ba.StepGraph``, captured at
    the warm-up), whose new state must equal the eager step's bits."""
    import torch

    from ceres_slam_tpu_torch.parallel import sharded_ba

    problem, state = _bench_problem()
    shard = sharded_ba.shard_problem(problem, mesh)
    forms = {"eager": None}
    if sharded_ba.resolve_loop(mesh, None) == "device":
        forms["replayed"] = sharded_ba.StepGraph()
    out, figures = {}, {}
    for name, graph in forms.items():
        t0 = time.perf_counter()
        out[name] = sharded_ba.gn_step_sharded(shard, state, mesh, graph=graph)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        c0, b0 = sharded_ba.psum.collectives, sharded_ba.psum.bytes
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out[name] = sharded_ba.gn_step_sharded(shard, state, mesh, graph=graph)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        figures[name] = {"ms": statistics.median(times), "ms_min": min(times),
                         "first_s": first_s,
                         "collectives": (sharded_ba.psum.collectives - c0) / reps,
                         "bytes": (sharded_ba.psum.bytes - b0) / reps,
                         "finite": bool(torch.isfinite(out[name].poses).all())}
        if graph is not None:
            graph.close()
    if "replayed" in out:
        figures["replayed"]["equal"] = all(torch.equal(a, b)
                                           for a, b in zip(out["eager"], out["replayed"]))
    return figures


def _profile_sharded_cg(problem, state, mesh):
    """One CG iteration of the sharded step (block-Jacobi, tol 0) in both
    forms: a step of 21 CG iterations less one of 1, over 20. The host loop
    (``pcg.cg``) under the profiler: device us, kernels, launches, syncs,
    copies, wall, and the five kernels of most device time. The CG loop's
    WHILE node (``pcg.device_cg``, restarted; where the mesh runs it):
    launches, syncs, copies and wall under the profiler, and the device us
    by CUDA events (the profiler sees a node's first pass only)."""
    import torch

    from ceres_slam_tpu_torch.ops.full_batch_trace import kernel_ms
    from ceres_slam_tpu_torch.parallel import sharded_ba, sharded_pcg
    from ceres_slam_tpu_torch.solver import pcg

    prep = sharded_pcg.prepare(problem, state, mesh, "jacobi")
    forms = ("host", "device") if sharded_ba.resolve_loop(mesh, None) == "device" else ("host",)
    graphs = {n: pcg.CGGraph() for n in (1, 21)}
    steps = {(n, loop): sharded_pcg.make_sharded_pcg_step(
        mesh, prep.layout, prep.terms, n, 0.0, cg_loop=loop, graph=graphs[n] if loop == "device"
        else None) for n in (1, 21) for loop in forms}
    calls = {k: (lambda st=st: st(prep.problem, state, 1e-4)) for k, st in steps.items()}
    for call in calls.values():
        call()
    out = {}
    for loop in forms:
        one, many = (_trace(torch, calls[(n, loop)]) for n in (1, 21))
        out[loop] = {k: (many[k] - one[k]) / 20 for k in one}
    one, many = (kernel_ms(calls[(n, "host")], reps=5)[0] for n in (1, 21))
    us = {k: (many[k] - one.get(k, 0.0)) / 20 * 1e3 for k in many}
    out["host"]["top_us"] = sorted(us.items(), key=lambda kv: -kv[1])[:5]
    if "device" in forms:
        ms1, ms21 = _medians_ms(torch, [calls[(1, "device")], calls[(21, "device")]], reps=10)
        out["device"]["device_us"] = (ms21 - ms1) / 20 * 1e3
    for g in graphs.values():
        g.close()
    return out


# the calls of AR's timed graph: the first lines the ranks up
PEER_CALLS = 21


def _peer_device_ms(call):
    """AR's device time a call: the median of its kernel's device times over
    PEER_CALLS eager calls of ``call`` back to back under torch.profiler, as
    the other kernels are timed (the first call, which waits for the other
    ranks, does not move the median). One session: every rank makes the
    same calls, so none is retried. NaN if it recorded no AR kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PEER_CALLS):
            call()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and "peer_allreduce" in e.name]
    return statistics.median(times) / 1e3 if times else math.nan


def _peer_times(group, x):
    """AR's time a call at ``x``'s size, in place, nothing else in the timed
    calls: graphs of 1 and of PEER_CALLS calls captured and replayed between
    CUDA events, (t(PEER_CALLS) - t(1)) / (PEER_CALLS - 1) (the replay's
    launch and the ranks' skew, which the first call absorbs, cancel); the
    kernel's device time from torch.profiler over eager calls back to back
    (``_peer_device_ms``); the plain version and ``dist.all_reduce`` (the
    library call) in place, PEER_CALLS calls back to back between CUDA
    events, a call's share. The values grow with every in-place sum; only
    the times are read."""
    import torch
    import torch.distributed as dist

    from ceres_slam_tpu_torch.ops import allreduce_kernel as ar
    from ceres_slam_tpu_torch.ops import graph_loop

    buf, pbuf, lib = x.clone(), x.clone(), x.clone()
    graphs = {k: graph_loop.DeviceGraph(
        lambda k=k: [ar.peer_all_reduce(buf, group) for _ in range(k)], x.get_device())
        for k in (1, PEER_CALLS)}
    t1, tk = _medians_ms(torch, [graphs[1].replay, graphs[PEER_CALLS].replay], reps=20)
    for g in graphs.values():
        g.close()
    device_ms = _peer_device_ms(lambda: ar.peer_all_reduce(buf, group))

    def calls(fn):
        return lambda: [fn() for _ in range(PEER_CALLS)]

    plain_ms, lib_ms = (t / PEER_CALLS for t in _medians_ms(torch, [
        calls(lambda: ar.peer_all_reduce_plain(pbuf, group)),
        calls(lambda: dist.all_reduce(lib, group=group))], reps=10))
    return {"ms": (tk - t1) / (PEER_CALLS - 1), "device_ms": device_ms,
            "graph1_ms": t1, "plain_ms": plain_ms, "library_ms": lib_ms}


def _peer_check(group, sizes, timed):
    """The peer all-reduce kernel against its plain version on this rank's
    ``group`` at the path's ``sizes`` ({name: (numel, dtype)}, seeded per
    rank): max |kernel - plain| (0: the same sums in the same order), the
    same bits from a second call, from 3 replays of a captured graph of 3
    in-place calls and from a 3-iteration WHILE node run twice (the second a
    restart); with ``timed`` its time a call (``_peer_times``) beside the
    plain version's and ``dist.all_reduce``'s, and the kernel's bound: the
    bytes it must move over NVLink or HBM, 0 on one rank, where the sum is
    the buffer and the kernel returns at once (a launch and nothing more).
    Its launches here are taken back (not the main path's)."""
    import torch
    import torch.distributed as dist

    from ceres_slam_tpu_torch.ops import allreduce_kernel as ar
    from ceres_slam_tpu_torch.ops import graph_loop

    n, rank = dist.get_world_size(group), dist.get_rank(group)
    launches, out = ar.peer_all_reduce.launches, {}
    for name, (numel, dtype) in sizes.items():
        x = torch.randn(numel, generator=torch.Generator().manual_seed(7 + rank),
                        dtype=dtype).cuda()
        nbytes = numel * x.element_size()
        ar.reserve(group, ar.padded_bytes(numel, x.element_size()), x.device)

        def plain(k, start=x):
            y = start.clone()
            for _ in range(k):
                ar.peer_all_reduce_plain(y, group)
            return y

        ref = plain(1)
        k1, k2 = (ar.peer_all_reduce(x.clone(), group) for _ in range(2))
        buf = x.clone()
        g = graph_loop.DeviceGraph(lambda: [ar.peer_all_reduce(buf, group) for _ in range(3)],
                                   x.get_device())
        for _ in range(3):
            g.replay()
        g.close()
        nbuf, i = x.clone(), torch.zeros(1, dtype=torch.int32, device="cuda")
        pred = torch.ones(1, dtype=torch.int32, device="cuda")

        def body():
            ar.peer_all_reduce(nbuf, group)
            i.add_(1)
            pred.copy_(i < 3)

        node, runs = graph_loop.DeviceWhile(body, pred), []
        for _ in range(2):
            nbuf.copy_(x)
            i.zero_()
            pred.fill_(1)
            runs.append((node.run(), nbuf.clone()))
        node.close()
        ref3 = plain(3)
        r = {"numel": numel, "dtype": str(dtype).split(".")[-1],
             "max_abs_err": float((k1 - ref).abs().max()),
             "equal": bool(torch.equal(k1, ref) and torch.equal(k2, ref)),
             "graph_equal": bool(torch.equal(buf, plain(9))),
             "node_equal": all(m == 3 and torch.equal(y, ref3) for m, y in runs)}
        if timed:
            t_hbm = 2 * nbytes / HBM_BYTES_PER_S * 1e3 if n > 1 else 0.0
            t_link = (n - 1) * nbytes / NVLINK_BYTES_PER_S * 1e3
            what = ("NVLink" if t_link > t_hbm else "HBM") if n > 1 else (
                "no bytes: one rank's sum is its buffer, the launch alone")
            r.update(_peer_times(group, x), bound_ms=max(t_hbm, t_link), bound_by="bytes",
                     bound_what=what, ranks=n)
        out[name] = r
    ar.peer_all_reduce.launches = launches
    return out


# the sharded solves of each dist group: (name, preconditioner or None for
# solve_ba_sharded, LM loop form, None for the mesh's default): on NCCL
# ranks of one host the node form, the host form and the node again
# (restarted through one LMGraph), in turns; gloo ranks take the host form
DIST_SOLVES = {
    "kitti1100": [("jacobi", "jacobi", None), ("jacobi host", "jacobi", "host"),
                  ("jacobi device", "jacobi", None)],
    "triangle200": [("solve_ba", None, "host"), ("jacobi", "jacobi", "host"),
                    ("banded", "banded", "host")],
    "hybrid_nccl": [("jacobi", "jacobi", None), ("jacobi host", "jacobi", "host")]}


def _dist_child(group, data):
    """One rank of the dist phase (``--dist-child``): joins its group through
    multihost.initialize and the CERES_* environment, runs the group's
    sharded functions, pickles its arrays and prints its figures as the last
    line of its output. Groups: kitti1100 (NCCL, one rank a card),
    triangle200 (two gloo ranks on the card), hybrid (four, a 2x2 mesh) and
    hybrid_nccl (a 2 x n/2 mesh of NCCL ranks, one a card). On NCCL ranks
    the solves run in the node form and the host form in turns; on gloo
    ranks in the host form, and the device form's refusal is logged. The
    peer all-reduce kernel is checked against its plain version first (on
    kitti1100's ranks at its path's sizes, timed; on the two gloo ranks
    sharing the card, across the two processes)."""
    import pickle

    import torch

    from ceres_slam_tpu_torch.ops import allreduce_kernel, stereo_factor_kernel
    from ceres_slam_tpu_torch.parallel import multihost, sharded_ba, sharded_pcg
    from ceres_slam_tpu_torch.solver import dense, lm

    k2 = stereo_factor_kernel.stereo_factor_sums
    # NCCL refuses two ranks on one card: the groups that share it ask for gloo
    backend = "nccl" if group in ("kitti1100", "hybrid_nccl") else "gloo"
    if not multihost.initialize(device="cuda", backend=backend, timeout_s=300):
        fail(f"dist {group}: no process group started")
    rank, backend = torch.distributed.get_rank(), torch.distributed.get_backend()
    seq = "kitti1100" if group == "kitti1100" else "triangle200"
    with open(os.path.join(data, f"dist_{seq}.pkl"), "rb") as f:
        problem, state = _tree(lambda a: torch.as_tensor(a).cuda(), pickle.load(f))
    config = lm.SolveConfig(**DIST_CONFIG)
    runs, times, arrays = {}, {}, {}
    graph = lm.LMGraph()
    try:
        if group.startswith("hybrid"):
            mesh = multihost.make_hybrid_mesh(
                ranks_per_node=torch.distributed.get_world_size() // 2)
            shard = multihost.shard_problem_global(problem, mesh)
        else:
            mesh = sharded_ba.make_mesh()
            shard = sharded_ba.shard_problem(problem, mesh)
        K, J = state.poses.shape[0], state.points.shape[0]
        if group in ("kitti1100", "triangle200"):  # a CG iteration's two, the LM step's blocks
            f64, f32 = torch.float64, torch.float32
            sizes = {"utv": (J * 3, f64), "uy": (K * 6, f64), "lm": (K * 42 + J * 12, f64),
                     "utv_f32": (J * 3, f32)}
            if group == "triangle200":  # the path's sizes of kitti1100 across two ranks
                _, Jk, Kk = FULL_SHAPES["kitti1100"]
                sizes.update({f"kitti1100 {name}{tag}": (numel, dtype)
                              for name, numel in (("utv", Jk * 3), ("lm", Kk * 42 + Jk * 12))
                              for tag, dtype in (("", f64), ("_f32", f32))})
            times["peer"] = _peer_check(mesh.get_group(0), sizes, timed=group == "kitti1100")
        if group != "kitti1100":
            H, g = sharded_ba.make_sharded_normal_eq(mesh)(shard, state)
            arrays["H"], arrays["g"] = H.cpu().numpy(), g.cpu().numpy()
        if group == "triangle200":
            gn = sharded_ba.gn_step_sharded(shard, state, mesh)
            arrays["gn_step"] = gn.poses.cpu().numpy()
            runs["gn_step"] = {"cost": float(dense.ba_cost(problem, gn))}
        form = sharded_ba.resolve_loop(mesh, None)
        if form == "host":
            try:
                sharded_pcg.solve_ba_pcg_sharded(problem, state, mesh, config, lm_loop="device")
                runs["refused"] = None
            except ValueError as e:
                runs["refused"] = str(e)
        for name, precond, loop in DIST_SOLVES.get(group, []):
            loop = loop or form
            k2.launches = allreduce_kernel.peer_all_reduce.launches = 0
            c0, b0 = sharded_ba.psum.collectives, sharded_ba.psum.bytes
            captures = lm.GRAPH_STATS["captures"]
            t0 = time.perf_counter()
            node = {"graph": graph} if loop == "device" else {}
            if precond is None:
                sol, summ = sharded_ba.solve_ba_sharded(problem, state, mesh, config,
                                                        lm_loop=loop, **node)
            else:
                sol, summ = sharded_pcg.solve_ba_pcg_sharded(
                    problem, state, mesh, config, precond=precond, lm_loop=loop, **node)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            arrays[name] = sol.poses.cpu().numpy()
            runs[name] = {"cost": summ.final_cost, "initial_cost": summ.initial_cost,
                          "lm": summ.iterations, "cg": summ.linear_iterations, "k2": k2.launches,
                          "collectives": sharded_ba.psum.collectives - c0,
                          "bytes": sharded_ba.psum.bytes - b0, "loop": loop,
                          "peer": allreduce_kernel.peer_all_reduce.launches,
                          "captured": lm.GRAPH_STATS["captures"] - captures}
        if not group.startswith("hybrid"):
            times["gn_step_bench"] = _time_gn_step(mesh)
        if group == "kitti1100":
            times["cg_profile"] = _profile_sharded_cg(problem, state, mesh)
    finally:
        graph.close()
        multihost.shutdown()
    with open(os.path.join(data, f"dist_{group}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(arrays, f)
    print(json.dumps({"rank": rank, "backend": backend, "mesh": list(mesh.shape), "runs": runs,
                      "times": times}), flush=True)


def _run_ranks(group, world, data, timeout):
    """``world`` ranks of ``group`` as child processes of this script on a
    free local port; fails if a rank fails or the ranks outlive ``timeout``
    seconds, and unless every rank returned the same bits. Returns rank 0's
    figures and arrays, and every rank's figures."""
    import pickle
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, CERES_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   CERES_NUM_PROCESSES=str(world), CERES_PROCESS_ID=str(r))
        logs.append(open(os.path.join(data, f"dist_{group}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-child", group, "--dist-data", data],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        fail(f"dist {group}: the ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    figures, arrays = [], []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            fail(f"dist {group}: rank {r} exited with {p.returncode}:\n{text[-4000:]}")
        figures.append(json.loads(text.strip().splitlines()[-1]))
        with open(os.path.join(data, f"dist_{group}_rank{r}.pkl"), "rb") as g:
            arrays.append(pickle.load(g))
    for fig, arr in zip(figures[1:], arrays[1:]):
        if fig["runs"] != figures[0]["runs"] or any(
                not np.array_equal(arr[k], arrays[0][k]) for k in arrays[0]):
            fail(f"dist {group}: rank {fig['rank']} returned other bits than rank 0")
    log(f"[dist] {group}: {world} rank(s), {figures[0]['backend']}, mesh {figures[0]['mesh']}, "
        f"in {time.perf_counter() - t0:.2f} s, every rank the same bits")
    return figures[0], arrays[0], figures


def _normal_eq_gate(label, H, g, H_ref, g_ref):
    """Sharded against single-card normal equations: max |difference| within
    DIST_NORMAL_EQ_RTOL of the largest entry."""
    import numpy as np

    H_ref, g_ref = H_ref.cpu().numpy(), g_ref.cpu().numpy()
    eH = float(np.abs(H - H_ref).max() / np.abs(H_ref).max())
    eg = float(np.abs(g - g_ref).max() / np.abs(g_ref).max())
    log(f"[dist] {label} normal equations ({H.shape[0]} x {H.shape[0]}, max |H| "
        f"{np.abs(H_ref).max():.3e}): max |H - H_single| {eH:.2e}, max |g - g_single| {eg:.2e} "
        f"of the largest entry (bound {DIST_NORMAL_EQ_RTOL:g})")
    if not (eH <= DIST_NORMAL_EQ_RTOL and eg <= DIST_NORMAL_EQ_RTOL):
        fail(f"dist {label}: sharded normal equations differ from the single-card ones")


def _bench_line(fig):
    lines = []
    for form, b in fig["times"]["gn_step_bench"].items():
        equal = f", bit-equal to the eager step {b['equal']}" if "equal" in b else ""
        lines.append(
            f"[dist] gn_step_sharded {form} at scripts/bench_scaling.py's default shape (64 "
            f"poses, 2,048 landmarks, 65,536 observations, f32), rank {fig['rank']} of "
            f"{fig['mesh']} ({fig['backend']}): median {b['ms']:.2f} ms (least "
            f"{b['ms_min']:.2f}) per step (the first {b['first_s']:.3f} s), "
            f"{b['collectives']:g} collective(s) of {b['bytes'] / 1e6:.3f} MB per step, finite "
            f"{b['finite']}{equal}")
        if "equal" in b and not (b["equal"] and b["finite"]):
            fail(f"dist: the replayed gn_step_sharded differs from the eager step ({form})")
    return "\n".join(lines)


def _gate_forms(label, fig, arr, names):
    """Fail unless the solves ``names`` (one problem in several loop forms)
    gave the same bits, iterations and collectives, K2 ran once per LM
    iteration in each, on NCCL ranks every collective was one launch of the
    peer all-reduce kernel, and a device form after the first restarted its
    capture. Logs each form's ms per CG iteration."""
    import numpy as np

    first = fig["runs"][names[0]]
    for name in names:
        r, wall = fig["runs"][name], fig["times"][name]
        log(f"[dist] {label} {name} ({r['loop']} LM loop{', captured' if r['captured'] else ''})"
            f": {r['lm']} LM / {r['cg']} CG iterations, {r['collectives']} collectives of "
            f"{r['bytes'] / 1e6:.2f} MB, K2 {r['k2']}, peer all-reduce {r['peer']}, solve "
            f"{wall:.3f} s = "
            f"{1e3 * wall / max(r['cg'], r['lm'], 1):.4f} ms per "
            f"{'CG' if r['cg'] else 'LM'} iteration")
        same = {k: first[k] for k in ("cost", "initial_cost", "lm", "cg", "collectives", "bytes")}
        if ({k: r[k] for k in same} != same or not np.array_equal(arr[name], arr[names[0]])):
            fail(f"dist {label}: {name} ({r['loop']}) differs from {names[0]} "
                 f"({first['loop']})")
        if r["k2"] and r["k2"] != r["lm"]:
            fail(f"dist {label} {name}: {r['k2']} K2 launches for {r['lm']} LM iterations")
        if fig["backend"] == "nccl" and not r["peer"] == r["collectives"] > 0:
            fail(f"dist {label} {name}: {r['peer']} peer all-reduce launches for "
                 f"{r['collectives']} collectives")
    devices = [fig["runs"][n] for n in names if fig["runs"][n]["loop"] == "device"]
    if len(devices) > 1 and any(r["captured"] for r in devices[1:]):
        fail(f"dist {label}: a later device solve captured again instead of restarting")


def _log_peer(label, fig, results):
    """Log and gate a group's peer all-reduce check (``_peer_check``): the
    kernel equals its plain version bit for bit, also replayed and in a
    restarted WHILE node. A timed check's figures go into ``results`` (the
    kernels line, the CG iteration's U^T v as its shape)."""
    for name, r in fig["times"]["peer"].items():
        times = "" if "ms" not in r else (
            f"; {r['ms'] * 1e3:.3f} us a call in a captured run of {PEER_CALLS} (CUDA events; "
            f"a graph of 1 call {r['graph1_ms'] * 1e3:.2f} us), device {r['device_ms'] * 1e3:.3f} "
            f"us a call (torch.profiler, the median of {PEER_CALLS} eager calls), plain {r['plain_ms'] * 1e3:.2f} us,"
            f" dist.all_reduce ({fig['backend']}) {r['library_ms'] * 1e3:.2f} us (in place, "
            f"{PEER_CALLS} back to back), {_bound_str(r)}: {r['bound_what']} "
            f"({r['ranks']} rank(s))")
        log(f"[dist] peer all-reduce, {label}, {name} ({r['numel']:,} {r['dtype']}): "
            f"max |kernel - plain| "
            f"{r['max_abs_err']:.3e}, bit-equal {r['equal']}, after 3 graph replays "
            f"{r['graph_equal']}, in a WHILE node run and restarted {r['node_equal']}{times}")
        if not (r["equal"] and r["graph_equal"] and r["node_equal"]):
            fail(f"dist {label}: the peer all-reduce kernel differs from its plain version ({name})")
        if "ms" in r and name == "utv":
            results[("AR", "utv", "f64")] = {k: r[k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}


def _probe_on_cards(n):
    """The graph probe's distributed cases on ``n`` cards, one NCCL rank a
    card (apps/probe_graph_loop.py): psum_in_while must pass (the peer
    all-reduce eagerly, in a replayed graph, in a flat and a nested WHILE
    node); nccl_in_while (NCCL's all-reduce in the same stages, its kernels
    and node types) is reported only."""
    for args, gate in ((["psum_in_while", "--world", str(n)], True),
                       (["nccl_in_while", "--world", str(n), "--variant", "default"], False)):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ceres_slam_tpu_torch.apps.probe_graph_loop",
                            *args], capture_output=True, text=True, timeout=300, cwd=ROOT)
        with open(os.path.join(ROOT, "build", "chip_smoke_data", f"probe_{args[0]}.log"),
                  "w") as f:
            f.write(r.stdout + r.stderr)
        lines = [ln for ln in r.stdout.splitlines()
                 if "runs on the device" in ln or "nodes" in ln or ln.startswith(
                     (args[0], f"rank 0 of {n}: {args[0]}"))]
        for ln in lines:
            log(f"[dist] probe {args[0]} --world {n}: {ln[:400]}")
        log(f"[dist] probe {' '.join(args)}: exit {r.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        if gate and r.returncode != 0:
            fail(f"dist: probe {' '.join(args)} failed:\n{(r.stdout + r.stderr)[-3000:]}")


def phase_dist(kernels, data, smi, results):
    """The distributed layer (parallel/*): its ranks are child processes of
    this script (no process group here), jax and ceres_slam_tpu blocked as
    here. Returns K2's, K3's and the peer all-reduce's launches: the ranks'
    and this process's single-card solves; the peer all-reduce's timed
    check goes into ``results``."""
    import numpy as np
    import torch

    from ceres_slam_tpu_torch.parallel import sharded_ba
    from ceres_slam_tpu_torch.solver import dense, lm, pcg
    from ceres_slam_tpu_torch.utils import csvio

    k2, k3 = kernels["K2"].stereo_factor_sums, kernels["K3"].schur_uy
    for name in ("K2", "K3", "AR", "CG"):
        kernels[name].build()
    _make_sims(data)
    config = lm.SolveConfig(**DIST_CONFIG)
    total = dict.fromkeys(("K2", "K3", "SP", "CG", "AR"), 0)

    # (a) kitti1100 full batch, one NCCL rank, block-Jacobi, the node and
    # host forms in turns
    t0 = time.perf_counter()
    problem, state = _dist_problem(data, "kitti1100")
    log(f"[dist] kitti1100 full-batch problem, VO initial guess: {time.perf_counter() - t0:.2f} s")
    gt = csvio.read_poses_csv(os.path.join(data, "kitti1100_gt_poses.csv"))
    kitti_state = state
    fig, arr, _ = _run_ranks("kitti1100", 1, data, 900)
    _log_peer("kitti1100, 1 NCCL rank", fig, results)
    launches = _gate_kitti1100(fig, arr, gt, kitti_state, smi)
    for name in ("K2", "AR"):
        total[name] += launches[name]
    _fb_zero(kernels)
    t0 = time.perf_counter()
    ref, rsumm = pcg.solve_ba_pcg(problem, state, config, precond="jacobi")
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    for name, n in _fb_launches(kernels).items():
        total[name] += n
    d = float(np.abs(arr["jacobi"] - ref.poses.cpu().numpy()).max())
    log(f"[dist] kitti1100 solve_ba_pcg single card, jacobi (K2 + K3): cost "
        f"{rsumm.final_cost:.6e}, {rsumm.iterations} LM and {rsumm.linear_iterations} CG "
        f"iterations, solve {ref_wall:.2f} s = "
        f"{1e3 * ref_wall / max(rsumm.linear_iterations, 1):.3f} ms per CG iteration; launches "
        f"K2 {k2.launches}, K3 {k3.launches}; max |pose(sharded) - pose(single)| {d:.3e}")

    # (b) triangle200, two gloo ranks on the card (the host form: gloo's
    # collectives cannot be captured, and the device form must say so)
    problem, state = _dist_problem(data, "triangle200")
    fig, arr, figures = _run_ranks("triangle200", 2, data, 600)
    refused = fig["runs"]["refused"]
    log(f"[dist] triangle200 on gloo ranks, lm_loop='device' refused: {refused}")
    if not refused or "NCCL" not in refused:
        fail("dist triangle200: the device LM loop was not refused on gloo ranks")
    _log_peer("two processes sharing the card (a gloo group)", fig, results)
    H, g = dense.ba_normal_equations(problem, state)
    _normal_eq_gate("triangle200, 2 ranks", arr["H"], arr["g"], H, g)
    _fb_zero(kernels)
    singles = {"gn_step": sharded_ba.gn_step(problem, state, H, g),
               "solve_ba": dense.solve_ba(problem, state, config)[0],
               "jacobi": pcg.solve_ba_pcg(problem, state, config, precond="jacobi")[0],
               "banded": pcg.solve_ba_pcg(problem, state, config, precond="banded")[0]}
    total["K2"] += k2.launches + len(figures) * (fig["runs"]["jacobi"]["k2"]
                                                 + fig["runs"]["banded"]["k2"])
    for name in ("K3", "SP", "CG"):
        total[name] += _fb_launches(kernels)[name]
    for name, ref_cost in JAX_DIST.items():
        r = fig["runs"][name]
        dev = abs(r["cost"] - ref_cost) / ref_cost
        d = float(np.abs(arr[name] - singles[name].poses.cpu().numpy()).max())
        its = "" if name == "gn_step" else (
            f"; {r['lm']} LM and {r['cg']} CG iterations, K2 launches {r['k2']} a rank, "
            f"{r['collectives']} collectives of {r['bytes'] / 1e6:.2f} MB in all, "
            f"{fig['times'][name]:.2f} s")
        log(f"[dist] triangle200 {name}, 2 ranks ({fig['backend']}): cost {r['cost']:.9e} (JAX "
            f"sharded {ref_cost:.9e}, {dev:.2e} relative, bound {DIST_COST_RTOL:g}); max |pose - "
            f"single card| {d:.2e} (bound {DIST_POSE_ATOL:g}){its}")
        if not (dev <= DIST_COST_RTOL and d <= DIST_POSE_ATOL):
            fail(f"dist triangle200 {name}: cost {r['cost']:.9e} vs JAX {ref_cost:.9e}, poses "
                 f"{d:.2e} from the single-card solve")
        if name in ("jacobi", "banded") and not r["k2"] == r["lm"] > 0:
            fail(f"dist triangle200 {name}: {r['k2']} K2 launches for {r['lm']} LM iterations")
    for f in figures:
        log(_bench_line(f))

    # (c) the 2x2 hybrid mesh: four gloo ranks on the card
    fig, arr, _ = _run_ranks("hybrid", 4, data, 600)
    _normal_eq_gate("triangle200, 2x2 hybrid mesh", arr["H"], arr["g"], H, g)

    # (e), (f) where more than one card is visible: (a) on every card, one
    # NCCL rank a card, in the node and host forms (the peer all-reduce
    # checked and timed on them first), after the graph probe's
    # distributed cases; and (c) as a 2 x n/2 mesh of NCCL ranks, with its
    # block-Jacobi solve in the node and host forms
    n = torch.cuda.device_count()
    if n > 1:
        _probe_on_cards(n)
        fig, arr, _ = _run_ranks("kitti1100", n, data, 900)
        _log_peer(f"kitti1100, {n} NCCL ranks", fig, results)
        launches = _gate_kitti1100(fig, arr, gt, kitti_state, smi)
        for name in ("K2", "AR"):
            total[name] += n * launches[name]
    if n >= 4 and n % 2 == 0:
        fig, arr, _ = _run_ranks("hybrid_nccl", n, data, 600)
        _normal_eq_gate(f"triangle200, 2x{n // 2} hybrid mesh of NCCL ranks", arr["H"], arr["g"],
                        H, g)
        _gate_forms(f"triangle200, 2x{n // 2} NCCL mesh", fig, arr, ["jacobi", "jacobi host"])
        r = fig["runs"]["jacobi"]
        dev = abs(r["cost"] - JAX_DIST["jacobi"]) / JAX_DIST["jacobi"]
        log(f"[dist] triangle200 jacobi on the 2x{n // 2} NCCL mesh: cost {r['cost']:.9e}, "
            f"{dev:.2e} from JAX's sharded (bound {DIST_COST_RTOL:g})")
        if dev > DIST_COST_RTOL:
            fail(f"dist triangle200 2x{n // 2} NCCL mesh: cost {r['cost']:.9e}")
        if r["loop"] != "device":
            fail(f"dist triangle200 2x{n // 2} NCCL mesh: the default form is {r['loop']}")
        forms = [fig["runs"][k] for k in ("jacobi", "jacobi host")]
        total["K2"] += n * sum(r["k2"] for r in forms)
        total["AR"] += n * sum(r["peer"] for r in forms)
    return total


def _gate_kitti1100(fig, arr, gt, state, smi):
    """Log the sharded kitti1100 solves (the node and host forms in turns)
    and one CG iteration of each form profiled, and fail unless the forms
    gave the same bits, the cost and ATE are within the full-batch bounds of
    JAX's, K2 ran once per LM iteration on each rank, the node form ran and
    made no host launch, sync or copy a CG iteration. Returns a rank's K2
    and peer all-reduce launches."""
    from ceres_slam_tpu_torch.utils import metrics

    names = [name for name, _, _ in DIST_SOLVES["kitti1100"]]
    r = fig["runs"]["jacobi"]
    ate = metrics.ate_translation(arr["jacobi"], gt)
    cost_ref, ate_ref = JAX_FULL["kitti1100"]
    dev = abs(r["cost"] - cost_ref) / cost_ref
    utv_kb, uy_kb = 24 * state.points.shape[0] / 1e3, 48 * state.poses.shape[0] / 1e3
    ranks = f"{fig['mesh'][0]} rank(s) ({fig['backend']})"
    log(f"[dist] kitti1100 solve_ba_pcg_sharded, jacobi, {ranks}: cost {r['initial_cost']:.6e} "
        f"-> {r['cost']:.6e} (JAX full batch {cost_ref:.6e}, {100 * dev:.4f}% off, bound "
        f"{100 * FULL_COST_RTOL['kitti1100']:g}%), ATE {ate:.6f} m (JAX {ate_ref:.4f}, bound "
        f"+-{FULL_ATE_ATOL['kitti1100']:.4g} m); {r['lm']} LM and {r['cg']} CG iterations; "
        f"{r['collectives']} collectives, {r['bytes'] / 1e6:.2f} MB in all (a CG iteration: 2, "
        f"of {utv_kb:.1f} KB and {uy_kb:.1f} KB); on {smi}")
    _gate_forms(f"kitti1100, {ranks},", fig, arr, names)
    p = fig["times"]["cg_profile"]
    h, d = p["host"], p.get("device")
    log(f"[dist] kitti1100 sharded, one CG iteration ({ranks}, rank 0), host loop (profiled): "
        f"{h['device_us']:.2f} us of device time, {h['kernels']:g} device kernels, "
        f"{h['launches']:g} launches, {h['syncs']:g} syncs, {h['copies']:g} copies, wall "
        f"{h['wall_us']:.1f} us; most device time: "
        + ", ".join(f"{name} {us:.2f} us" for name, us in h["top_us"]))
    if d is None:
        fail(f"dist kitti1100, {ranks}: the device loops did not run on NCCL ranks of one host")
    log(f"[dist] kitti1100 sharded, one CG iteration in its WHILE node ({ranks}, rank 0): "
        f"{d['device_us']:.2f} us of device time (CUDA events), {d['launches']:g} launches, "
        f"{d['graph_launches']:g} graph launches, {d['syncs']:g} syncs, {d['copies']:g} "
        f"copies (profiled), wall {d['wall_us']:.1f} us")
    per_cg = {name: 1e3 * fig["times"][name] / max(fig["runs"][name]["cg"], 1) for name in names}
    log(f"[dist] kitti1100 sharded on {ranks}, ms a CG iteration (solve wall over CG "
        f"iterations): node {per_cg['jacobi']:.4f} (with its capture), host "
        f"{per_cg['jacobi host']:.4f}, node restarted {per_cg['jacobi device']:.4f}; read "
        f"against {DIST_CG_MS_BEFORE}; on {smi}")
    log(_bench_line(fig))
    if not (dev <= FULL_COST_RTOL["kitti1100"]
            and abs(ate - ate_ref) <= FULL_ATE_ATOL["kitti1100"]):
        fail(f"dist kitti1100, {ranks}: cost {r['cost']:.6e} / ATE {ate:.6f} vs JAX "
             f"{cost_ref:.6e} / {ate_ref:.4f}")
    if not r["k2"] == r["lm"] > 0:
        fail(f"dist kitti1100, {ranks}: {r['k2']} K2 launches for {r['lm']} LM iterations")
    if any(d[k] != 0 for k in ("launches", "syncs", "copies")):
        fail(f"dist kitti1100, {ranks}: host work per CG iteration in the node: {d}")
    return {"K2": sum(fig["runs"][name]["k2"] for name in names),
            "AR": sum(fig["runs"][name]["peer"] for name in names)}


def phase_cpu(kernels, data, window_poses, full_poses, dense_pose, graph_poses):
    import numpy as np

    if graph_poses is not None:
        g, summ, wall, launches = _graph_solve(_graph_dataset(data, "triangle200", "cpu"), "pcg",
                                               "lm", "cpu", kernels)
        d = float(np.max(np.abs(np.stack(g._poses) - graph_poses)))
        log(f"[cpu] triangle200 FactorGraph(pcg): max |pose(cpu) - pose(cuda)| = {d:.3e} "
            f"({summ.iterations} LM, {summ.linear_iterations} CG iterations, {wall:.2f} s on the "
            "CPU)")
        if any(launches.values()) or not d <= 1e-6:
            fail(f"CPU FactorGraph(pcg): launches {launches}, poses differ by {d:.3e}")

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
    if launches["total"]:
        fail(f"the CPU run launched K1: {launches}")
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


# name, function, CUDA source, the TPU kernel it replaces (file:line), the
# shape and dtype whose numbers the JSON line reports, and the design
PALLAS = "ceres_slam_tpu/ops/pallas_kernels.py"
KERNELS = (
    ("K1", "window_factor_blocks", "window_factor_blocks.cu", f"{PALLAS}:299", "flagship", "f64",
     "redesigned: one launch (pose blocks, landmark blocks), per-window plan, thin launch path; "
     "batched: one launch for B windows of one shape (window_factor_blocks_batch)"),
    ("K2", "stereo_factor_sums", "stereo_factor_blocks.cu", f"{PALLAS}:124", "kitti1100", "f64",
     "redesigned: fused with its pose and landmark sums (a block per pose, then a landmark "
     "pass in slot order), staged 16-byte stores, full-batch plan, thin launch path"),
    ("K3", "schur_uy", "schur_uy.cu", f"{PALLAS}:591", "kitti1100", "f64",
     "redesigned: rows staged through shared memory, a block per landmark group then per "
     "pose, full-batch plan bound once per LM iteration, thin launch path; runs inside the "
     "CG loop's conditional WHILE node, one graph launch per LM iteration"),
    ("K4", "bilinear_sample_packed", "bilinear_sample_imgs.cu", f"{PALLAS}:427", "240x320", "f64",
     "redesigned: packed [H, W, 4] texels, strided coordinates, per-solve plan, "
     "thin launch path"),
    ("P", "double_kernel", "double_kernel.cu", "scripts/probe_pallas_scan.py:27", "2x512", "f32",
     "first form: 4 blocks of 256 threads or 1 looping block, thin launch path, capturable "
     "in a CUDA graph and runs in a conditional WHILE node (grid_in_while); latency-bound"),
    ("AR", "peer_all_reduce", "peer_allreduce.cu",
     "none: a kernel of the port; the JAX package reduces with XLA's psum inside its compiled "
     "loops (ceres_slam_tpu/parallel/sharded_pcg.py:91, sharded_ba.py:113, :159)", "utv", "f64",
     "redesigned: one flag round a call (two slots a rank, one a round's parity; a grid fixed "
     "per workspace, every block in every round), a system-scope release per block, peers' "
     "slots read as 16-byte vectors with all loads in flight before the first add, the sum in "
     "rank order (the same bits on every rank, no atomics); on one rank the kernel returns at "
     "once; runs inside the sharded LM and CG WHILE nodes; psum's route on NCCL ranks of one "
     "host"),
    ("S", "subspace_step", "subspace_step.cu",
     "none: a kernel of the port (the JAX package runs it as jnp operations, "
     "ceres_slam_tpu/solver/dogleg.py:171 subspace_step, :83 _boundary_min)", "B=2", "f64",
     "redesigned: one warp a window, 4 a block; the 64-step bisection in 13 rounds, the warp's "
     "lanes testing the 31 nodes of the next 5 steps' tree at once (ballot, walk, shuffle), "
     "every operation rounded as the plain version's (bit-equal); runs inside the window "
     "loop's WHILE node; latency-bound (latency_bound_ms: a window's chain at the measured "
     "latencies)"),
    ("SP", "schur_sp", "schur_uy.cu",
     "none: a kernel of the port (the JAX package runs a CG iteration's matvec and dot as jnp "
     "operations, ceres_slam_tpu/solver/pcg.py:499)", "kitti1100", "f64",
     "the fused CG iteration's matvec: K3's landmark phase, then a pose phase that also forms "
     "Sp = Hpp p - Uy and each pose's share p_k . Sp_k of the first dot (Hpp_k and p_k copied "
     "to shared memory asynchronously); runs inside the CG loop's WHILE node with block-Jacobi"),
    ("CG", "cg_update", "cg_step.cu",
     "none: a kernel of the port (the JAX package runs a CG iteration's update as jnp "
     "operations in its lax.while_loop, ceres_slam_tpu/solver/pcg.py:499, :512)", "kitti1100",
     "f64",
     "the rest of a CG iteration after schur_sp in two launches of 64-thread blocks, a thread a "
     "pose: every block sums the global dots in one fixed tree (no atomics, the same bits run to "
     "run); alpha, x, r, the block-Jacobi factors' two triangular solves in registers, r.z, r.r; "
     "then beta, p, the count and the stop test; latency-bound"),
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    # one rank of the dist phase (the phase starts these itself)
    ap.add_argument("--dist-child", help=argparse.SUPPRESS)
    ap.add_argument("--dist-data", help=argparse.SUPPRESS)
    cli = ap.parse_args()
    if cli.dist_child:
        sys.path.insert(0, ROOT)
        _dist_child(cli.dist_child, cli.dist_data)
        return
    phases = cli.phases.split(",")
    if not set(phases) <= set(PHASES) or ("cpu" in phases
                                          and not {"slice", "dense", "graph"} & set(phases)):
        fail(f"bad --phases {phases}")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from ceres_slam_tpu_torch.apps import probe_op_latency
        from ceres_slam_tpu_torch.ops import (allreduce_kernel, bilinear_kernel, cg_kernel,
                                              double_kernel, graph_loop, schur_kernel,
                                              stereo_factor_kernel, subspace_kernel,
                                              window_kernel)
    except ImportError as e:
        fail(f"cannot import the port: {e}")
    kernels = {"K1": window_kernel, "K2": stereo_factor_kernel, "K3": schur_kernel,
               "K4": bilinear_kernel, "P": double_kernel, "S": subspace_kernel,
               "AR": allreduce_kernel, "CG": cg_kernel}

    smi = phase_device(torch)
    if "build" in phases or "kernels" in phases:
        phase_build({**kernels, "loop": graph_loop, "probe": probe_op_latency})
    launches = {row[0]: 0 for row in KERNELS}
    k, jobs = {}, []
    if "kernels" in phases:
        k, jobs, launches["P"] = phase_kernels(torch, kernels)
    window_poses = full_poses = dense_pose = graph_poses = None
    data = os.path.join(ROOT, "build", "chip_smoke_data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)
    if "slice" in phases:
        slice_launches, window_poses, full_poses = phase_slice(kernels, data, smi)
        launches.update(slice_launches)
    if "batch" in phases:
        for name, n in phase_batch(kernels, data, smi).items():
            launches[name] += n
    if "dense" in phases:
        launches["K4"], dense_pose = phase_dense(kernels, data, smi)
    if "phong" in phases:
        phase_phong(data, smi)
    if "graph" in phases:
        graph_launches, graph_poses = phase_graph(kernels, data, smi)
        for name, n in graph_launches.items():
            launches[name] += n
    if "blowup" in phases:
        phase_blowup(smi)
    if "live_vo" in phases:
        phase_live_vo(data, smi)
    if "dist" in phases:
        for name, n in phase_dist(kernels, data, smi, k).items():
            launches[name] += n
    if "cpu" in phases:
        phase_cpu(kernels, data, window_poses, full_poses, dense_pose, graph_poses)
    if "profile" in phases or ("kernels" in phases
                               and not {"slice", "batch", "dense", "phong"} & set(phases)):
        phase_profile(torch, jobs, "dense" in phases, "phong" in phases, data,
                      smi, "blowup" in phases, "batch" in phases, "slice" in phases)
    nan = {"max_abs_err": math.nan, "ms": math.nan, "plain_ms": math.nan, "bound_ms": math.nan,
           "bound_by": None, "library_ms": None}
    launches["K3"] -= launches["SP"]  # K3's row: schur_uy's own (schur_sp counts as K3 too)
    batched = {f"{shape} {tag}": k[("K1 batch", shape, tag)] for shape in K1_BATCH_SHAPES
               for tag in ("f64", "f32") if ("K1 batch", shape, tag) in k}
    log(json.dumps({"kernels": [{
        "name": fn, "route": "cuda", "source": f"ceres_slam_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": launches[name],
        **k.get((name, shape, tag), nan), "design": design,
        **({"batched": batched} if name == "K1" and batched else {})}
        for name, fn, src, replaces, shape, tag, design in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
