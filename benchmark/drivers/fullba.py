"""``fullba`` mixes: a closed loop of full-batch Schur-PCG solves.

Each item solves every one of the mix's ``trials`` once, in an order drawn
from the seed, by ``ceres_slam_tpu_torch.solver.pcg.solve_ba_pcg(problem,
state0, config, graph=)`` with one ``lm.LMGraph`` kept across the solves, as
``DatasetProblem.solve_full`` keeps one for a pass: on the card every solve
after the warm-up restarts the captured LM node (the CG node nested in it)
after copying its inputs in. So every item, and every seed, does the same
work. The trials share the scene (trajectory, landmarks, which observations
exist); each has its own measurement noise and its own RANSAC hypotheses
(three distinct matches of each consecutive pair, uniformly), drawn from the
mix's ``trial_seed``. The problem is built by the port's own
``DatasetProblem`` from those arrays, as ``dataset_vo --window 0`` builds it
from its CSV, and started as that app starts it: the hypotheses injected
(``precompute_pair_alignments(hyp_idx=)``), the program's VO initial guess
over the whole drive (``compute_initial_guess``), the landmarks that guess
initializes in the problem, at set-up.

After the window the plain reference (``benchmark/reference/stereo_ba.py``)
judges every solve of the window: the start against the reference's own VO
initial guess on the same hypotheses (``vo_init.py``), the costs it reports at its start and at
its end against the reference's cost of those states, and its final poses
and landmarks by the reference's gradient there, as a share of the gradient
at the start (first-order optimality; the solver's function tolerance stops
it before the drive's weakest modes settle, metres from the exact optimum at
the far end, so positions are not compared with an exact solve).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import hypotheses
from benchmark.registry import load_json, load_module
from benchmark.reference import stereo_ba as ref
from benchmark.reference import vo_init


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *keys])


def project(ds, poses, points, ks, js):
    R = poses[ks, 3:].reshape(-1, 3, 3)
    q = np.einsum("nab,nb->na", R, points[js]) + poses[ks, :3]
    return np.stack([ds.fu * q[:, 0] / q[:, 2] + ds.cu, ds.fv * q[:, 1] / q[:, 2] + ds.cv,
                     ds.fu * ds.b / q[:, 2]], axis=-1)


class Trial:
    """One noise trial: its observations and hypotheses, the start the
    program's VO initial guess made of them, its problem on the card."""

    def __init__(self, uvd, hyp):
        self.uvd, self.hyp = uvd, hyp
        self.problem = self.state0 = None


class Driver:
    # the program's host phases the traced run marks
    phases = (("ceres_slam_tpu_torch.solver.pcg", "prepare"),
              ("ceres_slam_tpu_torch.solver.lm", "_copy_inputs"))

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        from ceres_slam_tpu_torch.solver import lm

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        ds = load_module("generators", config["generator"]).make(config["scene"])
        self.ds = ds
        ks, js = ds.state_ids, ds.point_ids
        clean = project(ds, ds.poses_gt, ds.points_gt, ks, js)
        sigma = np.asarray(config["scene"]["stereo_noise"], float)
        self.pairs = hypotheses.pair_matches(ks, js, ds.poses_gt.shape[0])
        self.trials = []
        for t in range(mix["trials"]):
            g = rng(mix["trial_seed"], t)
            uvd = clean + g.normal(0.0, sigma, clean.shape)
            self.trials.append(Trial(uvd, hypotheses.draw(self.pairs, config["ransac"]["iters"], g)))
        self.order = rng(seed, 2).permutation(len(self.trials))
        for trial in self.trials:
            trial.problem, trial.state0, trial.slots = self._problem(trial)
        s = mix["solver"]
        tol = s["tolerance"][config["dtype"]]
        self.solve_config = lm.SolveConfig(max_iters=s["max_iters"], nonmonotonic=s["nonmonotonic"],
                                           ftol=tol, xtol=tol)
        self.graph = lm.LMGraph() if device == "cuda" else None
        self.outputs = []

    def _problem(self, trial):
        """The port's ``DatasetProblem`` of a trial, as ``dataset_vo`` reads
        it from its track CSV (shared variances), started as ``dataset_vo
        --window 0`` starts it: the VO initial guess over the whole drive on
        the trial's hypotheses; ``(problem, state0, slots)`` on the device,
        the start and which landmarks it initialized kept on the host."""
        from ceres_slam_tpu_torch.problems.dataset import DatasetProblem
        from ceres_slam_tpu_torch.solver import dense

        ds = self.ds
        K, J = ds.poses_gt.shape[0], ds.points_gt.shape[0]
        T0 = np.eye(4)
        T0[:3, :3], T0[:3, 3] = ds.poses_gt[0, 3:].reshape(3, 3), ds.poses_gt[0, :3]
        rows = [[K, J], [ds.fu, ds.fv, ds.cu, ds.cv, ds.b], list(ds.stereo_var), list(T0.ravel())]
        rows += list(np.column_stack([ds.state_ids, ds.point_ids, trial.uvd]))
        dp = DatasetProblem()
        dp._parse_track(rows, with_covar=False)
        dp._init_state()
        dp.dtype, dp.device = self.config["dtype"], self.device
        dp.precompute_pair_alignments(hyp_idx=torch.as_tensor(trial.hyp).to(dp._device))
        dp.compute_initial_guess(0, K)
        trial.poses0, trial.points0 = dp.poses.copy(), dp.map_points.copy()
        trial.initialized = dp.initialized_point.copy()
        n_obs, n_pts, _ = dp._window_budget(K)
        problem, state0, slots = dp.build_window_problem(0, K, n_obs, n_pts, gauge_fix_first=True)
        return dense.to_device(problem, self.device), state0, slots

    def _solve(self, problem, state0):
        from ceres_slam_tpu_torch.solver import pcg

        return pcg.solve_ba_pcg(problem, state0, self.solve_config, graph=self.graph)

    def warm(self):
        """Capture the LM node on a copy of the first trial (the node then
        reads that copy's tensors, which later solves overwrite), then run
        the restart path once."""
        from ceres_slam_tpu_torch.solver import lm, pcg

        first = self.trials[self.order[0]]
        self._captured = lm.tree_map(torch.clone, first.problem)
        self._solve(self._captured, first.state0)
        self._solve(first.problem, first.state0)
        tables, plan, tracks, _ = pcg.prepare(first.problem, first.state0)
        self._k3 = (tables, plan)
        print(f"fullba: the preconditioner 'auto' resolves to "
              f"{'jacobi' if tracks is None else 'banded'}", file=sys.stderr)

    def run_item(self, i: int) -> dict:
        """Every trial once, in the seed's order."""
        its = cg = 0
        ok = True
        for t in self.order:
            trial = self.trials[t]
            sol, summary = self._solve(trial.problem, trial.state0)
            self.outputs.append((int(t), sol, summary))
            its, cg = its + summary.iterations, cg + summary.linear_iterations
            ok = ok and bool(np.isfinite(summary.final_cost))
        return {"solves": len(self.order), "iterations": its, "cg_iterations": cg, "ok": ok}

    def kernel_case(self, name: str):
        """``(call, bytes, operations, dtype tag)`` of a kernel alone on this
        cell's own plan: K3 bound at the first trial's start."""
        from ceres_slam_tpu_torch.ops import schur_kernel
        from ceres_slam_tpu_torch.solver import pcg

        from benchmark import roofline

        if name != "K3" or self.device != "cuda":
            return None
        first = self.trials[self.order[0]]
        tables, plan = self._k3
        b = pcg.build_obs_blocks(first.problem, first.state0, 1e-4, tables=tables, plan=plan)
        v = torch.ones_like(b.gp)
        elem = b.U18.element_size()
        nbytes, ops = roofline.k3_cost(b.U18.shape[0], b.Cinv.shape[0], v.shape[0], elem)
        return (lambda: schur_kernel.schur_uy(b.uy, v)), nbytes, ops, "f64" if elem == 8 else "f32"

    def release(self):
        """Bring what the window produced to the host and free the
        program's state."""
        kept = []
        for t, sol, summary in self.outputs:
            J = self.trials[t].slots.size
            kept.append((t, sol.poses.double().cpu(), sol.points[:J].double().cpu(), summary))
        self.outputs = kept
        if self.graph is not None:
            self.graph.close()
        self.graph = self._captured = self._k3 = None
        for trial in self.trials:
            trial.problem = trial.state0 = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """``[name, worst value, limit]`` over every solve of the window."""
        limits = load_json("limits", f"{self.config['name']}.{self.mix['name']}")
        dev = "cuda" if self.device == "cuda" else "cpu"
        ds = self.ds
        K = ds.poses_gt.shape[0]
        observed, local = np.unique(ds.point_ids, return_inverse=True)
        J = observed.size
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[0] = True
        sigma = torch.as_tensor(ds.stereo_var, dtype=torch.float64, device=dev).sqrt()
        cam = (ds.fu, ds.fv, ds.cu, ds.cv, ds.b)
        starts = {}
        worst = dict.fromkeys(limits, -np.inf)
        for t, poses, points, summary in self.outputs:
            trial = self.trials[t]
            if t not in starts:
                starts[t] = self._start(trial, cam, observed, local, J, K, sigma, fixed, dev)
            pb, c0, g0, gap = starts[t]
            poses, points = poses.to(dev), points.to(dev)
            c = ref.cost(pb, poses, points)
            got = {"init_gap": gap,
                   "start_cost_rel": abs(summary.initial_cost - c0) / c0,
                   "cost_rel": abs(summary.final_cost - c) / c,
                   "grad_rel": _max_abs(ref.gradient(pb, poses, points, fixed)) / g0}
            for k, v in got.items():
                worst[k] = v if np.isnan(v) or np.isnan(worst[k]) else max(worst[k], v)
        # a number nothing in the window gave is not correct (NaN)
        return [[k, worst[k] if worst[k] > -np.inf else float("nan"), limits[k]] for k in limits]

    def reference_guess(self, trial: Trial, dev, dtype=np.float64):
        """The reference's VO initial guess of a trial on its hypotheses, in
        ``dtype`` (float32: the control of ``init_gap``)."""
        ds = self.ds
        return vo_init.stereo_guess(
            (ds.fu, ds.fv, ds.cu, ds.cv, ds.b), trial.uvd, ds.state_ids, ds.point_ids,
            self.pairs, trial.hyp, self.config["ransac"]["thresh"], ds.poses_gt[0],
            ds.points_gt.shape[0], dev, dtype)

    def _start(self, trial, cam, observed, local, J, K, sigma, fixed, dev):
        """The reference's problem of a trial over the landmarks its own VO
        initial guess initializes (their observations), its cost and
        gradient at the program's start, and the largest gap between that
        start and the reference's initial guess (infinite where the two
        initialize different landmarks)."""
        ds = self.ds
        gap = init_gap(trial, self.reference_guess(trial, dev), observed)
        rows = np.nonzero(trial.initialized[observed][local])[0]
        put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        pb = ref.Problem(cam, put(trial.uvd[rows]), sigma, put(ds.state_ids[rows]),
                         put(local[rows]), K, J)
        p0, x0 = put(trial.poses0), put(trial.points0[observed])
        return pb, ref.cost(pb, p0, x0), _max_abs(ref.gradient(pb, p0, x0, fixed)), gap


def init_gap(trial: Trial, guess, observed) -> float:
    """The largest gap between a trial's start and a reference initial guess
    ``(poses, points, initialized)`` over the poses and the observed
    landmarks both initialize; infinite where they initialize different
    landmarks."""
    poses, points, done = guess
    ok = trial.initialized[observed]
    if not np.array_equal(done[observed], ok):
        return float("inf")
    return max(float(np.abs(trial.poses0 - poses).max()),
               float(np.abs(trial.points0[observed][ok] - points[observed][ok]).max(initial=0.0)))


def _max_abs(grads) -> float:
    return max(float(g.abs().max()) for g in grads)
