"""``window_batch`` mixes: the flagship sliding window as a harness runs a drive.

Chains in lockstep through ``ceres_slam_tpu_torch.problems.batch_scan.
BatchSolve``: the VO-only pass and a sun-aided pass for each of the mix's
sun sources (the KITTI-shaped drive with sun observations of noise 0, 10 and
20 degrees standing in for gt, cnn and viso2, drawn from the mix's
``sun_seed``), window 2, the dogleg, the
app's defaults otherwise (``dataset_vo_sun_batch``: nonmonotonic steps,
``ftol = xtol`` by the precision and the chain's length). An item is one
step: window ``k1`` of every chain, one graph launch and one read. When the
drive ends the next pass starts from fresh copies (a new ``BatchSolve``),
on the trust-region loop captured by the first pass (warm-up), which every
pass restarts as the app's pass restarts it from window to window.
The drive is written once, at set-up, as the app's CSVs (the track with its
covariances, the ephemeris, each sun source's observations) in a temporary
directory and read back by ``DatasetProblemSun.read_csv``; the RANSAC
hypotheses are drawn by the benchmark from the seed (three distinct matches
of each pair, uniformly) and injected through
``precompute_pair_alignments(hyp_idx=)``, shared by the sun sources' datasets
as the app shares them.

After the window a sample of the windows solved, drawn from the seed, is
judged by the plain reference (``benchmark/reference/stereo_window.py``)
from the program's own state at each window (the reference cannot run the
chain itself: every window starts from the one before): the window's VO
initial guess (the new pose and the landmarks, from the reference's own
RANSAC on the same hypotheses), its reported start and final costs, its
solution by the gradient there (a share of the gradient at its start), and
the covariance of its second pose (the next window's prior) against the
marginal of the reference's Gauss-Newton matrix there.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark import hypotheses, simcopy
from benchmark.registry import load_json, load_module
from benchmark.reference import stereo_window as ref
from benchmark.reference import vo_init


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *keys])


class Driver:
    # the program's host phases the traced run marks
    phases = (("ceres_slam_tpu_torch.problems.dataset", "DatasetProblem.compute_initial_guess"),
              ("ceres_slam_tpu_torch.problems.batch_scan", "BatchSolve._hosts"),
              ("ceres_slam_tpu_torch.solver.window", "build_batch_layout"),
              ("ceres_slam_tpu_torch.solver.window", "solve_batch_with_covariance"))

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        from ceres_slam_tpu_torch.problems import batch_scan
        from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
        from ceres_slam_tpu_torch.solver import lm

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        gen = load_module("generators", config["generator"])
        drive = gen.make(config["scene"])
        self.sims, datasets = [], []
        with tempfile.TemporaryDirectory() as tmp:
            track = os.path.join(tmp, "track.csv")
            ref_sun = os.path.join(tmp, "sun_ref.csv")
            simcopy.write_track_csv(drive, track, with_covar=True)
            simcopy.write_ref_sun_csv(drive, ref_sun)
            for i, noise in enumerate(mix["sun_noise_deg"]):
                sim = gen.with_sun_noise(drive, noise, rng(mix["sun_seed"], i))
                obs = os.path.join(tmp, f"sun_dir_{i}.csv")
                simcopy.write_obs_sun_csv(sim, obs)
                ds = DatasetProblemSun.read_csv(track, ref_sun, obs)
                ds.dtype, ds.device = config["dtype"], device
                self.sims.append(sim)
                datasets.append(ds)
        sim = self.sims[0]
        K = sim.num_states
        self.pairs = hypotheses.pair_matches(sim.state_ids, sim.point_ids, K)
        self.hyp = hypotheses.draw(self.pairs, config["ransac"]["iters"], rng(seed, 3))
        first = datasets[0]
        first.precompute_pair_alignments(hyp_idx=torch.as_tensor(self.hyp).to(first._device))
        for other in datasets[1:]:  # as dataset_vo_sun_batch shares a track's RANSAC
            other._pair_T = first._pair_T
            other._pair_inliers = first._pair_inliers
            other._pair_num_inliers = first._pair_num_inliers
        huber = mix["huber"]
        self.runs = [batch_scan.RunSpec(first, use_sun=False)] + [
            batch_scan.RunSpec(ds, use_sun=True, huber_param=huber) for ds in datasets]
        self.run_sim = [0] + list(range(len(datasets)))
        s = mix["solver"]
        tol = s["tolerance"][config["dtype"]]
        self.solve_config = lm.SolveConfig(max_iters=s["max_iters"], nonmonotonic=True,
                                           ftol=tol, xtol=tol)
        self.solver = self.graph = None
        self.k1 = 0
        self.records: list = []
        self._recording = False
        self._starts: list = []
        self._last = None
        # a traced run profiles the window's first profile_steps steps
        # (benchmark/trace.py)
        self.gated = True
        self.gate = None

    def _instrument(self):
        """Keep each step's solved chains with the start state of their
        windows (a copy on the device, no read)."""
        from ceres_slam_tpu_torch.problems import batch_scan
        from ceres_slam_tpu_torch.solver import window

        per_window, solve = batch_scan.BatchSolve._per_window, window.solve_batch_with_covariance
        starts = self._starts

        def chains(bs, chains_, slots, k1):
            starts.append([[bs.chains.index(c) for c in chains_], list(slots), k1,
                           [c.ds.pose_covars[k1].copy() for c in chains_]])
            return per_window(bs, chains_, slots, k1)

        def solved(layout, state0, *a, **k):
            starts[-1].append((state0.poses.clone(), state0.points.clone()))
            self._last = (layout, starts[-1][-1])
            return solve(layout, state0, *a, **k)

        batch_scan.BatchSolve._per_window = chains
        window.solve_batch_with_covariance = solved

        def undo():
            batch_scan.BatchSolve._per_window = per_window
            window.solve_batch_with_covariance = solve
        self._unwrap = undo

    def _new_pass(self):
        """A new pass from fresh copies of the datasets, on the loop
        captured by the first pass (every pass has one shape)."""
        from ceres_slam_tpu_torch.problems import batch_scan

        self.solver = batch_scan.BatchSolve(self.runs, self.mix["window"], self.solve_config,
                                            "dogleg")
        if self.graph is None:
            self.graph = self.solver.graph
        elif self.solver.graph is not None:
            self.solver.graph.close()
            self.solver.graph = self.graph
        self.k1 = 0

    def warm(self):
        self._instrument()
        self._new_pass()
        for _ in range(self.mix["warm_steps"]):
            self._step()
        self.solver = None
        self._recording = True

    def _step(self):
        if self.solver is None or self.k1 >= self.solver.num_steps:
            self._new_pass()
        before = [len(c.summaries) for c in self.solver.chains]
        n = self.solver.step(self.k1)
        k1, self.k1 = self.k1, self.k1 + 1
        its = 0
        start = self._starts.pop() if self._starts else None
        if n and self._recording:
            rows, slots, _, prior_covs, (p0, x0) = start
            for r, (c_i, sl, pc) in enumerate(zip(rows, slots, prior_covs)):
                c = self.solver.chains[c_i]
                ds = c.ds
                self.records.append(dict(chain=c_i, k1=k1, slots=sl, prior_cov=pc,
                                         start=(p0[r], x0[r]),
                                         poses=ds.poses[k1:k1 + 2].copy(),
                                         points=ds.map_points[sl].copy(),
                                         cov=ds.pose_covars[k1 + 1].copy(),
                                         summary=c.summaries[-1]))
        for c, b in zip(self.solver.chains, before):
            its += sum(s.iterations for s in c.summaries[b:])
        return n, its

    def run_item(self, i: int) -> dict:
        if self.gate is not None:  # the first profile_steps steps of the window
            if i == 0:
                self.gate.open()
            elif i == self.mix["profile_steps"]:
                self.gate.close()
        t0 = time.perf_counter()
        quiet = self.gate is not None and not self.gate.profiling
        n, its = self._step()
        wall = [1e3 * (time.perf_counter() - t0)]
        return {"windows": n, "iterations": its, "solves": n, "steps_ms": wall,
                "quiet_steps_ms": wall if quiet else [], "ok": n > 0}

    def kernel_case(self, name: str):
        """``(call, bytes, operations, dtype tag)`` of a kernel alone on this
        cell's own plan: K1 batched on the last step's windows."""
        from ceres_slam_tpu_torch.ops import window_kernel

        from benchmark import roofline

        if name != "K1" or self.device != "cuda":
            return None
        layout, (poses, points) = self._last
        plan = layout.plan
        elem = poses.element_size()
        nbytes, ops = roofline.k1_batch_cost(plan.B, plan.K, plan.J, plan.O,
                                             int(plan.pose_start[-1, -1]), elem)
        return ((lambda: window_kernel.window_factor_blocks_batch(plan, poses, points)), nbytes,
                ops, "f64" if elem == 8 else "f32")

    def release(self):
        self._last = None
        self._recording = False
        self._unwrap()
        if self.graph is not None:
            self.graph.close()
        self.solver = self.graph = None
        for r in self.records:
            r["start"] = tuple(x.detach().double().cpu() for x in r["start"])
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """``[name, worst value, limit]`` over a sample of the windows."""
        limits = load_json("limits", f"{self.config['name']}.{self.mix['name']}")
        g = rng(self.seed, 4)
        n = min(self.mix["check_windows"], len(self.records))
        sample = [self.records[i] for i in sorted(g.choice(len(self.records), n, replace=False))]
        sim = self.sims[0]
        cam = (sim.fu, sim.fv, sim.cu, sim.cv, sim.b)
        pts_c = vo_init.triangulate(cam, sim.uvd)
        whiten = ref.inv_sqrt(torch.as_tensor(sim.uvd_covar))
        worst = dict.fromkeys(limits, -np.inf)
        for rec in sample:
            got = self._judge(rec, cam, pts_c, whiten)
            for k, v in got.items():
                worst[k] = v if np.isnan(v) or np.isnan(worst[k]) else max(worst[k], v)
        # a number nothing in the window gave is not correct (NaN)
        return [[k, worst[k] if worst[k] > -np.inf else float("nan"), limits[k]] for k in limits]

    def _judge(self, rec: dict, cam, pts_c, whiten) -> dict:
        sim = self.sims[self.run_sim[rec["chain"]]]
        k1, k2 = rec["k1"], rec["k1"] + self.mix["window"]
        slots = rec["slots"]
        a, b = self.pairs[k1 + 1]
        R, t, inl = vo_init.ransac(
            cam, torch.as_tensor(pts_c[a])[None], torch.as_tensor(pts_c[b])[None],
            torch.ones(1, a.size, dtype=torch.bool),
            torch.as_tensor(self.hyp[k1 + 1][None]), self.config["ransac"]["thresh"])
        R, t, inl = R[0].numpy(), t[0].numpy(), inl[0].numpy()
        p0, x0 = rec["start"]
        p0, x0 = p0.numpy(), x0.numpy()
        R0, t0 = p0[0, 3:].reshape(3, 3), p0[0, :3]
        guess = np.concatenate([R @ t0 + t, (R @ R0).reshape(9)])
        new = np.zeros(slots.size, bool)
        local = {j: i for i, j in enumerate(slots)}
        seen = set()
        pts0 = np.zeros((slots.size, 3))
        for row in a[inl]:
            j = sim.point_ids[row]
            if j not in seen:
                seen.add(j)
                pts0[local[j]] = (pts_c[row] - t0) @ R0
                new[local[j]] = True
        got = {"init_gap": max(float(np.abs(p0[1] - guess).max()),
                               float(np.abs(x0[:slots.size][new] - pts0[new]).max(initial=0.0)))}
        rows = np.nonzero((sim.state_ids >= k1) & (sim.state_ids < k2)
                          & np.isin(sim.point_ids, slots[new]))[0]
        chain_sun = rec["chain"] > 0
        unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
        floor = self.config["covariance_floor"]
        t_ = torch.as_tensor
        w = ref.Window(cam, t_(sim.uvd[rows]), whiten[rows], t_(sim.state_ids[rows] - k1),
                       t_(np.searchsorted(slots, sim.point_ids[rows])),
                       t_(unit(sim.sun_obs_c[k1:k2])), t_(unit(sim.sun_dir_g[k1:k2])),
                       ref.inv_sqrt(t_(sim.sun_covar[k1:k2])),
                       t_(sim.has_sun[k1:k2] & chain_sun),
                       self.mix["huber"] if chain_sun else 0.0, 1000.0, 1000.0,
                       t_(p0[0]), ref.inv_sqrt(t_(rec["prior_cov"] + floor * np.eye(6))))
        used = np.unique(np.searchsorted(slots, sim.point_ids[rows]))
        c0, g0, _ = ref.analyse(w, t_(p0), t_(x0[:slots.size]))
        c1, g1, H = ref.analyse(w, t_(rec["poses"]), t_(rec["points"]))
        keep = np.concatenate([np.arange(12), 12 + (3 * used[:, None] + np.arange(3)).ravel()])
        keep = t_(keep)
        cov = ref.marginal_covariance(H[keep][:, keep], 1)
        s = rec["summary"]
        got.update(start_cost_rel=abs(s.initial_cost - c0) / c0,
                   cost_rel=abs(s.final_cost - c1) / c1,
                   grad_rel=float(g1[keep].abs().max() / g0[keep].abs().max()),
                   cov_rel=float((t_(rec["cov"]) - cov).abs().max() / cov.abs().max()))
        return got
