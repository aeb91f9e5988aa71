"""``phong`` mixes: a closed loop of full-batch ``dataset_ba_phong --multistage`` runs.

Each item runs every one of the mix's ``trials`` once, in an order drawn
from the seed, each on a fresh copy of its dataset: what one
``dataset_ba_phong --multistage`` run does after reading its CSV, through
``DatasetProblemPhong``: the RANSAC VO initial guess with the materials' and
textures' start (``compute_initial_guess``), then ``solve_full``'s
full-batch path with the app's default ``SolveConfig``: the padded problem
(``build_window_problem``), the three staged solves
(``phong.solve_phong_staged``), the solution absorbed. Each stage's LM loop
runs as a WHILE node on one ``lm.LMGraph`` kept across the runs, so the
warm-up, which runs every trial once, captures every stage of every trial,
and every run of the window restarts those captures. So the cell is a
stand-in: it measures restarts of kept captures, not the app's one-shot run,
which captures its three stages anew every run (``solve_full``'s own
graph); a capture made while the profiler runs can fault on the card
(PERF.md, Open questions), and that form waits until it can be traced. So
every item, and every seed, does the same work. The trials are the Phong
sim (``generate_phong``) at the configuration's sizes under the seeds
``trial_seed + t``; each is written once, at set-up, as the app's track CSV
in a temporary directory and read back by ``DatasetProblemPhong.read_csv``.

Every stage solve of the window is recorded (its start, its result and its
``SolveSummary``) and judged after the window by the plain reference
(``benchmark/reference/phong_ba.py``, ``vo_init.py``): the initial guess
the first stage starts from against the reference's own RANSAC initial
guess (on the same hypotheses), every stage's reported start and final
costs against the reference's costs of those states, every stage's drop
(the reference's cost at its start over the decrease to its result,
infinite where the cost did not fall: a stage that returns its start
fails), and the geometry stage's final state by the reference's gradient
there over the free poses and vertices, as a share of the gradient at the
stage's start. The stages with the light are not judged by their gradient:
the shading's ``max(0, .)``, clamp and specular switch make their objective
non-smooth, and the joint stage stops at kinks where the gradient does not
vanish (0.60 of its start on one 60-state scene in float64), after a drop of
only a few parts in 10^4 of its start's cost.
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch

from benchmark import simcopy
from benchmark.registry import load_json, load_module
from benchmark.reference import phong_ba as ref
from benchmark.reference import vo_init


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *keys])


class Driver:
    # the program's host phases the traced run marks
    phases = (("ceres_slam_tpu_torch.problems.dataset_phong", "run_batched_ransac"),
              ("ceres_slam_tpu_torch.solver.phong", "solve_tables"),
              ("ceres_slam_tpu_torch.solver.lm", "_copy_inputs"),
              ("ceres_slam_tpu_torch.solver.lm", "_node_solve"))

    def __init__(self, config: dict, mix: dict, seed: int, device: str):
        from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
        from ceres_slam_tpu_torch.solver import lm

        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        gen = load_module("generators", config["generator"])
        self.sims, self.pristine = [], []
        with tempfile.TemporaryDirectory() as tmp:
            for t in range(mix["trials"]):
                sim = gen.make(config["scene"], mix["trial_seed"] + t)
                path = os.path.join(tmp, f"trial{t}.csv")
                simcopy.write_phong_track_csv(sim, path)
                ds = DatasetProblemPhong.read_csv(path)
                ds.dtype, ds.device = config["dtype"], device
                self.sims.append(sim)
                self.pristine.append(ds)
        self.order = rng(seed, 2).permutation(len(self.pristine))
        s = config["solver"]
        self.solve_config = lm.SolveConfig(max_iters=s["max_iters"], ftol=s["ftol"])
        self.graph = lm.LMGraph() if device == "cuda" else None
        # (trial, stage of the run, use_light, freeze_geometry, vertex_valid, state0,
        #  state, summary)
        self.records: list = []
        self._trial = None
        self._stage = 0
        self._recording = False

    def _run(self, t: int):
        """One ``dataset_ba_phong --multistage`` run of trial ``t`` on a fresh
        copy (``solve_full``'s full-batch path on the kept graph); its
        stages' summaries."""
        from ceres_slam_tpu_torch.solver import phong

        ds = copy.deepcopy(self.pristine[t])
        self._trial, self._stage = t, 0
        ds.compute_initial_guess()
        ds.reset_points()
        K = ds.num_states
        ds.compute_initial_guess(0, K)
        problem, state, slots = ds.build_window_problem(0, K, *ds._window_budget(K))
        sol, summaries = phong.solve_phong_staged(
            problem, state, self.solve_config, use_light=True,
            directional=ds.directional_light, multistage=self.mix["multistage"],
            graph=self.graph)
        ds.absorb_window_solution(0, K, sol, slots)
        return summaries

    def _instrument(self):
        """Wrap ``phong.solve_phong_ba`` to keep every stage's start (a copy
        on the device: the host loop moves its start's tensors), result and
        summary, with no read."""
        from ceres_slam_tpu_torch.solver import lm, phong

        orig = phong.solve_phong_ba

        def solve(problem, state0, config, use_light=True, freeze_geometry=False, **kw):
            start = lm.tree_map(torch.clone, state0) if self._recording else None
            sol, summary = orig(problem, state0, config, use_light=use_light,
                                freeze_geometry=freeze_geometry, **kw)
            if self._recording:
                # a copy: a later restart of the stage's node writes its inputs here
                self.records.append((self._trial, self._stage, use_light, freeze_geometry,
                                     problem.vertex_valid.clone(), start, sol, summary))
            self._stage += 1
            return sol, summary

        phong.solve_phong_ba = solve
        self._unwrap = lambda: setattr(phong, "solve_phong_ba", orig)

    def warm(self):
        """Every trial once: every stage of every trial captured."""
        self._instrument()
        for t in self.order:
            self._run(int(t))
        self._recording = True

    def run_item(self, i: int) -> dict:
        """Every trial once, in the seed's order."""
        its, ok = 0, True
        for t in self.order:
            summaries = self._run(int(t))
            its += sum(s.iterations for s in summaries)
            ok = ok and all(np.isfinite(s.final_cost) for s in summaries)
        return {"solves": len(self.order), "iterations": its, "ok": ok}

    def release(self):
        def host(state):
            return ref.State(*(x.detach().double().cpu() for x in state))

        self.records = [(t, stage, use_light, frozen, valid.cpu(), host(s0), host(s1), summary)
                        for t, stage, use_light, frozen, valid, s0, s1, summary in self.records]
        self._recording = False
        self._unwrap()
        if self.graph is not None:
            self.graph.close()
            self.graph = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def _initial(self, t: int, dev):
        """The reference's initial guess of trial ``t``."""
        sim = self.sims[t]
        track = dict(K=sim.num_states, J=sim.points_gt.shape[0], M=sim.textures_gt.shape[0],
                     state_ids=sim.state_ids, vertex_ids=sim.vertex_ids,
                     material_ids=sim.material_ids, uvd=sim.uvd, ints=sim.intensities,
                     nobs=sim.normal_obs, T0=sim.poses_gt[0])
        r = self.config["ransac"]
        return vo_init.initial_guess(track, (sim.fu, sim.fv, sim.cu, sim.cv, sim.b),
                                     r["thresh"], r["iters"], r["rng_seed"], dev)

    def _problem(self, t: int, init: dict, dev):
        """The reference's problem of trial ``t``: its observations, the
        vertices they see in id order (the state's slots) and which of
        those the initial guess initialized."""
        sim = self.sims[t]
        slots, local = np.unique(sim.vertex_ids, return_inverse=True)

        def put(x):
            return torch.as_tensor(x, device=dev)

        fixed = torch.zeros(sim.num_states, dtype=torch.bool, device=dev)
        fixed[0] = True
        pb = ref.Problem((sim.fu, sim.fv, sim.cu, sim.cv, sim.b), put(sim.uvd),
                         put(sim.intensities), put(sim.normal_obs), put(sim.state_ids),
                         put(local), put(sim.material_ids), put(sim.stereo_var).sqrt(),
                         put(sim.normal_var).sqrt(), float(np.sqrt(sim.int_var)),
                         put(init["initialized"][sim.vertex_ids]), fixed)
        return pb, slots, put(init["initialized"][slots])

    def check(self) -> list:
        """``[name, worst value, limit]`` over every stage solve of the window."""
        limits = load_json("limits", f"{self.config['name']}.{self.mix['name']}")
        dev = "cuda" if self.device == "cuda" else "cpu"
        refs = {}
        worst = dict.fromkeys(limits, -np.inf)
        for t, stage, use_light, frozen, valid, s0, s1, summary in self.records:
            if t not in refs:
                init = self._initial(t, dev)
                refs[t] = (init, *self._problem(t, init, dev))
            init, pb, slots, ok = refs[t]
            a, b = _state(s0, slots.size, dev), _state(s1, slots.size, dev)
            got = {}
            if stage == 0:
                got["init_gap"] = _init_gap(a, init, ok, valid[:slots.size], slots)
            c0, c1 = ref.cost(pb, a, use_light), ref.cost(pb, b, use_light)
            got.update(start_cost_rel=abs(summary.initial_cost - c0) / c0,
                       cost_rel=abs(summary.final_cost - c1) / c1,
                       stage_drop_inv=c0 / (c0 - c1) if c1 < c0 else float("inf"))
            if not use_light:  # the geometry stage's objective is smooth
                got["geometry_grad_rel"] = (ref.projected_gradient_max(pb, b, use_light, frozen, ok)
                                            / ref.projected_gradient_max(pb, a, use_light, frozen, ok))
            for k, v in got.items():
                worst[k] = v if np.isnan(v) or np.isnan(worst[k]) else max(worst[k], v)
        # a number nothing in the window gave is not correct (NaN)
        return [[k, worst[k] if worst[k] > -np.inf else float("nan"), limits[k]] for k in limits]


def _state(s: ref.State, n: int, dev) -> ref.State:
    """A run's state without its padding vertices, on ``dev``."""
    return ref.State(s.poses.to(dev), s.points[:n].to(dev), s.normals[:n].to(dev),
                     s.phong.to(dev), s.textures.to(dev), s.light.to(dev))


def _init_gap(a: ref.State, init: dict, ok, valid, slots) -> float:
    """The largest difference between the start of a run's first stage and
    the reference's initial guess (poses, the initialized vertices'
    positions and normals, materials, textures); infinite where the two
    initialize different vertices."""
    if not bool((valid.to(ok.device) == ok).all()):
        return float("inf")
    dev = a.poses.device

    def gap(x, ref_x, rows=None):
        d = (x - torch.as_tensor(ref_x, device=dev)).abs()
        return float((d if rows is None else d[rows]).max())

    return max(gap(a.poses, init["poses"]), gap(a.points, init["points"][slots], ok),
               gap(a.normals, init["normals"][slots], ok), gap(a.phong, init["phong"]),
               gap(a.textures, init["textures"]))
