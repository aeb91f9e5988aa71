"""Independent sliding-window chains solved together on one device.

Port of ``ceres_slam_tpu/problems/batch_scan.py``. The windows of one
sequence are serialized by the covariance-prior chain, so one chain leaves
the device mostly idle; but harness runs are independent: ``ba_all_sims``
is 3 sequences x {VO-only + 4 sun configurations} = 15 chains, and the
flagship's two passes are two. The JAX module pads every run's statics to
common shapes and vmaps its device scan over the runs. The port has no
scan (its pass is the host per-window loop, ``DatasetProblemSun.
solve_sliding_window``), so its batch is B chains in lockstep: step w
solves window w of every chain that still has one as one batch
(``solver/window.BatchLayout``): one K1 launch a trust-region iteration
serves that window of every chain, the small algebra carries a leading
batch axis, and each chain keeps its own trust-region control in the
loop's carry. On the card a step is one graph launch: the loop runs in a
WHILE node (``window.WindowGraph``, captured once per batch shape and
held by the pass), and the host reads the step's poses, landmarks,
covariances and summaries once, after it. A chain whose window is
RANSAC-degenerate, or that has no window left, sits the step out; a step
with fewer windows takes another capture, not fake windows.

Every run works on its own copy of the mutable state (poses, covariances,
landmarks), so runs may share one loaded dataset (and its RANSAC
precompute) and the datasets are left as they were; results come back as
``BatchResult``. A window's layout and K1 plan depend on its structure
alone, so they are built once per dataset and window (at the step that
solves it), padded to the batch's shape (landmarks, slots per landmark and
the gather tables' widths, fixed for the pass); a step then costs a
concatenation and one host-to-device copy. One chain's results in a batch equal its sequential pass's to the
rounding of the padding: with the same padding (runs of one dataset, as
the flagship's two passes), bit for bit on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver import window as window_mod
from ceres_slam_tpu_torch.utils import se3np


class RunSpec(NamedTuple):
    """One independent chain: a dataset plus its pass configuration."""

    ds: object  # DatasetProblemSun
    use_sun: bool = False
    huber_param: float = 0.0
    az_err_thresh: float = 1000.0  # radians
    zen_err_thresh: float = 1000.0  # radians


class BatchResult(NamedTuple):
    poses: np.ndarray  # [K, 12]
    pose_covars: np.ndarray  # [K, 6, 6]
    summaries: list  # per solved window (RANSAC-degenerate windows dropped)
    ok: np.ndarray  # [W] bool: window solved (False: RANSAC degenerate, pose copied forward)


class _Chain:
    """One run's pass: a private copy of the dataset's mutable state (the
    rest, RANSAC included, is shared with the dataset)."""

    def __init__(self, run: RunSpec, window: int):
        self.run, self.ds = run, run.ds.pass_copy()
        self.num_windows = max(0, self.ds.num_states - window + 1)
        self.summaries, self.ok = [], []


class BatchSolve:
    """The lockstep passes of ``runs``, one step (window index) at a time:
    ``step(k1)`` for ``k1`` in ``range(num_steps)``, then ``results()``.
    All runs share the solver dtype, the covariance floor and the device."""

    def __init__(self, runs: list, window: int = 2, config: lm.SolveConfig | None = None,
                 strategy: str = "dogleg", loop: str | None = None):
        if not runs:
            raise ValueError("solve_batch needs at least one run")
        if window < 2:
            raise ValueError(f"the window holds at least 2 poses, got {window}")
        for what, key in (("dtype", lambda r: r.ds.dtype),
                          ("covariance floor", lambda r: float(r.ds._covar_floor)),
                          ("device", lambda r: str(r.ds._device))):
            values = {key(r) for r in runs}
            if len(values) != 1:
                raise ValueError(f"the runs of a batch must share one {what}, got {values}")
        self.window, self.strategy = window, strategy
        self.config = config or lm.SolveConfig(max_iters=100)
        first = runs[0].ds
        self.dtype, self.device, self.floor = first._dt, first._device, first._covar_floor
        datasets = {id(r.ds): r.ds for r in runs}
        budgets, widths = [], []
        for ds in datasets.values():
            ds.precompute_pair_alignments()  # shared by the runs of the dataset
            budgets.append(ds._window_budget(window))
            widths.append(ds._table_widths(window))
        self.n_obs_pad, self.J, self.O = (max(b[i] for b in budgets) for i in range(3))
        self.widths = tuple(max(w[i] for w in widths) for i in range(2))
        self.chains = [_Chain(r, window) for r in runs]
        self.num_steps = max(c.num_windows for c in self.chains)
        # ``loop``: window.run_loop's; on the card the pass holds its captures
        self.loop = loop
        on_card = torch.device(self.device).type == "cuda" and loop in (None, "device")
        self.graph = window_mod.WindowGraph() if on_card else None

    def _hosts(self, chains: list, k1: int) -> list:
        """``(WindowHost, the window's landmark ids)`` of window ``k1`` of each
        chain, built once per dataset (its runs share the window's structure)."""
        hosts = {}
        for c in chains:
            if id(c.run.ds) not in hosts:
                problem, _, slots = c.ds.build_window_problem(
                    k1, k1 + self.window, self.n_obs_pad, self.J, gauge_fix_first=False,
                    device="cpu")
                hosts[id(c.run.ds)] = (
                    window_mod.window_host(problem, self.window, self.J, self.O, self.widths),
                    slots)
        return [hosts[id(c.run.ds)] for c in chains]

    def _per_window(self, chains: list, slots: list, k1: int) -> dict:
        """The chains' state and sun and prior terms at window ``k1`` (host)."""
        k2, K, B = k1 + self.window, self.window, len(chains)
        points = np.zeros((B, self.J, 3))
        sun_dir_c, sun_dir_g = np.zeros((B, K, 3)), np.zeros((B, K, 3))
        sun_stiffness = np.broadcast_to(np.eye(2), (B, K, 2, 2)).copy()
        sun_valid = np.zeros((B, K), bool)
        for i, (c, s) in enumerate(zip(chains, slots)):
            ds = c.ds
            points[i, : s.size] = ds.map_points[s]
            if c.run.use_sun:
                sun_dir_c[i], sun_dir_g[i] = ds.sun_obs_list[k1:k2], ds.sun_dir_g[k1:k2]
                sun_stiffness[i] = ds._sun_stiffness_all[k1:k2]
                sun_valid[i] = ds.state_has_sun_obs[k1:k2]
        eye6 = self.floor * np.eye(6)
        return {
            "poses": np.stack([c.ds.poses[k1:k2] for c in chains]),
            "points": points,
            "sun_dir_c": sun_dir_c, "sun_dir_g": sun_dir_g, "sun_stiffness": sun_stiffness,
            "sun_valid": sun_valid,
            "prior_T_ref": np.stack([c.ds.poses[k1] for c in chains]),
            "prior_stiffness": np.stack([se3np.inv_sqrt_psd(c.ds.pose_covars[k1] + eye6)
                                         for c in chains]),
            "prior_valid": np.ones(B, bool),
            "sun_huber": np.asarray([c.run.huber_param if c.run.use_sun else 0.0
                                     for c in chains]),
            "az_err_thresh": np.asarray([c.run.az_err_thresh for c in chains]),
            "zen_err_thresh": np.asarray([c.run.zen_err_thresh for c in chains]),
        }

    def step(self, k1: int) -> int:
        """Window ``k1`` of every chain that has one: the VO initial guess,
        then the windows solved together (the RANSAC-degenerate ones take the
        sequential pass's fallback), their covariance of pose 1 the next
        prior. Returns the number of windows solved."""
        k2, K, J = k1 + self.window, self.window, self.J
        solve = []
        for c in self.chains:
            if k1 >= c.num_windows:
                continue
            if c.ds.compute_initial_guess(k1, k2):
                solve.append(c)
                continue
            c.ds.poses[k2 - 1] = c.ds.poses[k1]  # RANSAC degeneracy fallback
            c.ds.pose_covars[k2 - 1] = c.ds.pose_covars[k1]
            c.ok.append(False)
            c.ds.reset_points()
        if not solve:
            return 0
        hosts = self._hosts(solve, k1)
        layout, state = window_mod.build_batch_layout(
            [h for h, _ in hosts], self._per_window(solve, [s for _, s in hosts], k1),
            self.dtype, self.device)
        sol, stats, cov = window_mod.solve_batch_with_covariance(
            layout, state, 1, self.config, self.strategy, self.loop, self.graph)
        f64 = torch.float64
        out = torch.cat([sol.poses.flatten(1).to(f64), sol.points.flatten(1).to(f64),
                         cov.flatten(1).to(f64), stats], dim=1).cpu().numpy()  # the one read
        n = K * 12 + J * 3 + 36
        summaries = window_mod.summaries(out[:, n:], self.config)
        for c, (_, slots), row, summary in zip(solve, hosts, out, summaries):
            ds = c.ds
            ds.poses[k1:k2] = row[: K * 12].reshape(K, 12)
            pts = row[K * 12: K * 12 + J * 3].reshape(J, 3)[: slots.size]
            upd = ds.initialized_point[slots]
            ds.map_points[slots[upd]] = pts[upd]
            cv = row[K * 12 + J * 3: n].reshape(6, 6)
            # covariance failure fallback: the previous window's
            ds.pose_covars[k1 + 1] = cv if np.all(np.isfinite(cv)) else ds.pose_covars[k1]
            c.summaries.append(summary)
            c.ok.append(True)
            ds.reset_points()
        return len(solve)

    def results(self) -> list:
        return [BatchResult(c.ds.poses, c.ds.pose_covars, c.summaries, np.asarray(c.ok, bool))
                for c in self.chains]

    def close(self) -> None:
        """Free the pass's captured loops."""
        if self.graph is not None:
            self.graph.close()


def solve_batch(runs: list, window: int = 2, config: lm.SolveConfig | None = None,
                strategy: str = "dogleg", progress: bool = False,
                loop: str | None = None) -> list:
    """Solve every run's sliding-window pass, the runs' windows together
    (``BatchSolve``; ``loop``: ``window.run_loop``'s); one ``BatchResult``
    per run, the datasets untouched. Runs of different lengths mix: a chain
    that has run out of windows sits the remaining steps out."""
    solver = BatchSolve(runs, window, config, strategy, loop)
    if progress:
        print(f"  batch: {len(runs)} runs, {solver.num_steps} steps, windows padded to "
              f"J={solver.J}, O={solver.O}", flush=True)
    try:
        for k1 in range(solver.num_steps):
            n = solver.step(k1)
            if progress and k1 % 50 == 0:
                print(f"  step {k1}: {n} windows solved together", flush=True)
    finally:
        solver.close()
    return solver.results()
