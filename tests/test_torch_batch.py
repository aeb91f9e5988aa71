"""Port parity: the batched independent chains (``problems/batch_scan.py``,
``apps/dataset_vo_sun_batch.py``) and the batched K1 factor pass.

The sims are those of tests/test_scan_pipeline.py's batch test (triangle,
16 states, 120 points, seed 0; square, 12 states, 90 points, seed 5), written
by the port's copy of the sim module (byte-identical to the JAX package's).
A batch mixes a VO and a sun run on the first dataset with a sun run on the
second (of another length, with a robust sun loss and gates), and is held
against each run's sequential pass in the port (``solve_sliding_window``)
and against JAX's ``batch_scan.solve_batch``. On the CPU K1 runs its plain
version; the batched CUDA kernel is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from ceres_slam_tpu.problems import batch_scan as jbatch
from ceres_slam_tpu.problems.dataset import DatasetProblemSun as JDatasetSun
from ceres_slam_tpu.solver.lm import SolveConfig as JSolveConfig
from ceres_slam_tpu_torch.apps import dataset_vo_sun_batch
from ceres_slam_tpu_torch.ops import window_kernel
from ceres_slam_tpu_torch.problems import batch_scan
from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
from ceres_slam_tpu_torch.solver import dense, dogleg, window
from ceres_slam_tpu_torch.solver.lm import SolveConfig
from ceres_slam_tpu_torch.utils import csvio, sim

torch.set_num_threads(1)

# the flagship CLI's float64 configuration (nonmonotonic, ftol = xtol = 1e-6)
CFG = dict(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
RUNS = [("a", dict(use_sun=False)), ("a", dict(use_sun=True)),
        ("b", dict(use_sun=True, huber_param=0.1, az_err_thresh=0.2, zen_err_thresh=0.2))]


def _write(ds, base):
    sim.write_track_csv(ds, base + ".csv", with_covar=True)
    sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
    sim.write_obs_sun_csv(ds, base + "_sun_dir.csv")
    return base


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("batch_sim"))
    noise = dict(stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    return {"a": _write(sim.generate(kind="triangle", num_states=16, num_points=120, seed=0,
                                     **noise), os.path.join(d, "t16")),
            "b": _write(sim.generate(kind="square", num_states=12, num_points=90, seed=5,
                                     **noise), os.path.join(d, "sq12"))}


def _load(base, dtype="float64", cls=DatasetProblemSun):
    ds = cls.read_csv(f"{base}.csv", f"{base}_sun_ref.csv", f"{base}_sun_dir.csv")
    ds.dtype = dtype
    if cls is DatasetProblemSun:
        ds.device = "cpu"  # the port's default is cuda
    return ds


def _batch(sims, strategy="dogleg", dtype="float64", runs=RUNS, cfg=CFG):
    """The port's batch of ``runs`` and each run's sequential pass on a
    fresh dataset; checks that the batch leaves its datasets untouched."""
    datasets = {k: _load(sims[k], dtype) for k in sims}
    before = {k: copy.deepcopy((d.poses, d.pose_covars, d.map_points, d.initialized_point))
              for k, d in datasets.items()}
    specs = [batch_scan.RunSpec(datasets[k], **kw) for k, kw in runs]
    results = batch_scan.solve_batch(specs, window=2, config=SolveConfig(**cfg),
                                     strategy=strategy)
    for k, d in datasets.items():
        for x, y in zip((d.poses, d.pose_covars, d.map_points, d.initialized_point), before[k]):
            np.testing.assert_array_equal(x, y)
    seq = []
    for k, kw in runs:
        ds = _load(sims[k], dtype)
        summaries = ds.solve_sliding_window(window=2, config=SolveConfig(**cfg),
                                            strategy=strategy, **kw)
        seq.append((ds.poses, ds.pose_covars, summaries))
    return results, seq


@pytest.fixture(scope="module")
def dogleg_batch(sims):
    return _batch(sims, "dogleg")


@pytest.mark.parametrize("strategy", ["dogleg", "lm"])
def test_batch_matches_sequential_passes(sims, dogleg_batch, strategy):
    """Each chain of a mixed batch (two datasets, VO and sun, per-chain sun
    settings) against its sequential pass: poses atol 1e-8, covariances
    atol 1e-10 (JAX's own batch bounds, tests/test_scan_pipeline.py), the
    same iterations in every window, the same windows solved (the square's
    first pair is RANSAC-degenerate), and the datasets untouched. The chains
    of the first dataset are padded to the batch's larger landmark count, so
    only rounding may separate them."""
    results, seq = dogleg_batch if strategy == "dogleg" else _batch(sims, strategy)
    for res, (poses, covs, summaries) in zip(results, seq):
        np.testing.assert_allclose(res.poses, poses, rtol=0, atol=1e-8)
        np.testing.assert_allclose(res.pose_covars, covs, rtol=0, atol=1e-10)
        assert [s.iterations for s in res.summaries] == [s.iterations for s in summaries]
        assert res.ok.size == poses.shape[0] - 1 and res.ok.sum() == len(summaries)
    assert not results[2].ok[0] and results[0].ok.all()


def test_batch_matches_jax(sims, dogleg_batch):
    """The port's batch against JAX's ``batch_scan.solve_batch`` on the same
    runs (JAX's device scan; the port follows the host per-window loop):
    poses atol 1e-5, covariances atol 1e-7 (JAX's own scan-against-host-loop
    bounds, tests/test_scan_pipeline.py), the same windows solved."""
    results, _ = dogleg_batch
    jds = {k: _load(sims[k], cls=JDatasetSun) for k in sims}
    ref = jbatch.solve_batch([jbatch.RunSpec(jds[k], **kw) for k, kw in RUNS], window=2,
                             config=JSolveConfig(**CFG), strategy="dogleg")
    for res, r in zip(results, ref):
        np.testing.assert_allclose(res.poses, r.poses, rtol=0, atol=1e-5)
        np.testing.assert_allclose(res.pose_covars, r.pose_covars, rtol=0, atol=1e-7)
        np.testing.assert_array_equal(res.ok, r.ok)
        assert len(res.summaries) == len(r.summaries)


def test_float32_batch(sims):
    """float32 chains (the factor pass in float32, the Schur solve in
    float64; the CLI's float32 tolerance 1e-5): each chain against its
    float32 sequential pass, to float32 rounding: poses atol 1e-4 (~20x the
    float32 spacing of these poses' entries, which reach ~10 m), covariances
    atol 1e-6 of their largest entry, the same windows solved."""
    results, seq = _batch(sims, dtype="float32", cfg={**CFG, "ftol": 1e-5, "xtol": 1e-5})
    for res, (poses, covs, summaries) in zip(results, seq):
        assert np.all(np.isfinite(res.poses))
        np.testing.assert_allclose(res.poses, poses, rtol=0, atol=1e-4)
        np.testing.assert_allclose(res.pose_covars, covs, rtol=0,
                                   atol=1e-6 * np.abs(covs).max())
        assert res.ok.sum() == len(res.summaries) == len(summaries)


def test_shared_padding_is_bit_equal(sims):
    """Runs of one dataset share its padding, so each chain of their batch
    equals its sequential pass bit for bit on the CPU (every step of the
    window algebra rounds the same with and without the batch axis): what
    lets the flagship CLI batch its two passes and still write the
    sequential passes' files."""
    runs = RUNS[:2]
    results, seq = _batch(sims, "dogleg", runs=runs)
    for res, (poses, covs, summaries) in zip(results, seq):
        np.testing.assert_array_equal(res.poses, poses)
        np.testing.assert_array_equal(res.pose_covars, covs)


def test_degenerate_window_in_a_batch(sims, tmp_path):
    """A chain whose frame 8 shares no feature with its neighbours
    (RANSAC-degenerate pairs (7, 8) and (8, 9)) sits those windows out of
    the batch and takes the sequential fallbacks (pose and covariance copied
    forward, so pose 8 stays pose 7), beside a chain that solves every
    window: both against their sequential passes, poses atol 1e-8."""
    ds = sim.generate(kind="triangle", num_states=16, num_points=120, seed=0,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    sel = ds.state_ids == 8
    ds.point_ids = ds.point_ids.copy()
    ds.point_ids[sel] = ds.point_ids.max() + 1 + np.arange(sel.sum())
    ds.points_gt = np.concatenate([ds.points_gt, np.zeros((int(sel.sum()), 3))])
    crippled = {"c": _write(ds, str(tmp_path / "c16")), "a": sims["a"]}
    runs = [("c", dict(use_sun=True)), ("a", dict(use_sun=True))]
    results, seq = _batch(crippled, runs=runs)
    (res_c, res_a), ((poses_c, _, summ_c), (poses_a, _, _)) = results, seq
    np.testing.assert_array_equal(np.nonzero(~res_c.ok)[0], [7, 8])
    assert res_a.ok.all() and len(res_c.summaries) == len(summ_c) == 13
    np.testing.assert_array_equal(res_c.poses[8], res_c.poses[7])
    np.testing.assert_allclose(res_c.poses, poses_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_a.poses, poses_a, rtol=0, atol=1e-8)


@pytest.mark.parametrize("shape", [(2, 96, 2), (5, 77, 3)], ids=["flagship", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_batched_k1_plain_matches_single(shape, dtype):
    """The batched K1 on the CPU (its plain version) equals the single-window
    plain version on each window bit for bit; no launch is counted; a call
    checks its poses and points, and the plan its arrays (windows of one
    shape)."""
    plan, poses, points, single = window_kernel.random_batch_inputs(3, *shape, dtype, seed=21)
    launches = window_kernel.window_factor_blocks_batch.launches
    out = window_kernel.window_factor_blocks_batch(plan, poses, points)
    assert window_kernel.window_factor_blocks_batch.launches == launches
    K, J, O = shape
    assert [tuple(x.shape) for x in out] == [(3, J, 9), (3, J * O, 18), (3, J, 3), (3, K, 43), (3,)]
    for b, args in enumerate(single):
        for x, y in zip(out, window_kernel.window_factor_blocks(*args)):
            assert torch.equal(x[b], y)
    starts = plan.pose_start.numpy()
    sizes = [int(p.pose_start[-1]) for p, _, _ in single]
    np.testing.assert_array_equal(starts[:, 0], np.cumsum([0] + sizes[:-1]))
    for bad, what in ((poses[:2], "shape"), (poses.to(torch.int32), "dtype"),
                      (poses.transpose(0, 1).contiguous().transpose(0, 1), "contiguous")):
        with pytest.raises(ValueError, match=what):
            window_kernel.window_factor_blocks_batch(plan, bad, points)
    arrays = window_kernel.batch_plan_arrays(
        [window_kernel.plan_arrays(K, J, p.pose_idx.numpy(), p.obs[:, :3], p.obs[:, 3:12],
                                   p.obs[:, 12], p.obs[:, 13]) for p, _, _ in single],
        J, plan.cameras, dtype)
    t = {k: torch.as_tensor(v) for k, v in arrays.items()}
    with pytest.raises(ValueError, match="do not fit"):
        window_kernel.bind_batch_plan(plan.cameras, K + 1, J, t)
    other, _, _ = window_kernel.random_inputs(K, J, O + 1, dtype, seed=3)
    with pytest.raises(ValueError, match="one shape"):
        window_kernel.batch_plan_arrays(
            [window_kernel.plan_arrays(K, J, p.pose_idx.numpy(), p.obs[:, :3], p.obs[:, 3:12],
                                       p.obs[:, 12], p.obs[:, 13]) for p in (single[0][0], other)],
            J, plan.cameras[:2], dtype)


def test_batch_algebra_equals_one_window(sims):
    """Three windows of two datasets as one ``BatchLayout`` (padded to the
    larger shape, tables offset per window): the K1 pass, the Schur step
    (damped and undamped), the covariance, the dogleg Hessian-vector
    product and the sun and prior terms of each window equal the same
    window solved alone at that shape (``windows_batch``) bit for bit."""
    dsa, dsb = _load(sims["a"]), _load(sims["b"])
    cases = [(dsa, 3, True), (dsb, 5, True), (dsa, 9, False)]
    J = max(d._window_budget(2)[1] for d in (dsa, dsb))
    O = max(d._window_budget(2)[2] for d in (dsa, dsb))
    hosts, singles, per = [], [], {}
    for ds, k1, use_sun in cases:
        ds.compute_initial_guess(k1, k1 + 2)
        problem, state, _ = ds.build_window_problem(
            k1, k1 + 2, 512, J, prior=ds._window_prior(k1),
            sun=ds._window_sun(k1, k1 + 2) if use_sun else None, gauge_fix_first=False)
        hosts.append(window.window_host(problem, 2, J, O))
        singles.append(window.windows_batch([(problem, state)], O))
        p = dense.aux_terms(problem)
        for name, x in (("poses", state.poses), ("points", state.points),
                        ("sun_dir_c", p.sun.dir_c), ("sun_dir_g", p.sun.dir_g),
                        ("sun_stiffness", p.sun.stiffness), ("sun_valid", p.sun.valid),
                        ("prior_T_ref", p.prior.T_ref), ("prior_stiffness", p.prior.stiffness),
                        ("prior_valid", p.prior.valid), ("sun_huber", p.sun_huber),
                        ("az_err_thresh", p.az_err_thresh), ("zen_err_thresh", p.zen_err_thresh)):
            per.setdefault(name, []).append(x.numpy())
        ds.reset_points()
    layout, state = window.build_batch_layout(hosts, {k: np.stack(v) for k, v in per.items()},
                                              torch.float64, "cpu")

    def steps(lay, st):
        b, cost = window.total_blocks(lay, st)
        Hpp_aux, gp_aux = window._masked_aux_blocks(lay.terms, st, torch.float64)
        Hpp, gp = b.Hpp + Hpp_aux, b.gp + gp_aux
        out = [cost, Hpp_aux, gp_aux]
        for lam in (1e-4, 0.0):
            out += window.schur_solve(Hpp, b.Hll, b.U_jo, gp, b.gl, lay.w_idx, lam)
        out.append(window.pose_marginal_covariance(Hpp, b.Hll, b.U_jo, lay.w_idx, 1))
        v = torch.cat([gp.flatten(-2), b.gl.flatten(-2)], dim=-1)
        out.append(dogleg.block_hvp(window._pin(Hpp), window._pin(b.Hll), b.U_jo,
                                    lay.slot_pose, lay.pose_slots, v))
        return out

    batched = steps(layout, state)
    for i, (lay, st) in enumerate(singles):
        for x, y in zip(batched, steps(lay, st)):
            assert torch.equal(x[i], y[0])


def test_grid_cli(sims, tmp_path):
    """``dataset_vo_sun_batch --sims`` on one small sequence with two sun
    files: the VO run and a run per sun file, their files written under the
    sequential harness's names, the poses those of ``solve_batch`` on the
    same runs (bit for bit: the same code on the same data), and
    ``--sequential`` writing the same bytes (its runs share the batch's
    padding: one track). The square's first pair is RANSAC-degenerate."""
    d = str(tmp_path)
    truth = sim.generate(kind="square", num_states=12, num_points=90, seed=5,
                         stereo_noise=(0.3, 0.3, 0.3))
    sim.write_track_csv(truth, os.path.join(d, "square12.csv"), with_covar=True)
    sim.write_ref_sun_csv(truth, os.path.join(d, "square12_sun_ref.csv"))
    for n in (0, 10):
        noisy = sim.generate(kind="square", num_states=12, num_points=90, seed=5,
                             stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=float(n))
        sim.write_obs_sun_csv(noisy, os.path.join(d, f"square12_sun_dir_gtsun{n}.csv"))
    argv = ["--sims", d, "--num-states", "12", "--sequences", "square", "--device", "cpu"]
    stats = dataset_vo_sun_batch.main(argv)
    names = ["square12_poses.csv", "square12_gtsun0_poses.csv", "square12_gtsun10_poses.csv"]
    assert [os.path.basename(r["output"]) for r in stats["runs"]] == names
    assert stats["windows"] == 30 and all(r["windows"] == 10 for r in stats["runs"])
    assert all(r["iterations_by_window"][0] == 0 for r in stats["runs"])
    written = {n: open(os.path.join(d, n), "rb").read() for n in names}
    base = os.path.join(d, "square12")
    ds = {n: DatasetProblemSun.read_csv(base + ".csv", base + "_sun_ref.csv",
                                        f"{base}_sun_dir_gtsun{n}.csv") for n in (0, 10)}
    for x in ds.values():
        x.device = "cpu"
    runs = [batch_scan.RunSpec(ds[0]), batch_scan.RunSpec(ds[0], use_sun=True),
            batch_scan.RunSpec(ds[10], use_sun=True)]
    for res, n in zip(batch_scan.solve_batch(runs, config=SolveConfig(**CFG)), names):
        np.testing.assert_array_equal(csvio.read_poses_csv(os.path.join(d, n)), res.poses)
    dataset_vo_sun_batch.main(argv + ["--sequential"])
    for n in names:
        assert open(os.path.join(d, n), "rb").read() == written[n], n


def test_batch_entry_points_check_their_runs(sims):
    """``solve_batch`` refuses runs of mixed dtypes and a window of fewer
    than 2 poses; the CLI refuses ``--device cuda`` without a card."""
    a, b = _load(sims["a"]), _load(sims["b"], "float32")
    with pytest.raises(ValueError, match="dtype"):
        batch_scan.solve_batch([batch_scan.RunSpec(a), batch_scan.RunSpec(b)])
    with pytest.raises(ValueError, match="at least 2"):
        batch_scan.solve_batch([batch_scan.RunSpec(a)], window=1)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            dataset_vo_sun_batch.main(["--run", f"{sims['a']}.csv,{sims['a']}_sun_ref.csv,"
                                       f"{sims['a']}_sun_dir.csv,vo"])


def _record_jax_grid(d):
    """The JAX package's float64 ATEs [m] of the 15-run 200-state grid
    (``dataset_vo_sun_batch --sims``, window 2, on a CPU), which
    chip_smoke.py holds the card to; the sims are the port's ``make_sim``
    output (byte-identical to the JAX package's)."""
    import json

    from ceres_slam_tpu.apps import dataset_vo_sun_batch as japp
    from ceres_slam_tpu_torch.apps import make_sim
    from ceres_slam_tpu_torch.utils import metrics

    for seq in ("triangle", "square", "penta"):
        make_sim.main([d, "--kind", seq, "--num-states", "200", "--sun-noise", "0", "10", "20",
                       "30"])
    japp.main(["--sims", d, "--platform", "cpu"])
    out = {}
    for seq in ("triangle", "square", "penta"):
        base = os.path.join(d, f"{seq}200")
        gt = csvio.read_poses_csv(base + "_gt_poses.csv")
        out[f"{seq}200"] = {"vo": metrics.ate_translation(csvio.read_poses_csv(
            base + "_poses.csv"), gt)}
        for n in (0, 10, 20, 30):
            out[f"{seq}200"][f"gtsun{n}"] = metrics.ate_translation(
                csvio.read_poses_csv(f"{base}_gtsun{n}_poses.csv"), gt)
    print(json.dumps(out))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_batch.py DIR
    import sys

    jax.config.update("jax_enable_x64", True)
    _record_jax_grid(sys.argv[1])
