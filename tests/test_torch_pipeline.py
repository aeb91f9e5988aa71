"""Port parity: the whole sun-aided sliding-window slice, the flagship CLI,
the copied host utilities, and the port's independence from JAX.

The slice runs on the 24-state sim of tests/test_pipeline.py: both passes
of ``DatasetProblemSun.solve_sliding_window`` in the port and in the JAX
package's host per-window loop, with the JAX package's own RANSAC
hypotheses injected into the port.
"""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import common as jcommon
from ceres_slam_tpu.problems.dataset import DatasetProblemSun as JDatasetSun
from ceres_slam_tpu.solver.lm import SolveConfig as JSolveConfig
from ceres_slam_tpu.utils import csvio as jcsvio
from ceres_slam_tpu.utils import sim as jsim
from ceres_slam_tpu_torch.apps import dataset_vo_sun
from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
from ceres_slam_tpu_torch.solver.lm import SolveConfig
from ceres_slam_tpu_torch.utils import csvio, metrics, sim

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flagship CLI's float64 configuration (dataset_vo_sun: nonmonotonic
# dogleg, ftol = xtol = 1e-6), plus a robust sun loss and gates that bite
PASS_ARGS = [dict(use_sun=False),
             dict(use_sun=True, huber_param=0.1, az_err_thresh=0.2, zen_err_thresh=0.2)]
CFG = dict(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)


@pytest.fixture(scope="module")
def sim_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    files = dict(track=str(d / "tri.csv"), ref_sun=str(d / "tri_sun_ref.csv"),
                 obs_sun=str(d / "tri_sun_dir_gtsun5.csv"), gt=str(d / "tri_gt_poses.csv"))
    sim.write_track_csv(ds, files["track"], with_covar=True)
    sim.write_ref_sun_csv(ds, files["ref_sun"])
    sim.write_obs_sun_csv(ds, files["obs_sun"])
    sim.write_gt_poses_csv(ds, files["gt"])
    return files, ds


def _read(cls, f):
    p = cls.read_csv(f["track"], f["ref_sun"], f["obs_sun"])
    if cls is DatasetProblemSun:
        p.device = "cpu"  # the port's default is cuda
    return p


def _jax_hypotheses(jprob) -> np.ndarray:
    """The JAX package's per-pair draw: Gumbel top-3 under PRNGKey(seed + k)."""
    P, H = jprob._match_pad, jprob.ransac_iters
    out = np.zeros((jprob.num_states, H, 3), np.int64)
    for k in range(jprob.num_states):
        valid = np.zeros(P, bool)
        if k:
            valid[: jprob._pair_match(k)[0].size] = True
        scores = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)[None, :] + jax.random.gumbel(
            jax.random.PRNGKey(jprob.rng_seed + k), (H, P), dtype=jnp.float32).astype(jnp.float64)
        cols = jax.lax.broadcasted_iota(jnp.int32, (H, P), 1)
        for c in range(3):
            i = jnp.argmax(scores, axis=-1)
            out[k, :, c] = np.asarray(i)
            scores = jnp.where(cols == i[:, None], -jnp.inf, scores)
    return out


@pytest.fixture(scope="module")
def slice_runs(sim_files):
    """Both passes in both packages, sequentially on one dataset object
    each (as the flagship app runs them); snapshots after every pass."""
    f, _ = sim_files
    jprob, tprob = _read(JDatasetSun, f), _read(DatasetProblemSun, f)
    hyp = _jax_hypotheses(jprob)
    _, _, valid = tprob.pair_points()
    drawn = tprob.draw_hypotheses(valid).numpy()
    tprob.precompute_pair_alignments(hyp_idx=torch.as_tensor(hyp))
    snaps = []
    for kw in PASS_ARGS:
        sj = jprob.solve_sliding_window(window=2, config=JSolveConfig(**CFG), scan=False, **kw)
        st = tprob.solve_sliding_window(window=2, config=SolveConfig(**CFG), **kw)
        snaps.append(dict(jax=(jprob.poses.copy(), jprob.pose_covars.copy(), sj),
                          port=(tprob.poses.copy(), tprob.pose_covars.copy(), st)))
    return snaps, hyp, drawn


def test_port_draws_jax_hypotheses(slice_runs):
    _, hyp, drawn = slice_runs
    np.testing.assert_array_equal(drawn[1:], hyp[1:])  # pair 0 is unused


@pytest.mark.parametrize("pass_idx", [0, 1], ids=["vo", "sun"])
def test_slice_matches_jax(slice_runs, pass_idx):
    """Poses atol 1e-6 (the chain compounds float64 rounding over 23
    windows; both take the same accept/reject decisions) and each window's
    6x6 covariance rtol 1e-4 of its largest entry (a 1e-12-floored prior
    chain: the covariances span ~10 orders of magnitude)."""
    snap = slice_runs[0][pass_idx]
    (pj, cj, sj), (pt, ct, st) = snap["jax"], snap["port"]
    assert len(st) == len(sj) == pj.shape[0] - 1
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    for k in range(cj.shape[0]):
        np.testing.assert_allclose(ct[k], cj[k], rtol=0, atol=1e-4 * np.abs(cj[k]).max())
    assert np.trace(ct[10]) > np.trace(ct[1])  # the prior chain propagated


def test_slice_accuracy(slice_runs, sim_files):
    _, ds = sim_files
    for snap in slice_runs[0]:
        assert metrics.ate_translation(snap["port"][0], ds.poses_gt) < 0.3


def test_float32_slice(sim_files):
    """float32 factor pass (K1 in float), float64 Schur chain: the VO+sun
    pass lands within 5 mm ATE of the float64 pass on this sim."""
    f, ds = sim_files
    ate = {}
    for dt in ("float64", "float32"):
        p = _read(DatasetProblemSun, f)
        p.dtype = dt
        p.solve_sliding_window(window=2, config=SolveConfig(**CFG), **PASS_ARGS[1])
        assert np.all(np.isfinite(p.poses))
        ate[dt] = metrics.ate_translation(p.poses, ds.poses_gt)
    assert abs(ate["float32"] - ate["float64"]) < 5e-3, ate


def test_ransac_failure_fallback(sim_files, tmp_path):
    """A frame with no common features copies pose and covariance forward."""
    _, ds = sim_files
    ds = copy.deepcopy(ds)
    sel = ds.state_ids == 12
    ds.point_ids = ds.point_ids.copy()
    ds.point_ids[sel] = ds.point_ids.max() + 1 + np.arange(sel.sum())
    ds.points_gt = np.concatenate([ds.points_gt, np.zeros((int(sel.sum()), 3))])
    f = dict(track=str(tmp_path / "c.csv"), ref_sun=str(tmp_path / "r.csv"),
             obs_sun=str(tmp_path / "o.csv"))
    sim.write_track_csv(ds, f["track"], with_covar=True)
    sim.write_ref_sun_csv(ds, f["ref_sun"])
    sim.write_obs_sun_csv(ds, f["obs_sun"])
    p = _read(DatasetProblemSun, f)
    summaries = p.solve_sliding_window(window=2)
    assert len(summaries) == p.num_states - 1 - 2  # windows [11,13) and [12,14) fall back
    assert np.all(np.isfinite(p.poses)) and np.all(np.isfinite(p.pose_covars))
    np.testing.assert_array_equal(p.poses[12], p.poses[11])


def test_cli_writes_both_passes(sim_files):
    f, ds = sim_files
    stats = dataset_vo_sun.main([f["track"], f["ref_sun"], f["obs_sun"], "--device", "cpu",
                                 "--report", "brief"])
    base = f["track"][:-4]
    assert stats["passes"]["vo"]["output"] == base + "_poses.csv"
    assert stats["passes"]["sun"]["output"] == base + "_gtsun5_poses.csv"
    for p in stats["passes"].values():
        poses = csvio.read_poses_csv(p["output"])
        assert poses.shape == (24, 12) and np.all(np.isfinite(poses))
        assert p["windows"] == 23 and p["iterations"] >= 23
        assert metrics.ate_translation(poses, ds.poses_gt) < 0.3


def test_dataset_sun_defaults_to_cuda(sim_files):
    """``DatasetProblemSun`` inherits the ``cuda`` default and raises at its
    first device step without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    f, _ = sim_files
    p = DatasetProblemSun.read_csv(f["track"], f["ref_sun"], f["obs_sun"])
    assert p.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.solve_sliding_window(window=2)


def test_cli_cuda_without_card_fails(sim_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    f, _ = sim_files
    with pytest.raises(SystemExit, match="no CUDA device"):
        dataset_vo_sun.main([f["track"], f["ref_sun"], f["obs_sun"]])


def test_ftol_zero_is_a_tolerance():
    """F5: ``--ftol 0`` means a tolerance of 0. (The JAX app reads
    ``args.ftol if args.ftol`` and falls back to the default.)"""
    args = dataset_vo_sun.build_parser().parse_args(["t", "r", "o", "--ftol", "0"])
    cfg = dataset_vo_sun.solve_config(args, 199)
    assert cfg.ftol == 0.0 and cfg.xtol == 0.0
    args = dataset_vo_sun.build_parser().parse_args(["t", "r", "o"])
    assert dataset_vo_sun.solve_config(args, 199).ftol == 1e-6


def test_float32_tolerance_counts_windows():
    """F5: the float32 tolerance is chosen by the pass's window count. 257
    states at --window 2 are 256 windows -> 1e-5; the JAX app passes the
    state count (257) and picks 1e-7."""
    args = dataset_vo_sun.build_parser().parse_args(["t", "r", "o", "--dtype", "float32"])
    assert dataset_vo_sun.solve_config(args, 257 - 2 + 1).ftol == 1e-5
    assert dataset_vo_sun.solve_config(args, 258 - 2 + 1).ftol == 1e-7
    assert jcommon.solver_tolerance("float32", 257) == 1e-7  # the JAX divergence


@pytest.mark.parametrize("kind", ["triangle", "kitti", "phong", "phong_directional"])
def test_copied_sim_writes_identical_csvs(tmp_path, kind):
    """The port's copies of sim/csvio write byte-identical files (the Phong
    generator with a point light and with a directional one)."""
    def gen(mod, noise):
        if kind == "kitti":
            return mod.generate_kitti(num_states=60, num_points=900, seed=2, sun_noise_deg=noise)
        return mod.generate(kind=kind, num_states=30, num_points=200, seed=2, sun_noise_deg=noise)

    for name, mod, io in (("jax", jsim, jcsvio), ("port", sim, csvio)):
        d = tmp_path / name
        d.mkdir()
        if kind.startswith("phong"):
            ds = mod.generate_phong(num_states=30, num_points=200, num_materials=4, seed=2,
                                    directional=kind == "phong_directional")
            mod.write_phong_track_csv(ds, str(d / "phong.csv"))
            mod.write_gt_poses_csv(ds, str(d / "gt.csv"))
            continue
        ds, dn = gen(mod, 0.0), gen(mod, 10.0)
        mod.write_track_csv(ds, str(d / "t.csv"), with_covar=True)
        mod.write_track_csv(ds, str(d / "t_vo.csv"), with_covar=False)
        mod.write_ref_sun_csv(ds, str(d / "sun_ref.csv"))
        mod.write_obs_sun_csv(dn, str(d / "sun_obs.csv"))
        mod.write_gt_poses_csv(ds, str(d / "gt.csv"))
        io.write_poses_csv(str(d / "poses.csv"), ds.poses_gt[::-1])
    for fname in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "jax" / fname).read_bytes() == (tmp_path / "port" / fname).read_bytes(), fname
    track = "phong.csv" if kind.startswith("phong") else "t.csv"
    rows = csvio.read_numeric_csv(str(tmp_path / "port" / track))
    ref = jcsvio.read_numeric_csv(str(tmp_path / "jax" / track))
    assert len(rows) == len(ref) and all(np.array_equal(a, b) for a, b in zip(rows, ref))


def test_copied_checkpoint_module_is_byte_identical():
    """utils/checkpoint.py is numpy-only and copied from the JAX package byte for byte."""
    from ceres_slam_tpu.utils import checkpoint as jcheckpoint
    from ceres_slam_tpu_torch.utils import checkpoint

    with open(checkpoint.__file__, "rb") as a, open(jcheckpoint.__file__, "rb") as b:
        assert a.read() == b.read()


def test_csv_reader_rejects_non_numeric(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2\n3,x4\n")
    with pytest.raises(ValueError, match="bad.csv:2"):
        csvio.read_numeric_csv(str(path))


def test_port_imports_without_jax():
    """Every module of the port imports, and the CLI's --help runs, in a
    process where importing jax or ceres_slam_tpu fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceres_slam_tpu'] = None\n"
        "import ceres_slam_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ceres_slam_tpu_torch.apps import dataset_vo_sun\n"
        "dataset_vo_sun.main(['--help'])\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "sun-aided sliding-window" in out.stdout
