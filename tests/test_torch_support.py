"""Port parity: the support utilities — NaN debugging, the profiler trace,
checkpoint-resume of the flagship pass and the CLI's ``--checkpoint``.

The pass runs on the 24-state sim of tests/test_pipeline.py, on the CPU;
checkpoint-resume must give the uninterrupted pass's poses and covariance
chain bit for bit (the CPU sums in a fixed order).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.utils import checkpoint as jckpt
from ceres_slam_tpu.utils import debug as jdebug
from ceres_slam_tpu_torch.apps import dataset_vo_sun
from ceres_slam_tpu_torch.problems.dataset import DatasetProblemSun
from ceres_slam_tpu_torch.solver import dense
from ceres_slam_tpu_torch.solver import window as window_mod
from ceres_slam_tpu_torch.solver.lm import SolveConfig
from ceres_slam_tpu_torch.utils import checkpoint, csvio, debug, sim, telemetry

torch.set_num_threads(1)

CFG = SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)


# -- debugging ------------------------------------------------------------------


def test_assert_finite_names_the_leaf():
    """Passes on finite nests (integer leaves skipped); raises on a NaN or
    Inf naming the leaf's path, as JAX's does on the same values."""
    state = dense.BAState(poses=torch.zeros(2, 12), points=torch.ones(3, 3))
    debug.assert_finite({"s": state, "ids": torch.arange(3), "a": np.ones(2)}, "state")
    bad = state._replace(points=torch.tensor([[1.0, float("nan"), 0.0]] * 3))
    with pytest.raises(FloatingPointError, match=r"state/s/points: 3/9"):
        debug.assert_finite({"s": bad}, "state")
    with pytest.raises(FloatingPointError, match=r"x/1: 1/2"):
        debug.assert_finite([np.ones(2), np.array([1.0, np.inf])], "x")
    with pytest.raises(FloatingPointError):
        jdebug.assert_finite({"a": jnp.array([1.0, jnp.nan])}, "state")


def test_debug_finite_warns_and_passes_through(capsys):
    x = torch.tensor([1.0, float("inf"), float("nan")])
    assert debug.debug_finite(x, "x") is x
    assert "2 non-finite entries in x" in capsys.readouterr().out
    y = torch.tensor([1.0, 2.0])
    assert debug.debug_finite(y, "y") is y
    assert capsys.readouterr().out == ""


def test_enable_nan_debugging_raises_at_the_op():
    """With the check on, the first operation that writes a NaN raises and
    names itself (a division 0/0 after finite ops, and a NaN made inside
    the backward pass); an Inf does not raise (jax_debug_nans checks NaN);
    with the check off, NaNs flow again."""
    a = torch.tensor([0.0, 1.0], requires_grad=True)
    debug.enable_nan_debugging()
    try:
        b = a * 2.0 + 1.0
        _ = torch.tensor([1.0]) / torch.tensor([0.0])  # inf: no error
        with pytest.raises(FloatingPointError, match="aten.div"):
            _ = (b - b) / (b - b)
        with pytest.raises(FloatingPointError, match="aten.mul"):
            torch.sqrt(a * a).sum().backward()  # at a = 0: inf (d sqrt) times 0 (d a^2 / da)
    finally:
        debug.enable_nan_debugging(False)
    assert torch.isnan(torch.tensor([0.0]) / torch.tensor([0.0])).all()


def test_trace_writes_a_chrome_trace(tmp_path):
    with telemetry.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert d == str(tmp_path / "tr") and any("mm" in e.get("name", "") for e in events)


# -- checkpoint-resume ------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    ds = sim.generate(kind="triangle", num_states=24, num_points=200, seed=3,
                      stereo_noise=(0.3, 0.3, 0.3), sun_noise_deg=5.0)
    files = [str(d / "tri.csv"), str(d / "tri_sun_ref.csv"), str(d / "tri_sun_dir_gtsun5.csv")]
    sim.write_track_csv(ds, files[0], with_covar=True)
    sim.write_ref_sun_csv(ds, files[1])
    sim.write_obs_sun_csv(ds, files[2])
    return files


def _dataset(files):
    ds = DatasetProblemSun.read_csv(*files)
    ds.device = "cpu"
    return ds


@pytest.fixture(scope="module")
def uninterrupted(sim_files):
    ds = _dataset(sim_files)
    summaries = ds.solve_sliding_window(window=2, use_sun=True, config=CFG)
    return ds.poses.copy(), ds.pose_covars.copy(), len(summaries)


class _Interrupt(Exception):
    pass


def test_resume_equals_uninterrupted(sim_files, uninterrupted, tmp_path, monkeypatch):
    """A pass interrupted in window 13 with a checkpoint every 5 windows,
    then resumed by a fresh dataset object from window 10: the poses and
    the covariance chain equal the uninterrupted pass's bit for bit, and
    the file is gone when the pass completes."""
    path = str(tmp_path / "ck.npz")
    solve = window_mod.solve_ba_window_with_covariance
    calls = []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) == 14:
            raise _Interrupt
        return solve(*args, **kwargs)

    monkeypatch.setattr(window_mod, "solve_ba_window_with_covariance", interrupted)
    with pytest.raises(_Interrupt):
        _dataset(sim_files).solve_sliding_window(window=2, use_sun=True, config=CFG,
                                                 checkpoint=path, checkpoint_every=5)
    monkeypatch.setattr(window_mod, "solve_ba_window_with_covariance", solve)
    step, arrays = checkpoint.load(path)
    assert step == 10 and arrays["poses"].shape == (24, 12)
    ds = _dataset(sim_files)
    summaries = ds.solve_sliding_window(window=2, use_sun=True, config=CFG, checkpoint=path,
                                        checkpoint_every=5)
    poses, covars, n_windows = uninterrupted
    assert len(summaries) == n_windows - 10
    np.testing.assert_array_equal(ds.poses, poses)
    np.testing.assert_array_equal(ds.pose_covars, covars)
    assert not os.path.exists(path)


def test_checkpoint_meta_mismatch_refused(sim_files, uninterrupted, tmp_path):
    """load() refuses a checkpoint whose window, use_sun or dataset
    fingerprint differs (as the JAX module does); a stale checkpoint of
    another window size is ignored and the pass restarts cleanly."""
    path = str(tmp_path / "ck.npz")
    ds = _dataset(sim_files)
    meta = {"window": 2, "use_sun": True, "dataset": checkpoint.dataset_fingerprint(ds)}
    assert meta["dataset"] == jckpt.dataset_fingerprint(ds)
    garbage = {"poses": np.random.default_rng(0).normal(size=(24, 12)),
               "pose_covars": np.zeros((24, 6, 6))}
    checkpoint.save(path, 10, garbage, meta=meta)
    assert checkpoint.load(path, meta=meta)[0] == 10
    for bad in ({"window": 3}, {"use_sun": False}, {"dataset": "K24_J200_N815_00000000"}):
        assert checkpoint.load(path, meta={**meta, **bad}) is None
    checkpoint.save(path, 10, garbage, meta={**meta, "window": 3})
    summaries = ds.solve_sliding_window(window=2, use_sun=True, config=CFG, checkpoint=path,
                                        checkpoint_every=100)
    assert len(summaries) == uninterrupted[2]
    np.testing.assert_array_equal(ds.poses, uninterrupted[0])
    assert not os.path.exists(path)


def test_cli_checkpoint_files_removed(sim_files, tmp_path):
    """dataset_vo_sun --checkpoint: both passes run with per-pass files
    PATH.vo / PATH.sun, both are gone when the passes complete, and the
    CSVs equal a run without checkpoints byte for byte."""
    base = str(tmp_path / "ck")
    argv = [*sim_files, "--device", "cpu"]
    stats = dataset_vo_sun.main(argv + ["--checkpoint", base, "--checkpoint-every", "4"])
    with_ckpt = {n: open(p["output"], "rb").read() for n, p in stats["passes"].items()}
    assert not os.path.exists(base + ".vo") and not os.path.exists(base + ".sun")
    stats = dataset_vo_sun.main(argv)
    for name, p in stats["passes"].items():
        assert open(p["output"], "rb").read() == with_ckpt[name], name
    assert csvio.read_poses_csv(stats["passes"]["sun"]["output"]).shape == (24, 12)
