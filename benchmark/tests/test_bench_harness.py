"""The harness: pieces found by name, the result's line, the whole-name
check for JAX, the refusal without a card."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark import registry, run
from benchmark.tests.conftest import ROOT


def test_new_config_mix_and_metric_are_found_by_name(tiny, tmp_path):
    spec, cell = tiny
    # a new mix (the fullba driver with other parameters) and a new metric,
    # added as files only
    mix = json.loads((registry.HERE / "mixes" / "fullba.json").read_text())
    mix.update(name="fullba2", trials=2)
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "fullba2.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "kitti60.fullba2.json").write_text(
        (tmp_path / "limits" / "kitti60.fullba.json").read_text())
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "trials_seen.count.py").write_text(
        "def read(run):\n    return float(run.records[0]['solves'])\n")
    spec["workloads"].append({"name": "kitti60.fullba2", "config": "kitti60",
                              "traffic": "fullba2", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "trials_seen.count", "unit": "trials", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["kitti60.fullba2"]})
    result, compared = run.run_cell(spec, "kitti60.fullba2", 7, 0.5, False, device="cpu")
    assert result["metrics"]["trials_seen.count"]["value"] == 2
    assert set(result["metrics"]) == {"trials_seen.count", "setup_s"}
    assert result["correct"], compared


def test_result_line_keys(tiny):
    spec, cell = tiny
    result, compared = run.run_cell(spec, cell, 2 ** 31 + 5, 0.5, False, device="cpu")
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"solve_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert [c[0] for c in compared] == ["init_gap", "start_cost_rel", "cost_rel", "grad_rel"]


def test_dotted_metric_falls_back_to_its_stem(search):
    """``<name>.<suffix>`` without a file of its own is read by
    ``<name>.py``; a file of its own comes first; other kinds do not fall
    back."""
    assert registry._path("metrics", "device_idle_pct.any", ".py").name == "device_idle_pct.py"
    (search / "metrics").mkdir()
    (search / "metrics" / "device_idle_pct.any.py").write_text("def read(run):\n    return 1.0\n")
    assert registry.load_module("metrics", "device_idle_pct.any").read(None) == 1.0
    assert registry._path("metrics", "lm_iters.solve", ".py").name == "lm_iters.py"
    with pytest.raises(SystemExit):
        registry._path("limits", "kitti1100.fullba.any", ".json")


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    for name in ("ceres_slam_tpu_torch", "ceres_slam_tpu_torch.solver", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.banned_modules() == [n for n in run.banned_modules()
                                    if n.split(".")[0] in run.BANNED]
    assert not [n for n in run.banned_modules() if n.startswith(("ceres_slam_tpu_torch",
                                                                   "jaxtyping", "flaxen"))]
    monkeypatch.setitem(sys.modules, "ceres_slam_tpu.utils", types.ModuleType("x"))
    assert "ceres_slam_tpu.utils" in run.banned_modules()


def test_a_cell_run_loads_no_jax(tmp_path):
    """A whole run of a tiny cell in a fresh interpreter: no module whose
    top-level name is jax, jaxlib, flax or ceres_slam_tpu."""
    code = f"""
import json, sys
from pathlib import Path
from benchmark import registry, run
from benchmark.tests.conftest import tiny_spec
registry.SEARCH.insert(0, Path({str(tmp_path)!r}))
spec, cell = tiny_spec(Path({str(tmp_path)!r}))
result, _ = run.run_cell(spec, cell, 3, 0.5, False, device="cpu")
print(json.dumps({{"banned": run.banned_modules(), "correct": result["correct"],
                  "torch_port": "ceres_slam_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"banned": [], "correct": True, "torch_port": True}


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "kitti1100.fullba",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr

