"""The benchmark's own tests: on the CPU at tiny sizes, except those marked
``cuda``, which decide inside a fixture whether there is a card and skip
where there is none."""

import json
from pathlib import Path

import pytest

from benchmark import registry

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


TINY = {"kitti1100": ("kitti60", dict(num_states=60, num_points=1500)),
        "phong200": ("phong12", dict(num_states=12, num_points=200))}


def tiny_spec(tmp_path: Path, config: str = "kitti1100", mix: str = "fullba",
              dtype: str = "float64", scene: dict | None = None):
    """``BENCHMARK.json`` with one more cell, ``<tiny>.<mix>``: the
    configuration ``config`` cut to a tiny scene (``TINY``, or ``scene``),
    found in ``tmp_path`` ahead of the benchmark's own files, with the
    limits of ``<config>.<mix>``, and every metric of ``<config>.<mix>``."""
    name, cut = TINY[config]
    cfg = registry.load_json("configs", config)
    cfg.update(name=name, dtype=dtype)
    cfg["scene"].update(scene or cut)
    limits = json.dumps(registry.load_json("limits", f"{config}.{mix}"))
    for kind, fname, body in (("configs", f"{name}.json", json.dumps(cfg)),
                              ("limits", f"{name}.{mix}.json", limits)):
        (tmp_path / kind).mkdir(exist_ok=True)
        (tmp_path / kind / fname).write_text(body)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = f"{name}.{mix}"
    spec["workloads"].append({"name": cell, "config": name, "traffic": mix, "chips": 1,
                              "why": "a tiny copy for the tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{config}.{mix}" in m.get("workloads", []):
            m["workloads"].append(cell)
    return spec, cell


@pytest.fixture
def search(tmp_path, monkeypatch):
    """``tmp_path`` searched ahead of the benchmark's own files."""
    monkeypatch.setattr(registry, "SEARCH", [tmp_path, *registry.SEARCH])
    return tmp_path


@pytest.fixture
def tiny(search):
    return tiny_spec(search)
