"""Finds the benchmark's pieces by the names ``BENCHMARK.json`` gives:
``benchmark/<kind>/<name>.py`` or ``.json`` (names may hold dots; a dotted
metric name without a file of its own falls back to its stem's)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the directories searched, in order (the benchmark's own tests put one
# before it)
SEARCH = [HERE]


def _path(kind: str, name: str, suffix: str) -> Path:
    """The file of ``name``; for a dotted metric name with no file of its
    own, the file of the name without its last part
    (``device_idle_pct.window`` falls back to ``device_idle_pct``), so that
    one reader serves a quantity split by the end-to-end metric it moves."""
    parts = name.split(".")
    for n in range(len(parts), 0 if kind == "metrics" else len(parts) - 1, -1):
        for base in SEARCH:
            path = base / kind / f"{'.'.join(parts[:n])}{suffix}"
            if path.is_file():
                return path
    raise SystemExit(f"benchmark: no {kind} entry named {name!r} ({kind}/{name}{suffix} "
                     "is missing)")


def load_module(kind: str, name: str):
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())
