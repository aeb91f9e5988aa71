"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

  python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The harness is driven by data: the cell
names a configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/mixes/<traffic>.json``); the mix names its driver
(``benchmark/drivers/<driver>.py``), the configuration its generator
(``benchmark/generators/<generator>.py``), and every metric of
``BENCHMARK.json`` is read by ``benchmark/metrics/<name>.py``. A run builds
its inputs from the seed and warms every shape it uses (set-up), measures
for ``--seconds`` (the window), reads the peak memory, and then has the
driver judge what the window produced against the plain reference of
``benchmark/reference/``. The last line of standard output is the result's
JSON; the numbers compared, each with its limit, close standard error.
``--trace 1`` reports the per-layer metrics instead of the end-to-end ones,
from a profiled window. Without a CUDA card, or with fewer than the cell
asks for, the run fails: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

from benchmark.registry import load_json, load_module

ROOT = Path(__file__).resolve().parents[1]
# top-level module names no run may load: the JAX package and JAX itself
BANNED = ("jax", "jaxlib", "flax", "ceres_slam_tpu")


def load_spec(path: Path | None = None) -> dict:
    path = path or ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise SystemExit(f"benchmark: {path} is missing")
    return json.loads(path.read_text())


def cell_metrics(spec: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` this cell reports: those that list it
    under ``workloads``, and those without the key."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of ``BANNED``."""
    return sorted({n for n in sys.modules if n.split(".", 1)[0] in BANNED})


@dataclasses.dataclass
class Run:
    """What a run hands the metric readers."""

    cell: dict
    config: dict
    mix: dict
    driver: object
    records: list
    window_s: float
    setup_s: float
    trace: object = None


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> tuple[dict, list]:
    """One run of ``workload``: ``(result, compared)``, the result's line
    without its ``compared`` key and the numbers compared as ``[name,
    value, limit]``. ``device``: where the program runs (``cpu`` only for
    the benchmark's own tests, which skip the look for a card)."""
    import torch

    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload named {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json("configs", cell["config"])
    mix = load_json("mixes", cell["traffic"])
    on_card = device == "cuda"
    t0 = time.perf_counter()
    driver = load_module("drivers", mix["driver"]).Driver(config, mix, seed, device)
    driver.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    tracer = None
    if trace:
        from benchmark import trace as trace_mod

        tracer = trace_mod.Tracer(driver.phases, getattr(driver, "gated", False))
    driver.gate = tracer  # a gated driver opens and closes the profiled segments
    records = []
    with tracer if tracer is not None else _null():
        w0 = time.perf_counter()
        deadline = w0 + seconds
        while time.perf_counter() < deadline:
            ts = time.perf_counter()
            with tracer.item() if tracer is not None else _null():
                rec = driver.run_item(len(records))
            rec["t0"], rec["t1"] = ts, time.perf_counter()
            records.append(rec)
    window_s = records[-1]["t1"] - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(cell, config, mix, driver, records, window_s, setup_s,
              tracer.trace if tracer is not None else None)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, workload, section):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()
    compared = driver.check()
    result = {
        "correct": bool(compared) and all(v <= lim for _, v, lim in compared),
        "attempted": len(records),
        "failed": sum(1 for r in records if not r.get("ok", True)),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
    }
    if tracer is not None:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    return result, compared


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _parser():
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    # (the port builds its CUDA sources into build/ceres_slam_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    spec = load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload, {})
    chips = cell.get("chips", 1)
    # a mix may pin the numerical libraries' host threads (``host_threads``):
    # a host-paced step runs steadier without OpenMP workers contending for
    # the machine's shared cores (set before numpy and torch are imported)
    threads = load_json("mixes", cell["traffic"]).get("host_threads") if cell else None
    if threads:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(threads)
    import torch

    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result, compared = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = banned_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    for name, v, lim in compared:
        print(f"{name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
