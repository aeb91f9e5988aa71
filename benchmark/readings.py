"""The readings the limits of ``benchmark/limits/`` are set from: a cell's
numbers compared, on many seeds, for the program as the configuration states
it and for the control (the configuration's dtype one step lower, through
the program's own switch), on one item each, the trials drawn from the seed.

  python -m benchmark.readings --workload <cell> --seeds 12 --control-seeds 3 \
      [--items N] [--trials N]

One process for every seed (the scene, which the configuration fixes, is
generated once); prints a JSON line per seed and run, then the largest value
of each number over the sound seeds and the smallest over the control's.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

from benchmark import registry, run, simcopy

LOWER = {"float64": "float32"}


def read(spec: dict, workload: str, seed: int, dtype: str, items: int = 1,
         trials: int | None = None, device: str = "cuda") -> dict:
    """The numbers compared after ``items`` items, the mix's trials (the
    first ``trials`` of them, if given) drawn from ``seed`` (its
    ``trial_seed``) as well as their order or hypotheses."""
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    config = dict(registry.load_json("configs", cell["config"]), dtype=dtype)
    mix = registry.load_json("mixes", cell["traffic"])
    mix = dict(mix, trial_seed=seed, trials=trials or mix.get("trials"))
    driver = registry.load_module("drivers", mix["driver"]).Driver(config, mix, seed, device)
    driver.warm()
    t0 = time.perf_counter()
    recs = [driver.run_item(i) for i in range(items)]
    wall = time.perf_counter() - t0
    driver.release()
    return {**{name: value for name, value, _ in driver.check()},
            "items": {"n": items, "s": wall, "iterations": sum(r["iterations"] for r in recs)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--items", type=int, default=1, help="items a seed")
    p.add_argument("--trials", type=int, default=None, help="the mix's first trials only")
    args = p.parse_args(argv)
    spec = run.load_spec()
    # the scene is the configuration's, the same for every seed: made once
    simcopy.generate_kitti = functools.lru_cache(maxsize=8)(simcopy.generate_kitti)
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    dtype = registry.load_json("configs", cell["config"])["dtype"]
    sound, control = [], []
    for i in range(args.seeds + args.control_seeds):
        seed = args.first_seed + 7919 * i
        dt = dtype if i < args.seeds else LOWER[dtype]
        got = read(spec, args.workload, seed, dt, args.items, args.trials)
        (sound if dt == dtype else control).append(got)
        print(json.dumps({"seed": seed, "dtype": dt, **got}), flush=True)
    for name in (k for k in (sound or control)[0] if k != "items"):
        print(f"{name}: sound max {max((r[name] for r in sound), default=float('nan'))!r}, "
              f"control min {min((r[name] for r in control), default=float('nan'))!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
