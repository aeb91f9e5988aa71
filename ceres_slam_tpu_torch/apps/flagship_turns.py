"""Two trees of the port on the flagship, in turns, on one card.

  python -m ceres_slam_tpu_torch.apps.flagship_turns OTHER_ROOT [--seqs triangle200 kitti1100]

Runs the flagship's sun pass alone (``dataset_vo_sun --window 2
--sun-only``, float64, on CUDA) from the other tree (``OTHER_ROOT``, for
example the parent commit unpacked with ``git archive`` into a directory
``.gitignore`` lists) and from this one, in the order other, this, this,
other, on sims made by this tree's ``make_sim`` (seed 0, 10 degrees of sun
noise). Prints each run's pass wall, and whether each tree's two runs
wrote the same bytes. Host-bound walls move between calls; compare two
trees only within one call.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZES = {"triangle200": ("triangle", 200), "kitti1100": ("kitti", 1100)}


def _run(root: str, base: str) -> float:
    """One sun pass from ``root``; returns its wall [s]."""
    out = subprocess.run(
        [sys.executable, "-m", "ceres_slam_tpu_torch.apps.dataset_vo_sun", base + ".csv",
         base + "_sun_ref.csv", base + "_sun_dir_gtsun10.csv", "--window", "2", "--device",
         "cuda", "--sun-only"], cwd=root, capture_output=True, text=True, check=True)
    wall = re.search(r"pass sun: \d+ windows in ([0-9.]+) s", out.stderr)
    if wall is None:
        raise RuntimeError(f"no pass wall in the output of {root}:\n{out.stderr[-2000:]}")
    return float(wall.group(1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other_root")
    p.add_argument("--seqs", nargs="+", default=list(SIZES), choices=list(SIZES))
    p.add_argument("--data", default=os.path.join(ROOT, "build", "turns_data"))
    args = p.parse_args(argv)
    other = os.path.abspath(args.other_root)
    from ceres_slam_tpu_torch.apps import make_sim

    for seq in args.seqs:
        kind, n = SIZES[seq]
        make_sim.main([args.data, "--kind", kind, "--num-states", str(n), "--sun-noise", "10"])
        base = os.path.join(args.data, seq)
        kept = []
        for i, (name, root) in enumerate((("other", other), ("this", ROOT), ("this", ROOT),
                                          ("other", other)), 1):
            wall = _run(root, base)
            kept.append(f"{base}_run{i}.csv")
            shutil.copy(base + "_gtsun10_poses.csv", kept[-1])
            print(f"{seq} run {i} ({name} tree): sun pass {wall:.2f} s", flush=True)
        for name, a, b in (("this", kept[1], kept[2]), ("other", kept[0], kept[3])):
            same = filecmp.cmp(a, b, shallow=False)
            print(f"{seq} {name} tree: two runs {'byte-identical' if same else 'DIFFER'}",
                  flush=True)


if __name__ == "__main__":
    main()
