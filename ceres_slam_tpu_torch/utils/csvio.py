"""CSV IO in the reference's formats (port of ``ceres_slam_tpu/utils/csvio.py``).

Pure Python/numpy, with no native loader. Unlike the JAX package's native
loader, which reads a malformed token as 0, a token that is not a number
raises ``ValueError`` naming the file and line, as the reference's reader
does.
"""

from __future__ import annotations

import numpy as np

_POSES_HEADER = (
    "T_00, T_01, T_02, T_03,T_10, T_11, T_12, T_13,"
    "T_20, T_21, T_22, T_23,T_30, T_31, T_32, T_33\n"
)


def read_numeric_csv(path: str) -> list:
    """Parse a comma-separated numeric file into one float list per
    non-blank row (rows may differ in length)."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append([float(tok) for tok in line.split(",")])
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: non-numeric token ({e})") from None
    return rows


def write_poses_csv(path: str, poses: np.ndarray):
    """``_poses.csv``: header + one row-major 4x4 per flat pose."""
    with open(path, "w") as f:
        f.write(_POSES_HEADER)
        for T in poses:
            M = np.eye(4)
            M[:3, :3] = T[3:].reshape(3, 3)
            M[:3, 3] = T[:3]
            f.write(",".join(repr(float(x)) for x in M.reshape(16)) + "\n")


def read_poses_csv(path: str) -> np.ndarray:
    """Read an emitted ``_poses.csv`` back into flat ``[K, 12]`` poses."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("T_00"):
                continue
            M = np.asarray([float(t) for t in line.split(",")]).reshape(4, 4)
            out.append(np.concatenate([M[:3, 3], M[:3, :3].reshape(9)]))
    return np.stack(out)


def write_map_csv(path: str, points: np.ndarray, initialized: np.ndarray):
    """``_map.csv``: ``point_id, x, y, z`` for initialized points."""
    with open(path, "w") as f:
        f.write("point_id, x, y, z\n")
        for j in range(points.shape[0]):
            if initialized[j]:
                f.write(f"{j}," + ",".join(repr(float(x)) for x in points[j]) + "\n")
