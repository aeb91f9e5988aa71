"""Checkpoint / resume for the long-running pipelines.

The reference persists state only as CSV snapshots between phases
(SURVEY.md §5.4) and has no resume path. Here the sliding-window pipeline
checkpoints its full solver state (poses, landmark flags, covariance
chain, window index) to a single compressed npz after every few windows,
and `solve_sliding_window(checkpoint=...)` resumes from the last one —
the standard checkpoint-restart pattern for multi-hour traverses.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

FORMAT_VERSION = 2


def save(path: str, step: int, arrays: dict, meta: dict | None = None):
    """Atomically write a checkpoint (tmp file + rename).

    ``meta`` records the run configuration the checkpoint belongs to
    (window size, use_sun, a dataset fingerprint, ...); `load` rejects a
    checkpoint whose meta disagrees with the caller's — resuming a
    different --window or a same-shape different dataset would otherwise
    silently restore mismatched state (array shapes alone can agree).
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    meta_arrays = {
        f"__meta_{k}__": np.asarray(str(v)) for k, v in (meta or {}).items()
    }
    try:
        with os.fdopen(fd, "wb") as f:
            # pass the handle: np.savez appends ".npz" to bare filenames
            np.savez_compressed(
                f, __version__=FORMAT_VERSION, __step__=step,
                **meta_arrays, **arrays
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, meta: dict | None = None):
    """Returns (step, arrays dict), or None if absent/corrupt/mismatched.

    When ``meta`` is given, every key must match the stored value (string
    compare); a mismatch returns None so the caller restarts cleanly
    instead of resuming into a different run's state.
    """
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["__version__"]) != FORMAT_VERSION:
                return None
            for k, v in (meta or {}).items():
                key = f"__meta_{k}__"
                if key not in z.files or str(z[key]) != str(v):
                    return None
            step = int(z["__step__"])
            arrays = {
                k: z[k] for k in z.files if not k.startswith("__")
            }
        return step, arrays
    except Exception:
        return None


def dataset_fingerprint(ds) -> str:
    """Cheap stable identity for a dataset: problem sizes plus a content
    checksum of the observation block. Catches both 'different --window'
    and 'same-shape different dataset' resume mistakes."""
    import zlib

    obs = np.ascontiguousarray(ds.obs_list, np.float64)
    crc = zlib.crc32(obs.tobytes())
    return f"K{ds.num_states}_J{len(ds.map_points)}_N{len(obs)}_{crc:08x}"
