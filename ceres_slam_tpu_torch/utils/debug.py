"""Numerical debugging utilities: NaN and Inf hygiene.

Port of ``ceres_slam_tpu/utils/debug.py``:

- ``assert_finite(tree, name)``: a host check of every floating tensor
  (or array) in a nest of NamedTuples, tuples, lists and dicts, naming the
  leaf's path;
- ``debug_finite(x, name)``: prints a warning when ``x`` holds non-finite
  values and returns ``x`` (one host read);
- ``enable_nan_debugging()``: raise at the first operation whose floating
  output holds a NaN. JAX re-checks every primitive (``jax_debug_nans``);
  here a ``TorchDispatchMode`` checks the output of every ATen operation,
  forward and backward alike (``torch.autograd.set_detect_anomaly`` checks
  the backward pass only). Slow: for debugging.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode


class NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation that writes a
    NaN into a floating output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in _pytree.tree_leaves(out):
            if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_mode: NanCheckMode | None = None


def enable_nan_debugging(enable: bool = True):
    """Turn the NaN check of every operation on (or off) for this thread,
    as ``jax_debug_nans`` does for the JAX package."""
    global _nan_mode
    if enable and _nan_mode is None:
        _nan_mode = NanCheckMode()
        _nan_mode.__enter__()
    elif not enable and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)


def _leaves(tree, path=""):
    """``(path, leaf)`` of every leaf of a nest of NamedTuples, tuples,
    lists and dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_finite(tree, name: str = "value"):
    """Raise ``FloatingPointError`` if a floating leaf of ``tree`` holds a
    non-finite value (one host read per leaf)."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
            size = leaf.numel()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            bad, size = int(np.count_nonzero(~np.isfinite(arr))), arr.size
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}: {bad}/{size} entries")


def debug_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Print a warning if ``x`` holds non-finite values; return ``x``."""
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        print(f"WARNING: {bad} non-finite entries in {name}")
    return x
