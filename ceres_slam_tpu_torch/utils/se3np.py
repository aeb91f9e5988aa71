"""Tiny host-side (numpy) SE(3) helpers for the dataset layer's per-window
bookkeeping (compounding one pose, transforming a handful of inlier
points): flat ``[t | R row-major]`` poses, as in ``ops/lie.py``.

A copy of ``ceres_slam_tpu/utils/se3np.py``: importing anything under
``ceres_slam_tpu`` imports JAX, which the port must not.
"""

from __future__ import annotations

import numpy as np


def rot(T: np.ndarray) -> np.ndarray:
    return T[..., 3:].reshape(*T.shape[:-1], 3, 3)


def trans(T: np.ndarray) -> np.ndarray:
    return T[..., :3]


def make(t: np.ndarray, R: np.ndarray) -> np.ndarray:
    return np.concatenate([t, R.reshape(*R.shape[:-2], 9)], axis=-1)


def compose(Ta: np.ndarray, Tb: np.ndarray) -> np.ndarray:
    Ra, Rb = rot(Ta), rot(Tb)
    return make(np.einsum("...ij,...j->...i", Ra, trans(Tb)) + trans(Ta), Ra @ Rb)


def inverse(T: np.ndarray) -> np.ndarray:
    Rt = np.swapaxes(rot(T), -1, -2)
    return make(-np.einsum("...ij,...j->...i", Rt, trans(T)), Rt)


def transform_point(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    return np.einsum("...ij,...j->...i", rot(T), p) + trans(T)


def inv_sqrt_psd(M: np.ndarray) -> np.ndarray:
    """Host-side inverse matrix square root (tiny matrices: the per-window
    6x6 prior stiffness; device round trips cost more than the math)."""
    w, V = np.linalg.eigh(M)
    w = np.maximum(w, np.finfo(M.dtype).tiny)
    return np.einsum("...ij,...j,...kj->...ik", V, 1.0 / np.sqrt(w), V)


def transform_vector(T: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.einsum("...ij,...j->...i", rot(T), v)
