"""The KITTI-shaped street drive (the frozen ``generate_kitti``) and other
sun sources on it."""

import dataclasses

import numpy as np

from benchmark import simcopy


def make(scene: dict):
    args = dict(scene)
    args["stereo_noise"] = tuple(args["stereo_noise"])
    return simcopy.generate_kitti(**args)


def with_sun_noise(sim, noise_deg: float, g: np.random.Generator):
    """``sim`` with its sun observations drawn anew at ``noise_deg`` (the
    true direction in each camera turned about a random axis by a normal
    angle vector of that deviation, as ``generate_kitti`` does, from ``g``)
    and their covariance to match; the drive is the same."""
    K = sim.num_states
    R = sim.poses_gt[:, 3:].reshape(K, 3, 3)
    s_c = np.einsum("kab,kb->ka", R, sim.sun_dir_g)
    sig = np.deg2rad(noise_deg) if noise_deg > 0 else 0.0
    if sig > 0:
        w = g.normal(0.0, sig, (K, 3))
        th = np.linalg.norm(w, axis=-1, keepdims=True)
        axis = w / np.maximum(th, 1e-12)
        dot = np.sum(axis * s_c, axis=-1, keepdims=True)
        s_c = (np.cos(th) * s_c + np.sin(th) * np.cross(axis, s_c)
               + (1 - np.cos(th)) * dot * axis)
    var = max(sig, np.deg2rad(0.5)) ** 2
    return dataclasses.replace(sim, sun_obs_c=s_c,
                               sun_covar=np.broadcast_to(np.diag([var, var]), (K, 2, 2)).copy())
