"""The frozen generators give the port's sim bytes at a seed."""

import numpy as np
import pytest

from benchmark import simcopy
from ceres_slam_tpu_torch.utils import sim


def _same(a, b):
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
        else:
            assert x == y, field


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_kitti_same_bytes(seed):
    args = dict(num_states=80, num_points=2000, seed=seed)
    _same(simcopy.generate_kitti(**args), sim.generate_kitti(**args))


def test_phong_same_bytes():
    args = dict(num_states=12, num_points=120, seed=3)
    _same(simcopy.generate_phong(**args), sim.generate_phong(**args))
