"""K1's and K3's byte and operation counts against the figures of the port's
kernel table (chip_smoke.py's bound arithmetic at PERF.md's shapes)."""

import pytest

from benchmark import roofline


@pytest.mark.parametrize("shape,tag,elem,bound_us", [
    ((124480, 16640, 1100), "f64", 8, 6.04),  # kitti1100
    ((124480, 16640, 1100), "f32", 4, 3.17),
    ((12992, 448, 200), "f64", 8, 0.60),  # triangle200
    ((12992, 448, 200), "f32", 4, 0.32),
])
def test_k3_bound(shape, tag, elem, bound_us):
    nbytes, ops = roofline.k3_cost(*shape, elem)
    assert ops == 90 * shape[0]
    assert roofline.bound_s(nbytes, ops, tag) * 1e6 == pytest.approx(bound_us, abs=0.005)


@pytest.mark.parametrize("shape", [(15, 2, 128, 2), (2, 2, 192, 2)])  # the grid; kitti1100
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k1_batch_bytes(shape, dtype):
    """chip_smoke.py's count: the bytes of the inputs it lists and of the
    outputs, on the port's seeded batch at the table's shapes."""
    import torch

    from ceres_slam_tpu_torch.ops import window_kernel

    B, K, J, O = shape
    plan, poses, points, _ = window_kernel.random_batch_inputs(B, K, J, O, getattr(torch, dtype),
                                                               "cpu", seed=9)
    out = window_kernel.window_factor_blocks_batch_plain(plan, poses, points)
    S = int(plan.pose_start[-1, -1])
    inputs = (poses, points, plan.pose_idx, plan.obs[:, :14], plan.pose_start,
              plan.point_by_pose[:S], plan.cams)
    expect = sum(t.numel() * t.element_size() for t in (*inputs, *out))
    nbytes, ops = roofline.k1_batch_cost(B, K, J, O, S, poses.element_size())
    assert nbytes == expect and ops == 750 * B * J * O
