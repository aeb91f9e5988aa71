"""The CUDA kernels (K1-K4) against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc; skips elsewhere. This file imports no JAX,
so it also runs where JAX is absent; there the repository's conftest (which
imports JAX) must be skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

K1's tolerances, relative to the largest reference entry: float64 1e-12
(rounding only); float32 1e-5 for the Gram blocks and 5e-3 for the
gradients (accumulation order; the gradients cancel), rtol 1e-4 for the
cost. K2's, K3's and K4's are stated above their tests.
"""

import pytest
import torch

from ceres_slam_tpu_torch.ops import (bilinear_kernel, schur_kernel, stereo_factor_kernel,
                                      window_kernel)

torch.set_num_threads(1)

TOL = {torch.float64: dict(hll=1e-12, u=1e-12, gl=1e-12, hpp=1e-12, gp=1e-12, cost=1e-12),
       torch.float32: dict(hll=1e-5, u=1e-5, gl=5e-3, hpp=1e-5, gp=5e-3, cost=1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("K,J,O", [(2, 192, 2), (64, 2048, 8), (5, 77, 3)],
                         ids=["flagship", "S", "ragged"])
def test_kernel_matches_plain(K, J, O, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = window_kernel.random_inputs(K, J, O, dtype, "cuda", seed=11)
    before = window_kernel.window_factor_blocks.launches
    got = window_kernel.window_factor_blocks(*args)
    torch.cuda.synchronize()
    assert window_kernel.window_factor_blocks.launches == before + 1
    ref = window_kernel.window_factor_blocks_plain(*args)
    split = lambda o: dict(hll=o[0], u=o[1], gl=o[2], hpp=o[3][:36], gp=o[3][36:42],
                           cost=o[3][42])  # noqa: E731
    for name, r in split(ref).items():
        g = split(got)[name].double()
        r = r.double()
        assert torch.isfinite(g).all(), name
        if name == "cost":
            assert abs(g.sum() - r.sum()) <= TOL[dtype][name] * abs(r.sum()), name
        else:
            assert (g - r).abs().max() <= TOL[dtype][name] * r.abs().max(), name


# K2 / K3 against their plain versions at the full-batch shapes of the sims
# (triangle200: N 12,992, J 448, K 200; kitti1100: N 124,480, J 16,640,
# K 1,100) and at a ragged shape. float64: 1e-12 x max|ref| (rounding
# only). float32, K2: 1e-4 x max(1, max|ref|) on r and the Gram blocks, 5e-3
# on the gradients (a ~1e3 px projection rounded at 6e-8 in two orders,
# times Jacobian entries of ~1e3, in sums that cancel); K3: 2e-5 x (max|ref|
# + 1) (float32 sums over up to ~150 observations in two orders).
FULL_BATCH = {"triangle200": (12992, 448, 200), "kitti1100": (124480, 16640, 1100),
              "ragged": (1001, 77, 13)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(FULL_BATCH))
def test_k2_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = stereo_factor_kernel.random_inputs(FULL_BATCH[shape][0], dtype, "cuda", seed=12)
    before = stereo_factor_kernel.stereo_factor_blocks.launches
    got = stereo_factor_kernel.stereo_factor_blocks(*args)
    torch.cuda.synchronize()
    assert stereo_factor_kernel.stereo_factor_blocks.launches == before + 1
    ref = stereo_factor_kernel.stereo_factor_blocks_plain(*args)
    for name, g, r, tol32 in zip(("r", "hpp", "hll", "u", "gp", "gl"), got, ref,
                                 (1e-4, 1e-4, 1e-4, 1e-4, 5e-3, 5e-3)):
        g, r = g.double(), r.double()
        assert torch.isfinite(g).all(), name
        if dtype == torch.float64:
            assert (g - r).abs().max() <= 1e-12 * r.abs().max(), name
        else:
            assert (g - r).abs().max() <= tol32 * max(1.0, r.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(FULL_BATCH))
def test_k3_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = schur_kernel.random_inputs(*FULL_BATCH[shape], dtype, "cuda", seed=13)
    before = schur_kernel.schur_uy.launches
    got = schur_kernel.schur_uy(*args)
    torch.cuda.synchronize()
    assert schur_kernel.schur_uy.launches == before + 1
    ref = schur_kernel.schur_uy_plain(*args).double()
    err = (got.double() - ref).abs().max()
    assert torch.isfinite(got).all()
    if dtype == torch.float64:
        assert err <= 1e-12 * ref.abs().max()
    else:
        assert err <= 2e-5 * (ref.abs().max() + 1.0)


# K4 against its plain version at the photometric path's 240x320 (N 68,096
# aligned pixels), at KITTI's full resolution (N 440,134) and at a ragged
# shape, with points outside the image and non-finite coordinates. The
# kernel rounds as the plain version does (no FMA contraction): float64
# 1e-12, float32 2e-6 absolute on O(1) images, at every point with finite
# coordinates (a non-finite one gives a value the caller masks).
K4_SHAPES = {"240x320": (3, 240, 320, 68096), "375x1242": (3, 375, 1242, 440134),
             "ragged": (3, 37, 53, 1001)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape", list(K4_SHAPES))
def test_k4_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs, u, v = bilinear_kernel.random_inputs(*K4_SHAPES[shape], dtype, "cuda", seed=14)
    before = bilinear_kernel.bilinear_sample_imgs.launches
    got = bilinear_kernel.bilinear_sample_imgs(imgs, u, v)
    torch.cuda.synchronize()
    assert bilinear_kernel.bilinear_sample_imgs.launches == before + 1
    ref = bilinear_kernel.bilinear_sample_imgs_plain(imgs, u, v)
    fin = u.isfinite() & v.isfinite()
    assert (~fin).sum() >= 3
    g, r = got[:, fin].double(), ref[:, fin].double()
    assert torch.isfinite(g).all()
    assert (g - r).abs().max() <= (1e-12 if dtype == torch.float64 else 2e-6)
