"""Port parity: the dense-stereo front end (Sobel, pyrDown, box filter,
cost volume, SGM, winner-take-all, the whole matcher), ``make_scene``, and
the app's full chain (``run(frontend=True)``, ``run_images``).

Inputs are seeded numpy arrays or the JAX ``make_scene`` (at most 96x128,
and 120x160 for the full chain, the JAX test's own size), handed to both
packages as the same numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import dense_stereo as jds
from ceres_slam_tpu.frontend import dense_stereo as jfront
from ceres_slam_tpu_torch.apps import dense_stereo
from ceres_slam_tpu_torch.frontend import dense_stereo as front

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


# -- the stages, float64: 1e-9 (summation order only) -----------------------------


@pytest.mark.parametrize("stage", ["sobel", "pyr_down", "box_filter"])
def test_filters_match_jax(stage):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(21, 34))
    if stage == "sobel":
        for g, r in zip(front.sobel_gradients(_t(img)), jfront.sobel_gradients(jnp.asarray(img))):
            _close(g, r, 1e-9)
    elif stage == "pyr_down":
        out = front.pyr_down(_t(img))
        assert tuple(out.shape) == (11, 17)  # ceil(n/2)
        _close(out, jfront.pyr_down(jnp.asarray(img)), 1e-9)
    else:
        vol = rng.normal(size=(3, 10, 12))
        _close(front._box_filter_sum(_t(vol), 2), jfront._box_filter_sum(jnp.asarray(vol), 2), 1e-9)


def _pair(H=48, W=64):
    """A rendered float64 stereo pair from the JAX ``make_scene``."""
    out = jds.make_scene(H=H, W=W, stereo=True)
    return np.asarray(out[1]), np.asarray(out[7]), np.asarray(out[5])


def test_cost_volume_and_sgm_match_jax():
    """The cost volume, each directional pass and the 4-direction sum, f64."""
    left, right, _ = _pair()
    vol = front._cost_volume(_t(left), _t(right), 16, 5, 0.25)
    jvol = jfront._cost_volume(jnp.asarray(left), jnp.asarray(right), 16, 5, 0.25)
    _close(vol, jvol, 1e-9)
    sd = np.moveaxis(np.asarray(jvol), 0, -1)  # [H, W, D]: scan along H
    _close(front._sgm_dir(_t(sd), 0.03, 0.12), jfront._sgm_dir(jnp.asarray(sd), 0.03, 0.12), 1e-9)
    S = front._sgm_aggregate(vol, torch.tensor(0.03, dtype=torch.float64),
                             torch.tensor(0.12, dtype=torch.float64), 4)
    _close(S, jfront._sgm_aggregate(jvol, jnp.asarray(0.03), jnp.asarray(0.12), 4), 1e-9)


def test_wta_matches_jax():
    """Winner-take-all on a volume with ties (first minimum in both) and a
    sentinel column: disparity 1e-9, masks equal."""
    rng = np.random.default_rng(1)
    S = np.round(rng.uniform(0, 4, (12, 9, 11)), 1)
    S[:, :, 0] = 1e30
    disp, valid = front._wta(_t(S), 0.05)
    jdisp, jvalid = jfront._wta(jnp.asarray(S), 0.05)
    _close(disp, jdisp, 1e-9)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.numpy().mean() < 1


def test_match_disparity_f64_matches_jax():
    """The whole matcher on float64 inputs: disparity 1e-9, masks equal."""
    left, right, _ = _pair()
    disp, valid = front.match_disparity(_t(left), _t(right), max_disp=16, block=5)
    jdisp, jvalid = jfront.match_disparity(jnp.asarray(left), jnp.asarray(right), max_disp=16,
                                           block=5)
    assert disp.dtype == torch.float64
    _close(disp, jdisp, 1e-9)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().mean() > 0.5


def test_match_disparity_f32_agrees_with_jax():
    """float32 inputs (the app's matcher dtype): the box-filter cumsums and
    the SGM sums round in another order than XLA's, so a few near-tied
    argmins may flip. Masks agree on >= 99.5% of the pixels and the
    disparities within 1e-3 px where both are valid."""
    out = jds.make_scene(H=96, W=128, stereo=True)
    left, right = np.asarray(out[1], np.float32), np.asarray(out[7], np.float32)
    disp, valid = front.match_disparity(_t(left), _t(right), max_disp=32, block=5)
    jdisp, jvalid = jfront.match_disparity(jnp.asarray(left), jnp.asarray(right), max_disp=32,
                                           block=5)
    valid, jvalid = valid.numpy(), np.asarray(jvalid)
    assert disp.dtype == torch.float32
    assert (valid == jvalid).mean() >= 0.995
    both = valid & jvalid
    assert both.mean() > 0.5
    assert np.abs(disp.numpy() - np.asarray(jdisp))[both].max() <= 1e-3


def test_make_scene_matches_jax():
    """Every output of ``make_scene(stereo=True)``, f64, 1e-12."""
    got = dense_stereo.make_scene(H=40, W=56, stereo=True)
    ref = jds.make_scene(H=40, W=56, stereo=True)
    np.testing.assert_allclose(np.asarray(got[0]), [float(x) for x in ref[0]], rtol=0, atol=1e-12)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float64
        _close(g, r, 1e-12)


def test_load_gray(tmp_path):
    """``.npy`` images: float64 in [0, 1]; 8-bit ranges are scaled by 1/255."""
    img = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
    np.save(tmp_path / "a.npy", img)
    got = front.load_gray(str(tmp_path / "a.npy"))
    assert got.dtype == torch.float64
    _close(got, img / 255.0, 1e-15)


# -- the app's full chain ----------------------------------------------------------


def test_end_to_end_frontend_alignment():
    """``run(frontend=True)`` against the JAX app at the JAX test's own
    size, 120x160 (at 96x128 the matched depths bend the pose away in both
    packages): the f32 matcher differs from XLA's in summation order only,
    so the valid-pixel counts agree within 0.5% and the final pose error
    within 25% of JAX's; both meet the JAX test's bounds."""
    kw = dict(H=120, W=160, pose_noise=0.02, frontend=True, max_disp=32, verbose=False)
    jsum, je0, je1 = jds.run(**kw)
    summary, err0, err1, stats = dense_stereo.run(**kw)
    je1 = float(jnp.linalg.norm(je1))
    np.testing.assert_allclose(err0, float(jnp.linalg.norm(je0)), rtol=1e-12)
    assert abs(err1 - je1) <= 0.25 * je1
    assert err1 < 0.75 * err0
    assert summary.final_cost < 0.1 * summary.initial_cost
    # JAX's valid-pixel count, rebuilt from its matcher as align_pair does
    out = jds.make_scene(120, 160, stereo=True)
    jdisp, jvalid = jfront.match_disparity(out[1].astype(jnp.float32), out[7].astype(jnp.float32),
                                           max_disp=32, block=5)
    inner = np.zeros((120, 160), bool)
    inner[8:-8, 8:-8] = True
    jcount = int((inner & np.asarray(jvalid) & (np.asarray(jdisp) > 0.5)).sum())
    assert abs(stats["pixels_valid"] - jcount) <= 0.005 * jcount
    assert stats["matcher_median_derr"] < 0.3


def test_run_images_from_files(tmp_path):
    """``run_images`` on npy files (96x128, one pyrDown to 48x64) against
    the JAX app: the cost decreases, the pose is finite, and the final poses
    of the two packages agree to 1e-3 (f32 matcher order, as above)."""
    out = jds.make_scene(H=96, W=128, stereo=True)
    paths = [str(tmp_path / f) for f in ("l0.npy", "r0.npy", "l1.npy")]
    for p, img in zip(paths, (out[1], out[7], out[2])):
        np.save(p, np.asarray(img))
    kw = dict(cam_params=[150.0, 150.0, 64.0, 48.0, 0.5], pyrdown=1, max_disp=16, verbose=False)
    jsol, jsum = jds.run_images(*paths, **kw)
    sol, summary, stats = dense_stereo.run_images(*paths, **kw)
    assert summary.final_cost < summary.initial_cost
    assert torch.isfinite(sol.T).all() and stats["size"] == (48, 64)
    np.testing.assert_allclose(sol.T.numpy(), np.asarray(jsol.T), rtol=0, atol=1e-3)
