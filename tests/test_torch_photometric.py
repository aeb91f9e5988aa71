"""Port parity: K4's plain version, the photometric residual, the
arrowhead LM step and solve, ``run_full_budget``, and the ``--gt-disparity``
app run.

Inputs come from numpy with a seed or from the JAX ``make_scene`` (at most
80x100) and reach the port through ``convert.py`` or as the same numpy
arrays. Every comparison is float64 unless it says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import dense_stereo as jds
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.ops import pallas_kernels
from ceres_slam_tpu.ops import photometric as jops
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import photometric as jph
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.apps import dense_stereo
from ceres_slam_tpu_torch.ops import bilinear_kernel, photometric
from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver import photometric as ph

torch.set_num_threads(1)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -- K4 plain ------------------------------------------------------------------


def test_k4_plain_matches_pallas_interpret_f32():
    """K4's plain version against the Pallas kernel in interpret mode, f32,
    on O(1) images. In bounds: 2e-6 absolute (f32 rounding of the two
    interpolation passes in another order: the kernel contracts one-hot
    matrices). Out of bounds (the clipped-border extrapolation, with
    fractions up to ~10): 1e-6 x max(1, |ref|) wherever the JAX value is
    finite; a non-finite coordinate gives a don't-care value the caller
    masks."""
    H, W = 24, 40
    imgs, u, v = bilinear_kernel.random_inputs(3, H, W, 700, torch.float32, seed=1)
    got = bilinear_kernel.bilinear_sample_imgs(imgs, u, v).double().numpy()
    assert bilinear_kernel.bilinear_sample_packed.launches == 0  # CPU tensors take the plain version
    ref = np.asarray(pallas_kernels.bilinear_sample_imgs(
        jnp.asarray(imgs.numpy()), jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
        interpret=True), np.float64)
    un, vn = u.numpy(), v.numpy()
    finite = np.isfinite(un) & np.isfinite(vn)
    inb = finite & (un >= 0) & (un < W - 1) & (vn >= 0) & (vn < H - 1)
    out = finite & ~inb & np.all(np.isfinite(ref), axis=0)
    assert inb.sum() > 500 and out.sum() > 50 and (~finite).sum() >= 3
    np.testing.assert_allclose(got[:, inb], ref[:, inb], rtol=0, atol=2e-6)
    assert np.all(np.abs(got[:, out] - ref[:, out]) <= 1e-6 * np.maximum(1.0, np.abs(ref[:, out])))


def test_k4_plain_matches_sample_bilinear_f64():
    """K4's plain version, f64, against ``_sample_bilinear`` on the
    in-bounds points, one channel at a time: 1e-12 (rounding only)."""
    H, W = 30, 44
    imgs, u, v = bilinear_kernel.random_inputs(3, H, W, 900, torch.float64, seed=2)
    got = bilinear_kernel.bilinear_sample_imgs(imgs, u, v).numpy()
    for c in range(3):
        ref, inb = jops._sample_bilinear(jnp.asarray(imgs[c].numpy()), jnp.asarray(u.numpy()),
                                         jnp.asarray(v.numpy()))
        inb = np.asarray(inb)
        assert inb.sum() > 600
        np.testing.assert_allclose(got[c, inb], np.asarray(ref)[inb], rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_k4_packed_plain_equals_planar(dtype):
    """The packed plain version equals the planar one bit for bit, at every
    point: inside, outside the image and at NaN / +-inf coordinates (NaN
    where the other is NaN). Strided coordinates (the columns of an
    ``[N, 3]`` projection) give the same bits as contiguous ones."""
    imgs, u, v = bilinear_kernel.random_inputs(3, 23, 37, 800, dtype, seed=7)
    un, vn = u.numpy(), v.numpy()
    assert np.isnan(un).any() and np.isinf(un).any() and (np.isfinite(un) & (un > 36)).any()
    planar = bilinear_kernel.bilinear_sample_imgs_plain(imgs, u, v)
    packed = bilinear_kernel.pack_imgs(imgs)
    assert packed.texels.shape == (23, 37, 4) and packed.channels == 3 and packed.args is None
    assert torch.equal(packed.texels[..., 3], torch.zeros(23, 37, dtype=dtype))
    got = bilinear_kernel.bilinear_sample_packed_plain(packed, u, v)
    torch.testing.assert_close(got, planar, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(bilinear_kernel.bilinear_sample_imgs(imgs, u, v), planar, rtol=0,
                               atol=0, equal_nan=True)
    proj = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    assert proj[:, 0].stride(0) == 3
    strided = bilinear_kernel.bilinear_sample_packed(packed, proj[:, 0], proj[:, 1])
    torch.testing.assert_close(strided, got, rtol=0, atol=0, equal_nan=True)


def test_k4_plan_checks():
    """``pack_imgs`` checks the stack once (shape, channels, dtype, device);
    a call checks only its coordinates (shape, dtype, device)."""
    imgs, u, v = bilinear_kernel.random_inputs(2, 9, 11, 50, torch.float64, seed=8)
    for bad, what in ((imgs[0], "expected"), (imgs.repeat(3, 1, 1), "C <= 4"),
                      (imgs[:, :1], "H >= 2"), (imgs.int(), "float32 or float64"),
                      (imgs.to("meta"), "cpu or cuda")):
        with pytest.raises(ValueError, match=what):
            bilinear_kernel.pack_imgs(bad)
    packed = bilinear_kernel.pack_imgs(imgs)
    for bu, bv, what in ((u[:-1], v, "shapes"), (u[:, None], v[:, None], "shapes"),
                         (u[:0], v[:0], "N >= 1"), (u.float(), v, "dtypes"),
                         (u.to("meta"), v.to("meta"), "are on")):
        with pytest.raises(ValueError, match=what):
            bilinear_kernel.bilinear_sample_packed(packed, bu, bv)


# -- the samplers and the residual -----------------------------------------------


def _points(H, W, N, seed):
    """Finite sample points, ~20% of them outside the image."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1 * W, 1.1 * W, N), rng.uniform(-0.1 * H, 1.1 * H, N)


@pytest.mark.parametrize("fn", ["image_gradients", "_sample_nn", "_sample_bilinear"])
def test_gradients_and_samplers_match_jax(fn):
    """f64, 1e-12; the samplers' masks equal. A NaN coordinate is out of
    bounds in the port (its value 0); the JAX package converts NaN to
    pixel 0 and counts it in bounds for ``_sample_nn`` (ROADMAP F11)."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(26, 38))
    if fn == "image_gradients":
        for g, r in zip(photometric.image_gradients(_t(img)), jops.image_gradients(jnp.asarray(img))):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
        return
    u, v = _points(26, 38, 500, seed=5)
    vals, inb = getattr(photometric, fn)(_t(img), _t(u), _t(v))
    rvals, rinb = getattr(jops, fn)(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(rinb))
    assert 0 < inb.numpy().mean() < 1
    np.testing.assert_allclose(vals.numpy(), np.asarray(rvals), rtol=0, atol=1e-12)
    u, v = _t([np.nan, 3.0, np.inf]), _t([3.0, np.nan, -np.inf])
    vals, inb = getattr(photometric, fn)(_t(img), u, v)
    assert not inb.any() and torch.equal(vals, torch.zeros(3, dtype=torch.float64))


def _residual_inputs(H=48, W=64, seed=3):
    """A scene, a perturbed pose, noisy disparities, ~10% invalid pixels,
    two pixels that project outside the image and one with disparity 0
    (its projection is NaN)."""
    cam, img_ref, img_trk, gu, gv, disp_ref, T_true = jds.make_scene(H, W)
    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(2, W - 2), np.arange(2, H - 2))
    idx = (vv.reshape(-1), uu.reshape(-1))
    ref_uv = np.concatenate([np.stack([uu.reshape(-1), vv.reshape(-1)], -1),
                             [[-25.0, 10.0], [W + 20.0, H / 2], [W / 3, H / 3]]]).astype(float)
    d = np.concatenate([np.asarray(disp_ref)[idx] + rng.normal(0, 0.5, idx[0].size),
                        [10.0, 10.0, 0.0]])
    valid = rng.random(d.size) > 0.1
    valid[-3:] = True
    T = jlie.se3_retract(T_true, jnp.asarray(rng.normal(0, 0.02, 6)))
    problem = jph.PhotometricProblem(
        camera=cam, ref_uv=jnp.asarray(ref_uv), ref_intensity=jnp.asarray(
            np.concatenate([np.asarray(img_ref)[idx], [0.5, 0.5, 0.5]])),
        track_img=img_trk, grad_u=gu, grad_v=gv, valid=jnp.asarray(valid),
        disp_meas=jnp.asarray(d), disp_stiffness=jnp.asarray(2.0))
    return problem, jph.PhotometricState(T=T, disparities=jnp.asarray(d))


@pytest.mark.parametrize("interp", ["bilinear", "nn"])
def test_photometric_residual_matches_jax(interp):
    """f64, 1e-10 x max|ref| on every output where JAX's is finite; masks
    equal. The port is finite everywhere: JAX's Jacobians are NaN on the
    zero-disparity row (0 x inf; ROADMAP F9's rule), and its ``_sample_nn``
    counts that row's NaN projection in bounds (F11), where the port masks
    it."""
    jp, js = _residual_inputs()
    p, s = convert.photometric_problem_from_numpy(_np(jp)), convert.photometric_state_from_numpy(_np(js))
    got = photometric.photometric_residual(p.camera, s.T, s.disparities, p.ref_uv, p.ref_intensity,
                                           p.track_img, p.grad_u, p.grad_v, p.valid, interp=interp)
    ref = jops.photometric_residual(jp.camera, js.T, js.disparities, jp.ref_uv, jp.ref_intensity,
                                    jp.track_img, jp.grad_u, jp.grad_v, jp.valid, interp=interp,
                                    sampler="gather")
    ok, rok = got[3].numpy(), np.asarray(ref[3])
    np.testing.assert_array_equal(ok[:-1], rok[:-1])
    assert not ok[-1] and not ok[-3:-1].any() and ok.mean() > 0.7
    for name, g, r in zip(("r", "J_pose", "J_disp"), got[:3], ref[:3]):
        g, r = g.numpy(), np.asarray(r)
        assert np.all(np.isfinite(g))
        fin = np.isfinite(r)
        assert fin[:-1].all() and (name == "r") == fin[-1:].all()  # JAX: NaN Jacobians on the last row
        # the last row: JAX's nn residual there reads pixel 0 (F11); the port's is 0
        np.testing.assert_allclose(g[:-1], r[:-1], rtol=0, atol=1e-10 * np.abs(r[:-1]).max())
        assert np.all(g[-1] == 0.0)


@pytest.mark.parametrize("lam", [1e-4, 10.0])
def test_cost_and_step_match_jax(lam):
    """``photometric_cost`` and ``_step`` on the same state and lambda:
    f64, 1e-9 relative on the cost, the gradient norm and the predicted
    decrease, 1e-9 x max|dx| on the step. The invalid pixels are dead
    (c = 0) and take no disparity step."""
    jp, js = _residual_inputs(seed=6)
    jp = jp._replace(ref_uv=jp.ref_uv[:-3], ref_intensity=jp.ref_intensity[:-3],
                     valid=jp.valid[:-3], disp_meas=jp.disp_meas[:-3])
    js = js._replace(disparities=js.disparities[:-3] + 0.1)
    p, s = convert.photometric_problem_from_numpy(_np(jp)), convert.photometric_state_from_numpy(_np(js))
    cost = float(ph.photometric_cost(p, s))
    np.testing.assert_allclose(cost, float(jph.photometric_cost(jp, js)), rtol=1e-9)
    dx, gn, pred = ph._step(p, s, lam)
    rdx, rgn, rpred = (np.asarray(x) for x in jph._step(jp, js, lam))
    np.testing.assert_allclose(dx.numpy(), rdx, rtol=0, atol=1e-9 * np.abs(rdx).max())
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-9)
    np.testing.assert_allclose(float(pred), float(rpred), rtol=1e-9)
    dead = ~p.valid.numpy()
    assert dead.any() and np.all(dx.numpy()[6:][dead] == 0.0)


# -- the solve -------------------------------------------------------------------


def _solve_inputs(H=60, W=80, seed=5):
    """The JAX package's own solver test problem (test_photometric.py)."""
    cam, img_ref, img_trk, gu, gv, disp_ref, T_true = jds.make_scene(H=H, W=W)
    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(6, W - 6), np.arange(6, H - 6))
    idx = (vv.reshape(-1), uu.reshape(-1))
    ref_uv = jnp.asarray(np.stack([uu.reshape(-1), vv.reshape(-1)], -1), jnp.float64)
    d0 = disp_ref[idx] + jnp.asarray(rng.normal(0, 0.3, len(idx[0])))
    problem = jph.PhotometricProblem(
        camera=cam, ref_uv=ref_uv, ref_intensity=img_ref[idx], track_img=img_trk, grad_u=gu,
        grad_v=gv, valid=jnp.ones(ref_uv.shape[0], bool), disp_meas=d0,
        disp_stiffness=jnp.asarray(3.0))
    T0 = jlie.se3_retract(T_true, jnp.asarray(rng.normal(0, 0.02, 6)))
    return problem, jph.PhotometricState(T=T0, disparities=d0)


@pytest.mark.parametrize("full_budget", [False, True], ids=["converged", "run_full_budget"])
def test_solve_photometric_matches_jax(full_budget):
    """``solve_photometric`` against JAX's (``sampler="gather"``): the same
    iteration count, final cost rtol 1e-8, pose 1e-8 (f64; the LM control
    runs on the same scalars). ``run_full_budget`` runs exactly
    ``max_iters`` iterations in both, past convergence."""
    jp, js = _solve_inputs()
    cfg = dict(max_iters=40, run_full_budget=full_budget)
    jsol, jsum = jph.solve_photometric(jp, js, jlm.SolveConfig(**cfg), sampler="gather")
    p, s = convert.photometric_problem_from_numpy(_np(jp)), convert.photometric_state_from_numpy(_np(js))
    sol, summary = ph.solve_photometric(p, s, lm.SolveConfig(**cfg))
    assert summary.iterations == int(jsum.iterations)
    assert (summary.iterations == 40) == full_budget
    np.testing.assert_allclose(summary.initial_cost, float(jsum.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(summary.final_cost, float(jsum.final_cost), rtol=1e-8)
    np.testing.assert_allclose(sol.T.numpy(), np.asarray(jsol.T), rtol=0, atol=1e-8)
    assert summary.final_cost < 0.05 * summary.initial_cost


def test_alignment_recovers_pose():
    """``run`` with rendered disparities (``--gt-disparity``) at 80x100
    against the JAX app: iterations equal, final cost rtol 1e-8, pose
    errors 1e-8 (the same numpy noise in the same order), and the JAX
    test's own bounds."""
    jsum, je0, je1 = jds.run(H=80, W=100, pose_noise=0.02, verbose=False)
    summary, err0, err1, stats = dense_stereo.run(H=80, W=100, pose_noise=0.02, verbose=False,
                                                  device="cpu")
    assert summary.iterations == int(jsum.iterations)
    np.testing.assert_allclose(summary.final_cost, float(jsum.final_cost), rtol=1e-8)
    np.testing.assert_allclose(err0, float(jnp.linalg.norm(je0)), rtol=0, atol=1e-8)
    np.testing.assert_allclose(err1, float(jnp.linalg.norm(je1)), rtol=0, atol=1e-8)
    assert err1 < 0.35 * err0
    assert summary.final_cost < 0.05 * summary.initial_cost
    assert stats["pixels_valid"] == (80 - 16) * (100 - 16)
