"""Port parity: Lie groups, stereo camera, factors and robust loss.

Each case feeds the same float64 inputs, made with numpy from a seed, to
the JAX function and to its counterpart in ``ceres_slam_tpu_torch``.
Tolerance: atol 1e-12 — both evaluate the same closed forms in float64, so
they differ only by rounding (the largest magnitudes here are ~1e3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.models.stereo_camera import StereoCamera as JCam
from ceres_slam_tpu.ops import factors as jfactors
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import loss as jloss
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import dense, loss

torch.set_num_threads(1)

ATOL = 1e-12
CAM = (500.0, 480.0, 320.0, 240.0, 0.5)
N = 64


def _close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _phis(rng):
    """Rotation vectors spanning tiny (series branch) to large angles."""
    phi = rng.normal(size=(N, 3))
    phi /= np.linalg.norm(phi, axis=1, keepdims=True)
    scale = np.concatenate([np.full(8, 1e-9), np.full(8, 1e-5), rng.uniform(0.01, 2.5, N - 16)])
    return phi * scale[:, None]


def _poses(rng):
    xi = np.concatenate([rng.normal(0, 2.0, (N, 3)), _phis(rng)], axis=1)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def _both(fn_j, fn_t, *args):
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    out_t = fn_t(*(torch.as_tensor(a) for a in args))
    if isinstance(out_j, tuple):
        for a, b in zip(out_t, out_j):
            _close(a, b)
    else:
        _close(out_t, out_j)


LIE_CASES = {
    "so3_wedge": (jlie.so3_wedge, lie.so3_wedge, lambda r: (_phis(r),)),
    "so3_vee": (jlie.so3_vee, lie.so3_vee, lambda r: (r.normal(size=(N, 3, 3)),)),
    "so3_exp": (jlie.so3_exp, lie.so3_exp, lambda r: (_phis(r),)),
    "so3_log": (jlie.so3_log, lie.so3_log,
                lambda r: (np.asarray(jlie.so3_exp(jnp.asarray(_phis(r)))),)),
    "so3_inv_left_jacobian": (jlie.so3_inv_left_jacobian, lie.so3_inv_left_jacobian,
                              lambda r: (_phis(r),)),
    "so3_inv_right_jacobian": (jlie.so3_inv_right_jacobian, lie.so3_inv_right_jacobian,
                               lambda r: (_phis(r),)),
    "se3_exp": (jlie.se3_exp, lie.se3_exp,
                lambda r: (np.concatenate([r.normal(size=(N, 3)), _phis(r)], 1),)),
    "se3_log": (jlie.se3_log, lie.se3_log, lambda r: (_poses(r),)),
    "se3_inverse": (jlie.se3_inverse, lie.se3_inverse, lambda r: (_poses(r),)),
    "se3_compose": (jlie.se3_compose, lie.se3_compose, lambda r: (_poses(r), _poses(r))),
    "se3_transform_point": (jlie.se3_transform_point, lie.se3_transform_point,
                            lambda r: (_poses(r), r.normal(size=(N, 3)))),
    "se3_transform_vector": (jlie.se3_transform_vector, lie.se3_transform_vector,
                             lambda r: (_poses(r), r.normal(size=(N, 3)))),
    "se3_adjoint": (jlie.se3_adjoint, lie.se3_adjoint, lambda r: (_poses(r),)),
    "se3_wedge": (jlie.se3_wedge, lie.se3_wedge, lambda r: (r.normal(size=(N, 6)),)),
    "se3_vee": (jlie.se3_vee, lie.se3_vee, lambda r: (r.normal(size=(N, 4, 4)),)),
    "se3_retract": (jlie.se3_retract, lie.se3_retract,
                    lambda r: (_poses(r), np.concatenate([r.normal(size=(N, 3)), _phis(r)], 1))),
    "point_transform_jacobians": (jlie.point_transform_jacobians, lie.point_transform_jacobians,
                                  lambda r: (_poses(r), r.normal(size=(N, 3)))),
    "vector_transform_jacobians": (jlie.vector_transform_jacobians,
                                   lie.vector_transform_jacobians,
                                   lambda r: (_poses(r), r.normal(size=(N, 3)))),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    fn_j, fn_t, make = LIE_CASES[name]
    _both(fn_j, fn_t, *make(_rng(1)))


def _pts_c(rng):
    return rng.uniform([-4, -3, 2], [4, 3, 30], (N, 3))


def test_lie_constants_match_jax():
    for name in ("SE3_DIM", "SO3_DIM", "SE3_DOF", "SO3_DOF"):
        assert getattr(lie, name) == getattr(jlie, name), name


@pytest.mark.parametrize("method", ["project", "projection_jacobian", "triangulate",
                                    "triangulation_jacobian"])
def test_camera_matches_jax(method):
    rng = _rng(2)
    x = _pts_c(rng)
    if method.startswith("triangulat"):
        x = np.asarray(JCam.create(*CAM).project(jnp.asarray(x)))
    out_j = getattr(JCam.create(*CAM), method)(jnp.asarray(x))
    out_t = getattr(StereoCamera.create(*CAM), method)(torch.as_tensor(x))
    _close(out_t, out_j)


def _stiffness(rng, d):
    A = rng.normal(size=(N, d, d))
    return np.asarray(jfactors.inv_sqrt_psd(jnp.asarray(A @ A.transpose(0, 2, 1) + d * np.eye(d))))


def test_inv_sqrt_psd_matches_jax():
    rng = _rng(3)
    A = rng.normal(size=(N, 6, 6))
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(6)
    _both(jfactors.inv_sqrt_psd, factors.inv_sqrt_psd, M)


def test_stereo_reprojection_matches_jax():
    rng = _rng(4)
    T = _poses(rng)
    p = np.asarray(jlie.se3_transform_point(jlie.se3_inverse(jnp.asarray(T)),
                                            jnp.asarray(_pts_c(rng))))
    uvd = rng.uniform([0, 0, 5], [640, 480, 50], (N, 3))
    S = _stiffness(rng, 3)
    out_j = jfactors.stereo_reprojection(JCam.create(*CAM), *(jnp.asarray(a) for a in (T, p, uvd, S)))
    out_t = factors.stereo_reprojection(StereoCamera.create(*CAM),
                                        *(torch.as_tensor(a) for a in (T, p, uvd, S)))
    for a, b in zip(out_t, out_j):
        _close(a, b, atol=1e-12 * max(1.0, np.abs(np.asarray(b)).max()))


def test_pose_prior_matches_jax():
    rng = _rng(5)
    T = _poses(rng)
    T_ref = np.asarray(jlie.se3_retract(jnp.asarray(T), jnp.asarray(rng.normal(0, 0.3, (N, 6)))))
    _both(jfactors.pose_prior, factors.pose_prior, T, T_ref, _stiffness(rng, 6))


@pytest.mark.parametrize("thresh", [1000.0, 0.05])
def test_sun_sensor_matches_jax(thresh):
    """The gate zeroes both the residual and the Jacobian row of a
    component past its threshold (0.05 rad gates a good share here)."""
    rng = _rng(6)
    T = _poses(rng)
    s_g = rng.normal(size=(N, 3))
    s_g /= np.linalg.norm(s_g, axis=1, keepdims=True)
    s_c = np.asarray(jlie.se3_transform_vector(jnp.asarray(T), jnp.asarray(s_g)))
    s_c = s_c + rng.normal(0, 0.05, s_c.shape)
    s_c /= np.linalg.norm(s_c, axis=1, keepdims=True)
    S = _stiffness(rng, 2)
    out_j = jfactors.sun_sensor(*(jnp.asarray(a) for a in (T, s_c, s_g, S)), thresh, thresh)
    out_t = factors.sun_sensor(*(torch.as_tensor(a) for a in (T, s_c, s_g, S)), thresh, thresh)
    for a, b in zip(out_t, out_j):
        _close(a, b)
    if thresh < 1:
        assert np.any(np.asarray(out_j[0]) == 0.0)


@pytest.mark.parametrize("fn", ["huber_rho", "huber_weight"])
def test_huber_matches_jax(fn):
    s = _rng(7).uniform(0, 4, 256) ** 2
    _both(lambda x: getattr(jloss, fn)(x, 0.7), lambda x: getattr(loss, fn)(x, 0.7), s)


@pytest.mark.parametrize("fn", ["cauchy_rho", "cauchy_weight"])
def test_cauchy_matches_jax(fn):
    """float64, seeded squared norms from 0 to ~1e4 (a = 0.7): 1e-15 relative."""
    s = _rng(8).uniform(0, 100, 256) ** 2
    s[:4] = (0.0, 1e-12, 0.49, 1e4)
    got = getattr(loss, fn)(torch.as_tensor(s), 0.7).numpy()
    ref = np.asarray(getattr(jloss, fn)(jnp.asarray(s), 0.7))
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def example():
    problem, state = ge._build_example(K=6, J=48, n_obs=240, dtype=jnp.float64, seed=5)
    problem_np = jax.tree.map(np.asarray, problem)
    state_np = jax.tree.map(np.asarray, state)
    return problem, state, convert.problem_from_numpy(problem_np), convert.state_from_numpy(state_np)


def test_aux_cost_matches_jax(example):
    problem, state, p_t, s_t = example
    _close(dense.ba_cost_aux(p_t, s_t), jdense.ba_cost_aux(problem, state))


def test_aux_pose_blocks_match_jax(example):
    problem, state, p_t, s_t = example
    Hj, gj = jdense.aux_pose_blocks(problem, state)
    Ht, gt = dense.aux_pose_blocks(p_t, s_t)
    # Hpp holds the prior stiffness squared (1e6): scale atol to it
    _close(Ht, Hj, atol=1e-12 * np.abs(np.asarray(Hj)).max())
    _close(gt, gj, atol=1e-12 * max(1.0, np.abs(np.asarray(gj)).max()))


def test_retract_state_matches_jax(example):
    problem, state, p_t, s_t = example
    problem = problem._replace(fixed_pose_mask=problem.fixed_pose_mask.at[0].set(True),
                               point_valid=problem.point_valid.at[3].set(False))
    p_t = p_t._replace(fixed_pose_mask=torch.as_tensor(np.asarray(problem.fixed_pose_mask)),
                       point_valid=torch.as_tensor(np.asarray(problem.point_valid)))
    dx = _rng(8).normal(0, 0.05, 6 * 6 + 3 * 48)
    out_j = jdense._retract_state(problem, state, jnp.asarray(dx))
    out_t = dense._retract_state(p_t, s_t, torch.as_tensor(dx))
    _close(out_t.poses, out_j.poses)
    _close(out_t.points, out_j.points)


def test_stereo_jacobians_match_autodiff():
    """The analytic tangent Jacobians equal forward-mode autodiff through
    the retraction ``exp(eps) T`` and the landmark."""
    rng = _rng(9)
    cam = StereoCamera.create(*CAM)
    T = torch.as_tensor(_poses(rng)[:4])
    p = lie.se3_transform_point(lie.se3_inverse(T), torch.as_tensor(_pts_c(rng)[:4]))
    uvd = torch.as_tensor(rng.uniform([0, 0, 5], [640, 480, 50], (4, 3)))
    S = torch.as_tensor(_stiffness(rng, 3)[:4])
    _, J_pose, J_pt = factors.stereo_reprojection(cam, T, p, uvd, S)
    for n in range(4):
        def r_of(eps, pt):
            return factors.stereo_reprojection(cam, lie.se3_retract(T[n], eps), pt, uvd[n], S[n])[0]

        Jp, Jl = torch.func.jacfwd(r_of, argnums=(0, 1))(torch.zeros(6, dtype=T.dtype), p[n])
        np.testing.assert_allclose(J_pose[n].numpy(), Jp.numpy(), atol=1e-9 * Jp.abs().max().item())
        np.testing.assert_allclose(J_pt[n].numpy(), Jl.numpy(), atol=1e-9 * Jl.abs().max().item())
