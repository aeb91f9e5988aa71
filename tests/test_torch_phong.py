"""Port parity: Phong-illumination BA, from the shading to one Schur step.

Held against tests/test_phong.py. The problems have test_phong.py's sizes
(K=3 poses, J=40 vertices, M=2 materials, every vertex seen by every
pose), drawn from a numpy seed and handed to both packages as the same
numpy arrays (``ceres_slam_tpu_torch.convert``). The "masked" problem also
has invalid observations, an uninitialized vertex and two repeated
(vertex, pose) observations. Tolerances, relative to the largest reference
entry of each output (of each factor, for the factors' Jacobians): 1e-13
for the shading (a few roundings), 1e-10 for the factors and every
assembled block (float64 sums in another order),
1e-9 on a Schur step's dx (a 6x6 and a D_r x D_r Cholesky on each side).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.models import lighting as jlighting
from ceres_slam_tpu.ops import factors as jfactors
from ceres_slam_tpu.ops import lie as jlie
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu.solver import phong as jphong
from ceres_slam_tpu.solver import phong_schur as jschur
from ceres_slam_tpu.models.stereo_camera import StereoCamera as JCamera
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.models import lighting
from ceres_slam_tpu_torch.ops import factors, lie
from ceres_slam_tpu_torch.solver import lm, phong, phong_schur

torch.set_num_threads(1)

K, J, M = 3, 40, 2
CAM = JCamera.create(500.0, 500.0, 320.0, 240.0, 0.5)


def _np(x):
    return jax.tree.map(np.asarray, x)


def _close(a, ref, scale):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ref = np.asarray(ref)
    assert a.shape == ref.shape
    np.testing.assert_allclose(a, ref, rtol=0, atol=scale * max(np.abs(ref).max(), 1e-300))


def make_problem(seed: int, directional: bool, masked: bool = False, noise: float = 0.2):
    """``(jax_problem, jax_state0)`` of test_phong.py's shape and shading
    model, from a numpy seed: a shaded scene, noisy observations, and an
    initial state perturbed from the truth."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.0, 0.0, -0.3, 0.01, 0.03, 0.005]) * np.arange(K)[:, None]
    poses = lie.se3_exp(torch.as_tensor(xi))
    pts = rng.uniform([-4.0, -3.0, 6.0], [4.0, 3.0, 14.0], (J, 3))
    n = rng.normal(0.0, 0.3, (J, 3)) + np.array([0.0, 0.0, -1.0])
    normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
    mat = rng.integers(0, M, J)
    phong_gt = np.tile(np.array([0.0, 0.25, 8.0]), (M, 1))
    tex_gt = np.linspace(0.4, 0.8, M)
    light_gt = (np.array([0.3, -0.5, -0.8]) / np.linalg.norm([0.3, -0.5, -0.8]) if directional
                else np.array([-5.0, -5.0, -3.0]))
    pose_idx = np.repeat(np.arange(K), J)
    vertex_idx = np.tile(np.arange(J), K)
    if masked:  # two repeated (vertex, pose) observations
        pose_idx = np.concatenate([pose_idx, [1, 2]])
        vertex_idx = np.concatenate([vertex_idx, [5, 7]])
    material_idx = mat[vertex_idx]
    N = pose_idx.size
    # the scene is shaded with the port's functions (held to JAX's below)
    t = torch.as_tensor
    T = poses[t(pose_idx)]
    p_c = lie.se3_transform_point(T, t(pts)[t(vertex_idx)])
    n_c = lie.se3_transform_vector(T, t(normals)[t(vertex_idx)])
    shade = lighting.directional_light_shade if directional else lighting.point_light_shade
    l_c = (lie.se3_transform_vector if directional else lie.se3_transform_point)(
        T, t(light_gt).expand(N, 3))
    I = shade(p_c, n_c, t(phong_gt)[t(material_idx)], t(tex_gt)[t(material_idx)], l_c,
              torch.zeros(3, dtype=torch.float64))
    cam = convert._camera(CAM)
    uvd = cam.project(p_c).numpy() + noise * rng.normal(size=(N, 3))
    I = I.numpy() + 0.01 * rng.normal(size=N)
    n_c = n_c.numpy() + 0.01 * rng.normal(size=(N, 3))
    valid = np.ones(N, bool)
    vertex_valid = np.ones(J, bool)
    if masked:
        valid[[3, 50]] = False
        vertex_valid[11] = False
    obs = jphong.PhongObs(uvd=jnp.asarray(uvd), int_obs=jnp.asarray(I),
                          normal_obs=jnp.asarray(n_c),
                          pose_idx=jnp.asarray(pose_idx, jnp.int32),
                          vertex_idx=jnp.asarray(vertex_idx, jnp.int32),
                          material_idx=jnp.asarray(material_idx, jnp.int32),
                          valid=jnp.asarray(valid))
    problem = jphong.PhongBAProblem(
        camera=CAM, obs=obs, stereo_stiffness=jnp.eye(3) / 0.5,
        normal_stiffness=jnp.eye(3) / 0.1, int_stiffness=jnp.asarray(1.0 / 0.1),
        fixed_pose_mask=jnp.zeros(K, bool).at[0].set(True),
        vertex_valid=jnp.asarray(vertex_valid))
    dp = 0.02 * rng.normal(size=(K, 6))
    dp[0] = 0.0
    nn = normals + 0.1 * rng.normal(size=(J, 3))
    light = light_gt + (0.1 if directional else 1.0) * rng.normal(size=3)
    if directional:
        light = light / np.linalg.norm(light)
    state0 = jphong.PhongState(
        poses=jnp.asarray(lie.se3_retract(poses, t(dp)).numpy()),
        points=jnp.asarray(pts + 0.1 * rng.normal(size=(J, 3))),
        normals=jnp.asarray(nn / np.linalg.norm(nn, axis=-1, keepdims=True)),
        phong=jnp.tile(jnp.array([0.0, 0.0, 1.0]), (M, 1)),
        textures=jnp.full(M, 0.5), light=jnp.asarray(light))
    return problem, state0


CASES = {"point": (False, False), "directional": (True, False), "masked": (False, True)}


# the stage flags (use_light, freeze_geometry) each assembly test runs per
# case: all three on the point-light problem, the joint stage on the others
# (each combination is one more JAX compile)
STAGES = {"joint": (True, False), "geometry": (False, False), "lighting": (True, True)}
ASSEMBLY = [("point", stage) for stage in STAGES] + [("directional", "joint"),
                                                      ("masked", "joint"),
                                                      ("masked", "lighting")]


@functools.lru_cache(maxsize=None)
def _case(name):
    directional, masked = CASES[name]
    problem, state = make_problem(3, directional, masked)
    return (directional, problem, state, convert.phong_problem_from_numpy(_np(problem)),
            convert.phong_state_from_numpy(_np(state)))


@pytest.fixture(params=list(CASES))
def case(request):
    return _case(request.param)


# -- shading ---------------------------------------------------------------------

def _shading_inputs():
    """Unit and non-unit directions, back-facing normals, a zero vector, a
    non-finite light direction and exponents over [1, 12]."""
    rng = np.random.default_rng(11)
    n = 64
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)  # noqa: E731
    normal = unit(rng.normal(size=(n, 3)))
    light = unit(rng.normal(size=(n, 3)))
    cam = unit(rng.normal(size=(n, 3)))
    light[0] = np.nan
    light[1] = -normal[1]
    cam[2] = 0.0
    pos = rng.uniform(-5, 5, (n, 3))
    params = np.stack([np.zeros(n), rng.uniform(0, 1, n), rng.uniform(1, 12, n)], axis=-1)
    tex = rng.uniform(0, 1, n)
    return normal, light, cam, pos, params, tex


SHADERS = {
    "shade_diffuse": lambda m, n, l, c, p, ph, t: m.shade_diffuse(n, l, t),
    "shade_specular": lambda m, n, l, c, p, ph, t: m.shade_specular(n, l, c, ph[:, 1], ph[:, 2]),
    "shade_specular_blinn": lambda m, n, l, c, p, ph, t: m.shade_specular_blinn(
        n, l, c, ph[:, 1], ph[:, 2]),
    "phong_shade": lambda m, n, l, c, p, ph, t: m.phong_shade(n, l, c, ph, t),
    "directional_light_shade": lambda m, n, l, c, p, ph, t: m.directional_light_shade(
        p, n, ph, t, l, c),
    "point_light_shade": lambda m, n, l, c, p, ph, t: m.point_light_shade(p, n, ph, t, 3 * c, l),
}


@pytest.mark.parametrize("name", list(SHADERS))
def test_lighting_matches_jax(name):
    args = _shading_inputs()
    ref = SHADERS[name](jlighting, *(jnp.asarray(a) for a in args))
    got = SHADERS[name](lighting, *(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-13, equal_nan=True)


def test_unit_vector_ops_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(20, 3))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    d = 0.3 * rng.normal(size=(20, 3))
    _close(lie.unit_vector_retract(torch.as_tensor(x), torch.as_tensor(d)),
           jlie.unit_vector_retract(jnp.asarray(x), jnp.asarray(d)), 1e-15)
    _close(factors.unit_vector_tangent_projector(torch.as_tensor(2 * x)),
           jfactors.unit_vector_tangent_projector(jnp.asarray(2 * x)), 1e-15)


# -- factors ---------------------------------------------------------------------

def test_factors_match_jax(case):
    """The intensity factor (point or directional) with its six Jacobians
    (JAX: ``jax.grad`` under ``vmap``; port: one reverse pass over the
    independent rows) and the normal factor."""
    directional, pj, sj, pt, st = case
    o, ot = pj.obs, pt.obs
    args_j = (sj.poses[o.pose_idx], sj.points[o.vertex_idx], sj.normals[o.vertex_idx],
              sj.phong[o.material_idx], sj.textures[o.material_idx], sj.light, o.int_obs,
              jnp.full(o.int_obs.shape, 10.0))
    args_t = (st.poses[ot.pose_idx], st.points[ot.vertex_idx], st.normals[ot.vertex_idx],
              st.phong[ot.material_idx], st.textures[ot.material_idx], st.light, ot.int_obs,
              torch.full(ot.int_obs.shape, 10.0, dtype=torch.float64))
    jf = jfactors.intensity_directional_light if directional else jfactors.intensity_point_light
    tf = factors.intensity_directional_light if directional else factors.intensity_point_light
    got, ref = tf(*args_t), jax.jit(jf)(*args_j)
    # relative to the factor's largest entry: a Jacobian that is zero in
    # exact arithmetic (a clamped shade) holds rounding residue of ~1e-16
    scale = 1e-10 * max(float(np.abs(np.asarray(x)).max()) for x in ref)
    for name, a, b in zip(("r", "J_pose", "J_point", "J_normal", "J_phong", "J_texture",
                           "J_light"), got, ref):
        assert not a.requires_grad, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=scale, err_msg=name)
    N = o.uvd.shape[0]
    S = np.eye(3) / 0.1
    for a, b in zip(factors.normal_obs(args_t[0], args_t[2], ot.normal_obs,
                                       torch.as_tensor(S).expand(N, 3, 3)),
                    jfactors.normal_obs(args_j[0], args_j[2], o.normal_obs,
                                        jnp.broadcast_to(S, (N, 3, 3)))):
        _close(a, b, 1e-12)


def test_cost_matches_jax(case):
    directional, pj, sj, pt, st = case
    for use_light in (False, True):
        ref = float(jax.jit(lambda p, s: jphong.phong_cost(p, s, use_light, directional))(pj, sj))
        got = phong.phong_cost(pt, st, use_light, directional).item()
        np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("name,stage", ASSEMBLY)
def test_normal_equations_match_jax(name, stage):
    directional, pj, sj, pt, st = _case(name)
    use_light, freeze = STAGES[stage]
    H_r, g_r = jax.jit(lambda p, s: jphong.phong_normal_equations(
        p, s, use_light, directional, freeze))(pj, sj)
    H, g = phong.phong_normal_equations(pt, st, use_light, directional, freeze)
    _close(H, H_r, 1e-10)
    _close(g, g_r, 1e-10)


@pytest.mark.parametrize("path", ["slotted", "layout_none"])
@pytest.mark.parametrize("name,stage", ASSEMBLY)
def test_schur_blocks_match_jax(name, stage, path):
    """``phong_schur_blocks`` against JAX's slotted assembly (its one-hot
    reductions; port: the layout's gather tables) and, without a layout,
    against JAX's segment-sum assembly (port: the layout built inside)."""
    directional, pj, sj, pt, st = _case(name)
    use_light, freeze = STAGES[stage]
    if path == "slotted":
        lj = jschur.build_phong_layout(pj, J)
        ref = jax.jit(lambda p, s, lay: jschur.phong_schur_blocks(
            p, s, use_light, directional, freeze, layout=lay))(pj, sj, lj)
        got = phong_schur.phong_schur_blocks(pt, st, use_light, directional, freeze,
                                             layout=phong_schur.build_phong_layout(pt))
    else:
        ref = jax.jit(lambda p, s: jschur.phong_schur_blocks(
            p, s, use_light, directional, freeze))(pj, sj)
        got = phong_schur.phong_schur_blocks(pt, st, use_light, directional, freeze)
    for name, a, b in zip(("Hv", "gv", "W", "Hr", "gr"), got, ref):
        _close(a, b, 1e-10)


def test_layout_tables():
    """The gather tables list every valid observation once, by vertex, by
    pose and by (vertex, pose) pair, in increasing order; invalid ones
    (and those of the uninitialized vertex) are in no table."""
    pj, _ = make_problem(3, False, masked=True)
    pt = convert.phong_problem_from_numpy(_np(pj))
    lay = phong_schur.build_phong_layout(pt)
    o = pt.obs
    N = o.uvd.shape[0]
    valid = (o.valid & pt.vertex_valid[o.vertex_idx]).numpy()
    for table, key in ((lay.by_vertex, o.vertex_idx), (lay.by_pose, o.pose_idx),
                       (lay.by_pair, o.vertex_idx * K + o.pose_idx)):
        t = table.numpy()
        ids = t[t < N]
        assert sorted(ids.tolist()) == np.nonzero(valid)[0].tolist()
        for b, row in enumerate(t):
            row = row[row < N]
            assert (np.diff(row) > 0).all() and (key.numpy()[row] == b).all()
    assert lay.by_pair.shape[1] == 2  # the repeated pairs


def test_schur_step_matches_jax(case):
    directional, pj, sj, pt, st = case
    lam = 1e-3
    lj = jschur.build_phong_layout(pj, J)
    dx_r, gn_r, pred_r = jax.jit(lambda p, s, lay: jschur.phong_schur_step(
        p, True, directional, False, layout=lay)(s, jnp.asarray(lam)))(pj, sj, lj)
    dx, gn, pred = phong_schur.phong_schur_step(pt, True, directional, False)(st, lam)
    _close(dx, dx_r, 1e-9)
    np.testing.assert_allclose(gn.item(), float(gn_r), rtol=1e-10)
    np.testing.assert_allclose(pred.item(), float(pred_r), rtol=1e-8)


def test_retract_matches_jax(case):
    directional, pj, sj, pt, st = case
    rng = np.random.default_rng(13)
    D = 6 * K + 6 * J + 4 * M + 3
    dx = rng.normal(0, 0.05, D)
    dx[6 * K + 6 * J:6 * K + 6 * J + 3 * M] += 2.0  # push the Phong parameters past the box
    for freeze in (False, True):
        ref = jax.jit(lambda p, s, d: jphong.phong_retract(p, s, d, True, directional, freeze))(
            pj, sj, jnp.asarray(dx))
        got = phong.phong_retract(pt, st, torch.as_tensor(dx), True, directional, freeze)
        for a, b in zip(got, ref):
            _close(a, b, 1e-14)


def test_solver_choice_matches_jax(case):
    _, _, sj, _, st = case
    assert phong.auto_linear_solver(st) == jphong.auto_linear_solver(sj) == "dense"


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_solve_matches_jax(solver):
    """One joint LM solve (point light) through either linear solver: the
    same iterations, final cost rtol 1e-8, poses atol 1e-8."""
    pj, sj = make_problem(5, False)
    cfg = dict(max_iters=30, ftol=1e-10)
    sol_j, sum_j = jphong.solve_phong_ba(pj, sj, jlm.SolveConfig(**cfg), linear_solver=solver,
                                         layout=(jschur.build_phong_layout(pj, J)
                                                 if solver == "schur" else None))
    sol_t, sum_t = phong.solve_phong_ba(convert.phong_problem_from_numpy(_np(pj)),
                                        convert.phong_state_from_numpy(_np(sj)),
                                        lm.SolveConfig(**cfg), linear_solver=solver)
    assert sum_t.iterations == int(sum_j.iterations)
    np.testing.assert_allclose(sum_t.final_cost, float(sum_j.final_cost), rtol=1e-8)
    _close(sol_t.poses, sol_j.poses, 1e-8)
    assert sum_t.final_cost < 1e-2 * sum_t.initial_cost
