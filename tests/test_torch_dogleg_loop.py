"""The dense dogleg loop that the card runs in a conditional WHILE node, on the CPU.

On CUDA, ``dense.solve_ba(strategy="dogleg")`` (and ``FactorGraph.solve``
with it) runs ``lm.dogleg_body`` in a WHILE node (``lm.dogleg_loop``
through ``dense.minimize``); ``lm_loop="host"`` iterates the same body on
the host. Here, in float64 unless it says otherwise:

- the body iterated as the node runs it against JAX's ``dogleg_solve`` on
  tests/test_torch_graph.py::test_dogleg_solve_matches_jax's problem, with
  that test's bounds (the same iterations, final cost rtol 1e-9, final
  radius rtol 1e-6, poses 1e-8), and against the host loop bit for bit
  (float64, float32);
- a loop built on one problem, restarted on another problem's
  ``dense_loop_inputs``, gives the host loop's bits (a missing input reads
  the first problem's data);
- the switches: the device loop off the card, a graph for the host loop
  and an unknown loop raise.

The card's side is in tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ceres_slam_tpu.solver import dense as jdense
from ceres_slam_tpu.solver import lm as jlm
from ceres_slam_tpu_torch import convert
from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
from ceres_slam_tpu_torch.solver import dense, lm
from ceres_slam_tpu_torch.solver.graph import FactorGraph

torch.set_num_threads(1)

CFG = lm.SolveConfig(max_iters=100)


def _np(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def ba():
    """tests/test_torch_graph.py's ``ba`` problem (sun, prior, Huber loss,
    off its optimum) in both packages."""
    problem, state = ge._build_example(K=6, J=48, n_obs=240, dtype=jnp.float64, seed=5)
    rng = np.random.default_rng(2)
    dx = np.concatenate([rng.normal(0, 0.01, 36), rng.normal(0, 0.05, 144)])
    state = jdense._retract_state(problem, state, jnp.asarray(dx))
    return (problem, state), (convert.problem_from_numpy(_np(problem)),
                              convert.state_from_numpy(_np(state)))


def _cast(x, dtype):
    return lm.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, x)


def _parts(problem, state, widths=None):
    """``(inputs, cost, normal_eq, retract)`` of one dogleg solve, its tables
    and terms made before the loop, as ``dense.minimize`` makes them."""
    tables = dense.block_tables(problem, widths)
    terms = dense.aux_terms(problem)
    return (dense.dense_loop_inputs(problem, state, terms, tables),
            *dense.dogleg_functions(problem, tables, terms))


def _iterate_on_host(lp):
    """The WHILE node's semantics on the host: test ``pred``, run the body."""
    n = 0
    while int(lp.pred[0]):
        lp.body()
        n += 1
    return n


def _summary(lp):
    return lm.summary(lm._dogleg_stats(lp.carry), CFG)


def _equal(a, b):
    for x, y in zip(lm.leaves(a), lm.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_dogleg_body_matches_jax(ba):
    """``dogleg_loop``'s body iterated while its predicate holds against
    JAX's ``solve_ba(strategy="dogleg")``: the same iterations, initial cost
    rtol 1e-12, final cost rtol 1e-9, final radius rtol 1e-6, poses 1e-8."""
    (jp, js), (p, s) = ba
    _, *fns = _parts(p, s)
    lp = lm.dogleg_loop(s, CFG, *fns)
    n = _iterate_on_host(lp)
    summ = _summary(lp)
    jsol, jsumm = jdense.solve_ba(jp, js, jlm.SolveConfig(max_iters=100), strategy="dogleg")
    assert n == summ.iterations == int(jsumm.iterations) > 1
    np.testing.assert_allclose(summ.initial_cost, float(jsumm.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(summ.final_cost, float(jsumm.final_cost), rtol=1e-9)
    np.testing.assert_allclose(summ.final_lambda, float(jsumm.final_lambda), rtol=1e-6)
    np.testing.assert_allclose(lp.carry.state.poses.numpy(), np.asarray(jsol.poses), atol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_dogleg_body_equals_host_loop(ba, dtype):
    """The body iterated as the node runs it gives ``dogleg_solve``'s host
    loop's bits (``solve_ba(strategy="dogleg", lm_loop="host")``, the
    CPU's default): the state, the carry's numbers and the summary."""
    _, (p, s) = ba
    p, s = _cast(p, dtype), _cast(s, dtype)
    _, *fns = _parts(p, s)
    lp = lm.dogleg_loop(s, CFG, *fns)
    _iterate_on_host(lp)
    sol, summ = dense.solve_ba(p, s, CFG, strategy="dogleg", lm_loop="host")
    _equal(lp.carry.state, sol)
    assert _summary(lp) == summ
    assert summ == dense.solve_ba(p, s, CFG, strategy="dogleg")[1]
    assert lp.carry.cost.dtype == dtype and summ.final_cost < summ.initial_cost


def test_restarted_dogleg_loop_equals_host_loop(ba):
    """A loop built on one problem, restarted on another's
    ``dense_loop_inputs`` copied into its own (what an ``lm.LMGraph`` does
    for a later solve), gives the host loop's bits on the second; left
    without the observations it gives other bits."""
    _, (pa, sa) = ba
    rng = np.random.default_rng(7)
    st = pa.stereo
    pb = pa._replace(stereo=st._replace(uvd=st.uvd + torch.as_tensor(rng.normal(0, 0.3, st.uvd.shape)),
                                        stiffness=st.stiffness * 1.1))
    sb = dense.BAState(sa.poses + torch.as_tensor(rng.normal(0, 1e-3, sa.poses.shape)),
                       sa.points + torch.as_tensor(rng.normal(0, 0.02, sa.points.shape)))
    ref = dense.solve_ba(pb, sb, CFG, strategy="dogleg", lm_loop="host")
    inputs_b, *_ = _parts(pb, sb)
    for left_out in (None, pb.stereo.uvd):
        inputs_a, *fns = _parts(lm.tree_map(torch.clone, pa), lm.tree_map(torch.clone, sa))
        lp = lm.dogleg_loop(dense.BAState(*inputs_a[-2:]), CFG, *fns)
        _iterate_on_host(lp)
        lm._copy_inputs(*zip(*[(a, b) for a, b in zip(inputs_a, inputs_b) if b is not left_out]))
        lp.restart()
        _iterate_on_host(lp)
        if left_out is None:
            _equal(lp.carry.state, ref[0])
            assert _summary(lp) == ref[1]
        else:
            assert not torch.equal(lp.carry.state.poses, ref[0].poses)


def test_dogleg_switches(ba):
    """The dogleg's device loop raises off the card, through ``solve_ba``
    and ``FactorGraph.solve``; so do a graph for the host loop and an
    unknown loop."""
    _, (p, s) = ba
    cfg = lm.SolveConfig(max_iters=3)
    with pytest.raises(ValueError, match="device dogleg loop runs on the card"):
        dense.solve_ba(p, s, cfg, strategy="dogleg", lm_loop="device")
    with pytest.raises(ValueError, match="takes none"):
        dense.solve_ba(p, s, cfg, strategy="dogleg", lm_loop="host", graph=lm.LMGraph())
    with pytest.raises(ValueError, match="unknown dogleg loop"):
        dense.solve_ba(p, s, cfg, strategy="dogleg", lm_loop="scan")
    with pytest.raises(ValueError, match="unknown LM loop"):
        lm.dogleg_solve(s, cfg, *_parts(p, s)[1:], loop="scan")
    g = FactorGraph(StereoCamera.create(400.0, 400.0, 320.0, 240.0, 0.5), device="cpu")
    g.add_pose(np.concatenate([np.zeros(3), np.eye(3).reshape(9)]), fixed=True)
    with pytest.raises(ValueError, match="device dogleg loop runs on the card"):
        g.solve(linear_solver="dense", strategy="dogleg", lm_loop="device")
