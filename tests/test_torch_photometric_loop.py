"""The dense frame pair's loops that the card runs as graphs, on the CPU.

On CUDA, ``solver/photometric.solve_photometric`` runs its LM loop as one
conditional WHILE node with K4 inside (``lm.device_loop``), and
``frontend/dense_stereo.match_disparity`` replays the whole matcher as one
captured CUDA graph (``MatcherGraph``); the host forms run the same
bodies launch by launch. Here, at 48x64 (one thread):

- the photometric LM loop's body iterated as the node runs it against
  ``host_loop`` bit for bit (float64, float32): every carry entry and
  ``finish``'s summary;
- a loop built on pair A, restarted after pair B's
  ``photometric_loop_inputs`` are copied in, gives B's host-loop bits; left
  without the packed texels (whose address K4's plan holds) it gives other
  bits;
- the matcher's body built on pair A's buffers and run after pair B is
  copied in equals ``match_disparity(B)`` bit for bit; both pairs match the
  JAX matcher at tests/test_torch_dense_stereo.py's tolerances (float64:
  disparity 1e-9, masks equal);
- the switches: ``--lm-loop device`` and ``--match-loop device`` raise on
  the CPU, as do the device forms of both functions and a graph given to
  a host form;
- ``--pairs N``: each pair of the sequence is ``run`` of its seed alone.

The card's side (the node, the replay, the restarts, K4's counts) is in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_slam_tpu.apps import dense_stereo as jds
from ceres_slam_tpu.frontend import dense_stereo as jfront
from ceres_slam_tpu_torch.apps import dense_stereo
from ceres_slam_tpu_torch.frontend import dense_stereo as front
from ceres_slam_tpu_torch.ops import bilinear_kernel
from ceres_slam_tpu_torch.ops import photometric as ops_ph
from ceres_slam_tpu_torch.solver import lm
from ceres_slam_tpu_torch.solver import photometric as ph

torch.set_num_threads(1)

H, W = 48, 64
LOOP_CFG = dict(max_iters=25, nonmonotonic=True, ftol=1e-12, record_history=True)


def _pair(dtype=torch.float64, seed=0):
    """The ``--gt-disparity`` problem at 48x64 (the port's
    ``synthetic_problem``)."""
    problem, state, _ = dense_stereo.synthetic_problem(H, W, seed=seed, pose_noise=0.03,
                                                       dtype=dtype, device="cpu")
    return problem, state


def _other(problem, state, seed=1):
    """Another pair of the same shape and key: the pixels in another order,
    another track image (its gradients with it), other measured
    disparities, a mask with holes, another initial state."""
    rng = np.random.default_rng(seed)
    dt, N = state.disparities.dtype, state.disparities.shape[0]
    perm = torch.as_tensor(rng.permutation(N))
    valid = torch.as_tensor(rng.random(N) > 0.1)
    disp = problem.disp_meas[perm] + torch.as_tensor(rng.normal(0, 0.2, N), dtype=dt)
    problem = problem._replace(track_img=0.9 * problem.track_img + 0.05,
                               grad_u=0.9 * problem.grad_u, grad_v=0.9 * problem.grad_v,
                               ref_uv=problem.ref_uv[perm],
                               ref_intensity=problem.ref_intensity[perm] * 1.01, valid=valid,
                               disp_meas=disp)
    T = state.T + torch.as_tensor(rng.normal(0, 1e-3, 12), dtype=dt)
    return problem, ph.PhotometricState(T=T, disparities=disp)


def _parts(problem, state):
    """``(inputs, cost, step, retract)`` of one solve's LM loop, the track
    stack packed before the loop, as ``solve_photometric`` packs it."""
    packed = ops_ph.pack_track(problem.track_img, problem.grad_u, problem.grad_v)
    return (ph.photometric_loop_inputs(problem, state, packed), *ph.lm_functions(problem, packed))


def _iterate_on_host(lp):
    """The WHILE node's semantics on the host: test ``pred``, run the body."""
    n = 0
    while int(lp.pred[0]):
        lp.body()
        n += 1
    return n


def _equal(a, b):
    for x, y in zip(lm.leaves(a), lm.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        assert torch.equal(torch.isnan(x), torch.isnan(y)) if x.is_floating_point() else True


# -- the photometric LM loop --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_captured_body_equals_host_loop(dtype):
    """``lm.lm_loop``'s body with the photometric functions, iterated while
    its predicate holds, gives ``host_loop``'s bits: every carry entry (the
    history, the best iterate) and ``finish``'s summary. K4's wrapper counts
    no launch on the CPU."""
    problem, state = _pair(dtype)
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem, state)
    ref = lm.host_loop(state, cfg, *host)
    _, *node = _parts(problem, state)
    before = bilinear_kernel.bilinear_sample_packed.launches
    lp = lm.lm_loop(state, cfg, *node)
    n = _iterate_on_host(lp)
    assert bilinear_kernel.bilinear_sample_packed.launches == before
    assert n == int(ref.it) >= 5
    _equal(lp.carry, ref)
    (sa, ma), (sb, mb) = lm.finish(lp.carry, cfg), lm.finish(ref, cfg)
    _equal(sa, sb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)
    assert ma.final_cost < 0.05 * ma.initial_cost


def test_restarted_loop_equals_host_loop():
    """A loop built on pair A and iterated, restarted after pair B's
    ``photometric_loop_inputs`` are copied into A's (what an ``lm.LMGraph``
    does for a later pair), gives ``host_loop``'s bits on B: the inputs miss
    no tensor the body reads. Left without the packed texels, the restarted
    loop reads A's track image and gives other bits."""
    problem_a, state_a = _pair()
    problem_b, state_b = _other(problem_a, state_a)
    cfg = lm.SolveConfig(**LOOP_CFG)
    inputs_b, *host = _parts(problem_b, state_b)
    ref = lm.host_loop(state_b, cfg, *host)
    texels_b = inputs_b[-1]
    for left_out in (None, texels_b):
        problem_a, state_a = _pair()
        inputs_a, *node = _parts(problem_a, state_a)
        lp = lm.lm_loop(state_a, cfg, *node)
        _iterate_on_host(lp)
        assert [(t.shape, t.dtype) for t in inputs_a] == [(t.shape, t.dtype) for t in inputs_b]
        assert not any(torch.equal(a, b) for a, b in zip(inputs_a, inputs_b))
        lm._copy_inputs(*zip(*[(a, b) for a, b in zip(inputs_a, inputs_b) if b is not left_out]))
        lp.restart()
        _iterate_on_host(lp)
        if left_out is None:
            _equal(lp.carry, ref)
        else:
            assert not torch.equal(lp.carry.state.T, ref.state.T)
    assert ph.loop_key(problem_a) == ph.loop_key(problem_b)


# -- the matcher ---------------------------------------------------------------------


def test_matcher_body_on_copied_inputs_equals_eager():
    """The matcher's body built on pair A's input buffers, run, then run
    again after pair B is copied into them, gives ``match_disparity(A)``
    and ``match_disparity(B)`` (``loop="host"``) bit for bit: the body reads
    only its buffers and constants made when it was built. Both pairs match
    the JAX matcher (float64: disparity 1e-9, masks equal)."""
    out = jds.make_scene(H=H, W=W, stereo=True)
    rng = np.random.default_rng(2)
    pair_a = (np.asarray(out[1]), np.asarray(out[7]))
    pair_b = tuple(x + 0.02 * rng.normal(size=x.shape) for x in pair_a)
    settings = front.MatchSettings(max_disp=16, block=5)
    bufs = tuple(torch.as_tensor(x).clone() for x in pair_a)
    body = front.matcher_body(*bufs, settings)
    for i, (left, right) in enumerate((pair_a, pair_b)):
        if i:
            bufs[0].copy_(torch.as_tensor(left))
            bufs[1].copy_(torch.as_tensor(right))
        disp, valid = body()
        ref = front.match_disparity(torch.as_tensor(left), torch.as_tensor(right), max_disp=16,
                                    block=5, loop="host")
        assert torch.equal(disp, ref[0]) and torch.equal(valid, ref[1])
        jdisp, jvalid = jfront.match_disparity(jnp.asarray(left), jnp.asarray(right),
                                               max_disp=16, block=5)
        np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert valid.numpy().mean() > 0.4


# -- the switches ---------------------------------------------------------------------


def test_switches_raise_on_the_cpu():
    """On the CPU both loops run on the host by default (the same bits as
    ``host`` given); the device forms raise there (no fallback), through
    the functions and the CLI, and so does a graph given to a host form or
    an unknown form."""
    problem, state = _pair()
    cfg = lm.SolveConfig(max_iters=3)
    a = ph.solve_photometric(problem, state, cfg)
    b = ph.solve_photometric(problem, state, cfg, lm_loop="host")
    _equal(a[0], b[0])
    assert a[1] == b[1]
    with pytest.raises(ValueError, match="runs on the card"):
        ph.solve_photometric(problem, state, cfg, lm_loop="device")
    with pytest.raises(ValueError, match="takes none"):
        ph.solve_photometric(problem, state, cfg, lm_loop="host", graph=lm.LMGraph())
    with pytest.raises(ValueError, match="unknown LM loop"):
        ph.solve_photometric(problem, state, cfg, lm_loop="scan")
    left = problem.track_img[:24, :32]
    assert torch.equal(front.match_disparity(left, left, max_disp=8)[0],
                       front.match_disparity(left, left, max_disp=8, loop="host")[0])
    with pytest.raises(ValueError, match="runs on the card"):
        front.match_disparity(left, left, max_disp=8, loop="device")
    with pytest.raises(ValueError, match="takes none"):
        front.match_disparity(left, left, max_disp=8, loop="host", graph=front.MatcherGraph())
    with pytest.raises(ValueError, match="unknown matcher loop"):
        front.match_disparity(left, left, max_disp=8, loop="scan")
    argv = ["--height", "24", "--width", "32", "--max-disp", "8", "--device", "cpu"]
    for extra in (["--lm-loop", "device"], ["--match-loop", "device"],
                  ["--gt-disparity", "--match-loop", "device"]):
        with pytest.raises(ValueError, match="runs on the card"):
            dense_stereo.main(argv + extra)


def test_pairs_run_in_sequence():
    """``dense_stereo --pairs 2`` (the host forms here): pair 0 is the run
    without ``--pairs``, pair 1 is ``run(seed=1)`` alone, bit for bit;
    ``--pairs`` with ``--images`` is refused."""
    argv = ["--height", "24", "--width", "32", "--gt-disparity", "--max-iters", "6",
            "--device", "cpu"]
    keys = ("T", "iterations", "initial_cost", "final_cost", "pose_err0", "pose_err1")
    two, one = dense_stereo.main(argv + ["--pairs", "2"]), dense_stereo.main(argv)
    summary, err0, err1, st = dense_stereo.run(H=24, W=32, seed=1, max_iters=6, device="cpu",
                                               verbose=False)
    alone = dict(st, iterations=summary.iterations, initial_cost=summary.initial_cost,
                 final_cost=summary.final_cost, pose_err0=err0, pose_err1=err1)
    assert len(two["later_pairs"]) == 1 and "later_pairs" not in one
    assert all(two[k] == one[k] and two["later_pairs"][0][k] == alone[k] for k in keys)
    assert two["T"] != alone["T"]
    with pytest.raises(SystemExit):
        dense_stereo.main(argv + ["--pairs", "2", "--images", "a", "b", "c"])
