"""The Phong BA LM loop that the card runs in a conditional WHILE node, on the CPU.

On CUDA, ``solver/phong.solve_phong_ba`` runs each stage's LM loop as one
WHILE node (``lm.device_loop``): one LM iteration of ``lm.lm_body`` with the
Phong cost, step (vertex-Schur or dense) and retraction on the ``lm.Carry``
buffers; ``lm.host_loop`` is its plain version, the same body iterated on
the host. Here, on the 12-state Phong sim (``sim.generate_phong``, seed 7;
its full batch for the vertex-Schur solver, its ``--window 5`` problems for
the dense one):

- the body as the node runs it, iterated while its predicate holds,
  against ``host_loop`` bit for bit (every carry entry, the history
  included), for both solvers, each stage and float64 / float32;
- the body restarted on another window's ``phong_loop_inputs`` (what an
  ``lm.LMGraph`` does for a later window of a pass) against ``host_loop``
  on that window bit for bit; leaving the observations out of the copy
  gives other bits;
- JAX parity of the staged solve through this path (the host loop, the
  pass's widened tables, the factors applied by triangular solves): an
  8-state ``--window 5`` pass, ``--multistage`` (the dense solver), at
  tests/test_torch_phong_pipeline.py's tolerances; the pass's tables and
  layouts have one shape in every window;
- the switches: the device loop off the card, an unknown loop, an LMGraph
  for the host loop and a table build under a capture raise; the CLI's
  ``--lm-loop host`` writes the default run's bytes on the CPU.

The card's side (the capture, the restarts, no host work per iteration) is
in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ceres_slam_tpu.problems.dataset_phong import DatasetProblemPhong as JDatasetPhong
from ceres_slam_tpu_torch.apps import dataset_ba_phong, make_sim
from ceres_slam_tpu_torch.problems.dataset_phong import DatasetProblemPhong
from ceres_slam_tpu_torch.solver import lm, phong, phong_schur
from ceres_slam_tpu_torch.utils import sim

torch.set_num_threads(1)

STAGES = {"geometry": (False, False), "lighting": (True, True), "joint": (True, False)}
LOOP_CFG = dict(max_iters=8, ftol=1e-10, record_history=True)


@pytest.fixture(scope="module")
def phong12(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("phong_loop") / "phong12.csv")
    sim.write_phong_track_csv(sim.generate_phong(num_states=12, num_points=200, seed=7), path)
    return path


def _dataset(path, dtype="float64"):
    ds = DatasetProblemPhong.read_csv(path)
    ds.device, ds.dtype = "cpu", dtype
    return ds


def _full_batch(path, dtype):
    """The full-batch problem from the VO initial guess (vertex-Schur)."""
    ds = _dataset(path, dtype)
    ds.compute_initial_guess()
    return ds.build_window_problem(0, ds.num_states, *ds._window_budget(ds.num_states))[:2], None


def _windows(path, starts, dtype="float64"):
    """The ``--window 5`` problems at ``starts``, padded to the pass's
    budget, and the pass's table widths (the dense solver)."""
    ds = _dataset(path, dtype)
    ds.compute_initial_guess()
    budget, widths = ds._window_budget(5), ds._table_widths(5)
    return [ds.build_window_problem(k1, k1 + 5, *budget)[:2] for k1 in starts], widths


def _parts(problem, state, solver, stage, widths):
    """``(inputs, cost, step, retract)`` of one stage's LM loop, its tables
    and free vector built before the loop, as ``solve_phong_ba`` builds them."""
    use_light, freeze = STAGES[stage]
    tables = phong.solve_tables(problem, state, solver, widths)
    free = phong.free_vector(problem, state, use_light, freeze)
    fns = phong.phong_functions(problem, tables, free, use_light, False, freeze, solver)
    return (phong.phong_loop_inputs(problem, state, free, tables), *fns)


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


def _problem(path, solver, dtype):
    if solver == "schur":
        (problem, state), widths = _full_batch(path, dtype)
    else:
        [(problem, state)], widths = _windows(path, [0], dtype)
    return problem, state, widths


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_captured_body_equals_host_loop(phong12, solver, stage, dtype):
    """``lm.lm_loop``'s body with the Phong functions, iterated while its
    predicate holds, gives ``host_loop``'s bits: the state, every carry
    entry (the history, the best iterate), and ``finish``'s summary."""
    problem, state, widths = _problem(phong12, solver, dtype)
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem, state, solver, stage, widths)
    ref = lm.host_loop(state, cfg, *host)
    _, *node = _parts(problem, state, solver, stage, widths)
    lp = lm.lm_loop(state, cfg, *node)
    n = _iterate_on_host(lp)
    assert n == int(ref.it) >= 2
    _equal(lp.carry, ref)
    (sa, ma), (sb, mb) = lm.finish(lp.carry, cfg), lm.finish(ref, cfg)
    _equal(sa, sb)
    for a, b in zip(ma, mb):
        np.testing.assert_array_equal(a, b)
    assert ma.final_cost < ma.initial_cost


@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_restarted_loop_equals_host_loop(phong12, solver):
    """A loop built on window 0 of a ``--window 5`` pass, restarted on window
    3's ``phong_loop_inputs`` copied into its own (what an ``lm.LMGraph``
    does for a later window: the pass's budget and table widths give every
    window one shape), gives ``host_loop``'s bits on window 3: the inputs
    miss no tensor the body reads. Leaving the observations out of the
    copy gives other bits."""
    (a, b), widths = _windows(phong12, [0, 3])
    (problem_b, state_b) = b
    cfg = lm.SolveConfig(**LOOP_CFG)
    _, *host = _parts(problem_b, state_b, solver, "joint", widths)
    ref = lm.host_loop(state_b, cfg, *host)
    inputs_b, *_ = _parts(problem_b, state_b, solver, "joint", widths)
    for left_out in (None, problem_b.obs.uvd):
        problem_a, state_a = (lm.tree_map(torch.clone, x) for x in a)
        inputs_a, *node = _parts(problem_a, state_a, solver, "joint", widths)
        lp = lm.lm_loop(state_a, cfg, *node)
        _iterate_on_host(lp)
        assert [(t.shape, t.dtype) for t in inputs_a] == [(t.shape, t.dtype) for t in inputs_b]
        assert not torch.equal(problem_a.obs.uvd, problem_b.obs.uvd)
        lm._copy_inputs(*zip(*[(x, y) for x, y in zip(inputs_a, inputs_b) if y is not left_out]))
        lp.restart()
        _iterate_on_host(lp)
        if left_out is None:
            _equal(lp.carry, ref)
        else:
            assert not torch.equal(lp.carry.state.poses, ref.state.poses)


def test_windowed_staged_pass_matches_jax(tmp_path):
    """The sliding-window pass (--window 5 over 8 states: 4 windows) with
    the 3-stage schedule, through the host loop, the pass's widened
    tables and ``cholesky_apply``, against the JAX pass: each stage's LM
    iterations, final cost rtol 1e-8, poses and textures atol 1e-8
    (tests/test_torch_phong_pipeline.py's tolerances). Every window's
    tables and vertex-Schur layout built at the pass's widths have those
    widths: one shape, one capture a stage on the card."""
    make_sim.main([str(tmp_path), "--kind", "phong", "--num-states", "8", "--num-points", "100",
                   "--seed", "7"])
    track = str(tmp_path / "phong8.csv")
    jd = JDatasetPhong.read_csv(track)
    sums_j = jd.solve_full(window=5, multistage=True)
    td = _dataset(track)
    sums_t = td.solve_full(window=5, multistage=True, lm_loop="host")
    assert len(sums_t) == len(sums_j) == 12
    for s, r in zip(sums_t, sums_j):
        assert s.iterations == int(r.iterations)
        np.testing.assert_allclose(s.final_cost, float(r.final_cost), rtol=1e-8)
    np.testing.assert_allclose(td.poses, jd.poses, rtol=0, atol=1e-8)
    np.testing.assert_allclose(td.textures, jd.textures, rtol=0, atol=1e-8)
    widths = td._table_widths(5)
    for k1 in range(4):
        problem, state, _ = td.build_window_problem(k1, k1 + 5, *td._window_budget(5))
        tables = phong.build_tables(problem, state.phong.shape[0], widths=widths)
        layout = phong_schur.build_phong_layout(problem, widths)
        assert {k: t.shape[1] for k, t in tables.items()} == {k: widths[k] for k in tables}
        assert [t.shape[1] for t in layout] == [widths[k] for k in phong.SCHUR_KEYS]


def test_loop_switches(phong12, monkeypatch):
    """On the CPU the LM loop runs on the host by default; the device loop
    raises there (no fallback), as do an unknown loop and an LMGraph for
    the host loop; a table build (and so a body that would build its
    tables) raises under a capture; a pass's tables narrower than a window
    needs raise."""
    (problem, state), _ = _full_batch(phong12, "float64")
    cfg = lm.SolveConfig(max_iters=3)
    a = phong.solve_phong_ba(problem, state, cfg, linear_solver="schur")
    b = phong.solve_phong_ba(problem, state, cfg, linear_solver="schur", lm_loop="host")
    _equal(a[0], b[0])
    assert a[1] == b[1]
    assert phong.resolve_lm_loop("cpu", None) == "host"
    assert phong.resolve_lm_loop("cuda", None) == "device"
    assert phong.resolve_lm_loop("cuda", "host") == "host"
    with pytest.raises(ValueError, match="runs on the card"):
        phong.solve_phong_ba(problem, state, cfg, linear_solver="schur", lm_loop="device")
    with pytest.raises(ValueError, match="runs on the card"):
        phong.solve_phong_staged(problem, state, cfg, lm_loop="device")
    with pytest.raises(ValueError, match="unknown LM loop"):
        phong.solve_phong_ba(problem, state, cfg, lm_loop="scan")
    with pytest.raises(ValueError, match="takes none"):
        phong.solve_phong_ba(problem, state, cfg, lm_loop="host", graph=lm.LMGraph())
    with pytest.raises(ValueError, match="unknown linear solver"):
        phong.solve_phong_ba(problem, state, cfg, linear_solver="cg")
    with pytest.raises(ValueError, match="gather table width"):
        phong.build_tables(problem, 3, widths=dict.fromkeys(phong.ALL_KEYS, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for build in (lambda: phong.build_tables(problem, 3),
                  lambda: phong_schur.build_phong_layout(problem),
                  lambda: phong.phong_normal_equations(problem, state, True, False, False)):
        with pytest.raises(RuntimeError, match="captured loop cannot"):
            build()


def test_cli_loop_switch(phong12, tmp_path):
    """``dataset_ba_phong --lm-loop host`` on the CPU writes the default
    run's bytes with the same iterations (the host loop is the CPU's
    form); ``--lm-loop device`` raises there; argparse refuses other
    values."""
    path = str(tmp_path / "phong12.csv")
    with open(phong12) as src, open(path, "w") as dst:
        dst.write(src.read())
    argv = [path, "--multistage", "--device", "cpu", "--max-iters", "6"]
    stats = dataset_ba_phong.main(argv)
    first = [open(stats[k], "rb").read() for k in ("poses", "map", "lights")]
    again = dataset_ba_phong.main(argv + ["--lm-loop", "host"])
    assert [open(again[k], "rb").read() for k in ("poses", "map", "lights")] == first
    assert [s["iterations"] for s in again["stages"]] == [s["iterations"] for s in stats["stages"]]
    assert stats["lm_loop"] == "host"
    assert stats["lm_graph_captures"] == stats["lm_graph_restarts"] == 0
    with pytest.raises(ValueError, match="runs on the card"):
        dataset_ba_phong.main(argv + ["--lm-loop", "device"])
    with pytest.raises(SystemExit):
        dataset_ba_phong.main(argv + ["--lm-loop", "scan"])
