"""Port parity: the distributed BA layer (``parallel/sharded_ba.py`` and the
meshes of ``parallel/multihost.py``) against the JAX package's sharded
functions, case by case as tests/test_parallel.py holds JAX to its dense
path; ``banded.slot_scatter_index`` against JAX's.

JAX side: in this process, on the 8 virtual CPU devices of
tests/conftest.py. Port side: gloo ranks on the CPU, spawned with
``torch.multiprocessing`` while JAX computes, joined through
``multihost.initialize`` from the ``CERES_*`` environment with a
``file://`` rendezvous in the test's temporary directory (no port to race
for under xdist). A rank imports torch, numpy and the port only (this
module imports JAX inside functions), gets its inputs as numpy arrays, runs
with one thread and writes its results to a file. The rendezvous and every
collective have a 60 s timeout and a group of ranks 120 s to finish, so a
hung rank fails its test instead of running the suite into its limit.

Tolerances, JAX's own (tests/test_parallel.py): normal equations 1e-9
absolute, plus 1e-12 relative (H's entries reach 6e7, where 1e-9 is below
one ulp; JAX's ``np.allclose`` adds its default 1e-5 relative); the sharded
LM solve cost 1e-6 relative, poses 1e-7; the GN step poses 1e-7. Every rank
must return the same bits. A ``peer:`` case runs with ``psum`` on the peer
all-reduce's route (``ops/allreduce_kernel``; on the CPU its plain version:
all_gather and the sum in rank order), as NCCL ranks of one host reduce,
and is held to the same tolerances; the plain all-reduce itself equals
gloo's ``all_reduce`` within float64 rounding (its sums in another order:
n ulps of the sum of magnitudes).
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing

from ceres_slam_tpu_torch.ops import allreduce_kernel
from ceres_slam_tpu_torch.parallel import multihost, sharded_ba, sharded_pcg
from ceres_slam_tpu_torch.solver import banded, dense, lm, pcg

torch.set_num_threads(1)

RENDEZVOUS_S, JOIN_S = 60.0, 120.0


def tree_map(fn, x):
    """``fn`` on every array leaf (torch or numpy) of a port container."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    return x


def to_numpy(x):
    return tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, x)


def _to_torch(x):
    return tree_map(lambda a: torch.as_tensor(a) if isinstance(a, np.ndarray) else a, x)


def _iterate_body(lp: lm.LMLoop, config: lm.SolveConfig):
    """An LM loop's body iterated on the host while its ``pred`` is set, as
    the WHILE node on the card runs it; returns ``lm.finish``'s."""
    while int(lp.pred):
        lp.body()
    return lm.finish(lp.carry, config)


def _refusals(mesh, problem, state, config) -> list:
    """The device forms on a gloo rank: each must raise, naming the cause."""
    calls = (lambda: sharded_ba.solve_ba_sharded(problem, state, mesh, config, lm_loop="device"),
             lambda: sharded_ba.gn_step_sharded(sharded_ba.shard_problem(problem, mesh), state,
                                                mesh, graph=sharded_ba.StepGraph()),
             lambda: sharded_pcg.solve_ba_pcg_sharded(problem, state, mesh, config,
                                                      lm_loop="device"),
             lambda: sharded_pcg.solve_ba_pcg_sharded(problem, state, mesh, config,
                                                      cg_loop="device"),
             lambda: sharded_pcg.solve_ba_pcg_sharded(problem, state, mesh, config,
                                                      lm_loop="device", cg_loop="host"))
    messages = []
    for call in calls:
        try:
            call()
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    return messages


def _run_case(meshes, kind, mesh_name, *args):
    """One case on this rank: the port's sharded function on the numpy
    inputs; returns numpy results. ``solve_body``, ``pcg_body``: the
    device LM loop's body (``pcg_body``: with the CG loop on fixed
    buffers, ``pcg.inner_cg``) iterated on the host. ``peer:<kind>``:
    ``kind`` with ``psum`` on the peer all-reduce's route."""
    if kind.startswith("peer:"):
        route = sharded_ba.peer_route
        sharded_ba.peer_route = lambda group: True
        try:
            return _run_case(meshes, kind[len("peer:"):], mesh_name, *args)
        finally:
            sharded_ba.peer_route = route
    mesh = meshes[mesh_name]
    args = [_to_torch(a) for a in args]
    if kind == "meshes":
        return {name: tuple(m.shape) for name, m in meshes.items()}
    if kind == "refusals":
        return {"messages": _refusals(mesh, *args)}
    if kind == "all_reduce":  # seeded per rank; the plain peer all-reduce and gloo's
        x = torch.as_tensor(np.random.default_rng(100 + torch.distributed.get_rank()).normal(
            size=args[0]) * 10.0 ** np.arange(args[0][-1]))
        group = mesh.get_group(0)
        ref = x.clone()
        torch.distributed.all_reduce(ref, group=group)
        return {"peer": allreduce_kernel.peer_all_reduce(x.clone(), group).numpy(),
                "gloo": ref.numpy(), "abs_sum": _abs_sum(x, group).numpy(),
                "launches": allreduce_kernel.peer_all_reduce.launches}
    if kind == "normal_eq":
        problem, state = args
        H, g = sharded_ba.make_sharded_normal_eq(mesh)(
            multihost.shard_problem_global(problem, mesh), state)
        return {"H": H.numpy(), "g": g.numpy()}
    if kind == "gn_step":
        problem, state = args
        out = sharded_ba.gn_step_sharded(sharded_ba.shard_problem(problem, mesh), state, mesh)
        return {"poses": out.poses.numpy(), "points": out.points.numpy()}
    problem, state, config, *pcg_args = args
    if kind == "solve_ba":
        sol, summ = sharded_ba.solve_ba_sharded(problem, state, mesh, config)
    elif kind == "solve_body":
        shard = sharded_ba.shard_problem(problem, mesh)
        fns = sharded_ba.lm_functions(shard, mesh, dense.block_tables(shard),
                                      dense.aux_terms(shard))
        sol, summ = _iterate_body(lm.lm_loop(state, config, *fns), config)
    elif kind == "pcg_body":
        max_cg_iters, cg_tol, precond = pcg_args
        prep = sharded_pcg.prepare(problem, state, mesh, precond)
        bufs = pcg.cg_buffers(state.poses.new_zeros((state.poses.shape[0], 6)))
        fns = sharded_pcg.lm_functions(prep, mesh, max_cg_iters, cg_tol, buffers=bufs)
        sol, summ = _iterate_body(lm.lm_loop(state, config, *fns), config)
    else:
        max_cg_iters, cg_tol, precond = pcg_args
        sol, summ = sharded_pcg.solve_ba_pcg_sharded(problem, state, mesh, config, max_cg_iters,
                                                     cg_tol, precond)
    return {"poses": sol.poses.numpy(), "points": sol.points.numpy(),
            "cost": summ.final_cost, "iterations": summ.iterations,
            "cg_iterations": summ.linear_iterations}


def _abs_sum(x, group):
    a = x.abs()
    torch.distributed.all_reduce(a, group=group)
    return a


def _rank_main(rank, world, rendezvous, out_dir, cases, ranks_per_node):
    """A spawned rank: join the group through the CERES_* environment, run
    every case, write the results."""
    os.environ.update(CERES_COORDINATOR_ADDRESS=f"file://{rendezvous}",
                      CERES_NUM_PROCESSES=str(world), CERES_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    if not multihost.initialize(device="cpu", timeout_s=RENDEZVOUS_S):
        raise RuntimeError("no process group started")
    try:
        meshes = {"global": multihost.make_global_mesh(),
                  "hybrid": multihost.make_hybrid_mesh(ranks_per_node=ranks_per_node)}
        results = {name: _run_case(meshes, *case) for name, case in cases.items()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        multihost.shutdown()


def start_ranks(tmp_path, world, cases, ranks_per_node=None):
    """Spawn ``world`` gloo ranks running ``cases`` ({name: (kind, mesh,
    *numpy inputs)}) on the 1-D mesh ("global") or the hybrid mesh of
    ``ranks_per_node`` ("hybrid"; by default the ranks per host); returns a
    function that waits for them (at most ``JOIN_S``) and returns each
    rank's results."""
    out = tmp_path / f"ranks{world}"
    out.mkdir()
    ctx = torch.multiprocessing.spawn(
        _rank_main, args=(world, str(out / "rendezvous"), str(out), cases, ranks_per_node),
        nprocs=world, join=False)
    t0 = time.monotonic()

    def wait():
        while not ctx.join(timeout=max(0.1, t0 + JOIN_S - time.monotonic())):
            if time.monotonic() >= t0 + JOIN_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{world} ranks did not finish in {JOIN_S:g} s")
        results = []
        for r in range(world):
            with open(out / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def assert_ranks_identical(ranks, name):
    """Every rank returned the same bits for case ``name``."""
    first = ranks[0][name]
    for other in ranks[1:]:
        for key, value in first.items():
            assert np.array_equal(np.asarray(other[name][key]), np.asarray(value)), (name, key)


def jax_problem(seed, K, J, noise_px):
    """tests/test_solver.make_problem, perturbed: ``(jax problem, jax init,
    port problem, port init)``, the port's as numpy arrays."""
    import jax

    from ceres_slam_tpu_torch import convert
    from tests.test_solver import make_problem, perturb

    problem, gt, key = make_problem(jax.random.PRNGKey(seed), K=K, J=J, noise_px=noise_px)
    init = perturb(gt, key)
    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return (problem, init, to_numpy(convert.problem_from_numpy(np_tree(problem))),
            to_numpy(convert.state_from_numpy(np_tree(init))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases of tests/test_parallel.py's TestShardedNormalEquations and
    TestHybridMesh.test_normal_eq_matches_dense on 2 ranks and on a 2x2
    hybrid mesh (and the first on a 1-D mesh of 4), with JAX's sharded
    results computed while the ranks run."""
    import jax

    from ceres_slam_tpu.parallel import sharded_ba as jsharded_ba
    from ceres_slam_tpu.solver import dense as jdense
    from jax.sharding import Mesh

    tmp = tmp_path_factory.mktemp("sharded")
    problems = {"normal_eq": jax_problem(0, 4, 50, 0.4), "solve": jax_problem(1, 3, 40, 0.3),
                "gn_step": jax_problem(2, 3, 30, 0.2), "hybrid": jax_problem(3, 4, 50, 0.4)}
    cfg = lm.SolveConfig(max_iters=25)
    wait2 = start_ranks(tmp, 2, {
        "normal_eq": ("normal_eq", "global", *problems["normal_eq"][2:]),
        "solve": ("solve_ba", "global", *problems["solve"][2:], cfg),
        "solve_body": ("solve_body", "global", *problems["solve"][2:], cfg),
        "refusals": ("refusals", "global", *problems["solve"][2:], cfg),
        "gn_step": ("gn_step", "global", *problems["gn_step"][2:]),
        "all_reduce": ("all_reduce", "global", (5, 7)),
        "solve_peer": ("peer:solve_ba", "global", *problems["solve"][2:], cfg),
        "gn_step_peer": ("peer:gn_step", "global", *problems["gn_step"][2:])})
    wait4 = start_ranks(tmp, 4, {
        "hybrid": ("normal_eq", "hybrid", *problems["hybrid"][2:]),
        "normal_eq": ("normal_eq", "global", *problems["normal_eq"][2:]),
        "all_reduce": ("all_reduce", "global", (3, 11)),
        "hybrid_peer": ("peer:normal_eq", "hybrid", *problems["hybrid"][2:])},
        ranks_per_node=2)

    mesh = jsharded_ba.make_mesh()
    hmesh = Mesh(np.asarray(jax.devices()).reshape(2, -1), ("dcn", "obs"))
    ref = {}
    for name, m in (("normal_eq", mesh), ("hybrid", hmesh)):
        problem, init = problems[name][:2]
        H, g = jax.jit(jsharded_ba.make_sharded_normal_eq(m))(
            jsharded_ba.shard_problem(problem, m), init)
        ref[name] = {"H": np.asarray(H), "g": np.asarray(g)}
    problem, init = problems["solve"][:2]
    sol, summ = jsharded_ba.solve_ba_sharded(problem, init, mesh, jdense.SolveConfig(max_iters=25))
    ref["solve"] = {"poses": np.asarray(sol.poses), "cost": float(summ.final_cost)}
    problem, init = problems["gn_step"][:2]
    out = jsharded_ba.gn_step_sharded(jsharded_ba.shard_problem(problem, mesh), init, mesh)
    ref["gn_step"] = {"poses": np.asarray(out.poses),
                      "cost0": float(jdense.ba_cost(problem, init)),
                      "cost1": float(jdense.ba_cost(problem, out))}
    return {"ref": ref, "problems": problems, 2: wait2(), 4: wait4()}


@pytest.mark.parametrize("world,name", [(2, "normal_eq"), (4, "normal_eq"), (4, "hybrid"),
                                        (4, "hybrid_peer")],
                         ids=["2", "4", "hybrid2x2", "hybrid2x2_peer"])
def test_normal_eq_matches_jax(runs, world, name):
    ranks = runs[world]
    assert_ranks_identical(ranks, name)
    ref = runs["ref"][name.removesuffix("_peer")]
    np.testing.assert_allclose(ranks[0][name]["H"], ref["H"], rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(ranks[0][name]["g"], ref["g"], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("name", ["solve", "solve_peer"])
def test_sharded_solve_matches_jax(runs, name):
    ranks, ref = runs[2], runs["ref"]["solve"]
    assert_ranks_identical(ranks, name)
    got = ranks[0][name]
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-6)
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_peer_all_reduce_plain_matches_all_reduce(runs, world):
    """The peer all-reduce's plain version (gloo ranks on the CPU: all_gather
    and the sum in rank order, left to right) gives every rank the same
    bits, equal to gloo's all_reduce within float64 rounding: n ulps of the
    sum of magnitudes, entries spread over 11 decades. It launches no
    kernel."""
    ranks = runs[world]
    assert_ranks_identical(ranks, "all_reduce")
    got = ranks[0]["all_reduce"]
    bound = world * np.finfo(np.float64).eps * got["abs_sum"]
    assert np.all(np.abs(got["peer"] - got["gloo"]) <= bound)
    assert got["launches"] == 0
    # rank order, left to right: the plain sum of the seeded inputs
    parts = [np.random.default_rng(100 + r).normal(size=got["peer"].shape)
             * 10.0 ** np.arange(got["peer"].shape[-1]) for r in range(world)]
    acc = parts[0].copy()
    for p in parts[1:]:
        acc += p
    assert np.array_equal(got["peer"], acc)


def test_node_body_on_the_host_equals_host_loop(runs):
    """The device LM loop's body (its tables and terms built before the
    loop) iterated on the host, as the WHILE node runs it, gives the host
    loop's bits on every rank."""
    ranks = runs[2]
    assert_ranks_identical(ranks, "solve_body")
    for key, value in ranks[0]["solve"].items():
        assert np.array_equal(np.asarray(ranks[0]["solve_body"][key]), np.asarray(value)), key


def test_device_loops_refused_on_gloo(runs):
    """On gloo ranks (here on the CPU) every device form raises, naming the
    cause; the device LM loop with the host CG loop raises too."""
    ranks = runs[2]
    assert_ranks_identical(ranks, "refusals")
    messages = ranks[0]["refusals"]["messages"]
    assert all(m is not None and "NCCL" in m for m in messages[:4]), messages
    assert messages[4] is not None and "needs cg_loop='device'" in messages[4], messages


@pytest.mark.parametrize("ranks,hosts,form", [(1, 1, "device"), (4, 1, "device"),
                                              (4, 2, "host")])
def test_loop_form_on_nccl_meshes(monkeypatch, ranks, hosts, form):
    """On an NCCL mesh whose ranks share a host (one rank, or four, where the
    all-reduce is the peer kernel) the device form is the default; on a mesh
    that spans hosts (its all-reduce stays NCCL's) the host form is, and the
    device form raises, naming the cause."""

    class Mesh:  # a 1-D NCCL mesh of ``ranks`` ranks, as resolve_loop reads it
        ndim = 1

        def get_group(self, dim):
            return None

        def size(self):
            return ranks

    monkeypatch.setattr(sharded_ba.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(sharded_ba.multihost, "on_one_host", lambda group=None: hosts == 1)
    assert sharded_ba.resolve_loop(Mesh(), None) == form
    assert sharded_pcg.resolve_loops(Mesh(), None, None) == (form, form)
    assert sharded_ba.resolve_loop(Mesh(), "host") == "host"
    if hosts > 1:
        with pytest.raises(ValueError, match="span hosts"):
            sharded_ba.resolve_loop(Mesh(), "device")
    else:
        assert sharded_ba.resolve_loop(Mesh(), "device") == "device"


@pytest.mark.parametrize("name", ["gn_step", "gn_step_peer"])
def test_gn_step_matches_jax(runs, name):
    """The sharded GN step reduces the cost from a perturbed state (as JAX's
    test asserts) and lands on JAX's step."""
    ranks, ref = runs[2], runs["ref"]["gn_step"]
    assert_ranks_identical(ranks, name)
    got = ranks[0][name]
    assert np.all(np.isfinite(got["poses"]))
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=1e-7)
    problem, init = (_to_torch(x) for x in runs["problems"]["gn_step"][2:])
    out = dense.BAState(torch.as_tensor(got["poses"]), torch.as_tensor(got["points"]))
    c0, c1 = float(dense.ba_cost(problem, init)), float(dense.ba_cost(problem, out))
    assert c1 < c0
    np.testing.assert_allclose(c1, ref["cost1"], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_pad_obs_to_multiple_matches_jax(n):
    import jax

    from ceres_slam_tpu.parallel import sharded_ba as jsharded_ba

    problem, _, port, _ = jax_problem(0, 4, 50, 0.4)
    ref = jsharded_ba.pad_obs_to_multiple(problem.stereo, n)
    got = sharded_ba.pad_obs_to_multiple(_to_torch(port).stereo, n)
    assert got.uvd.shape[0] % n == 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert jax.tree.structure(ref).num_leaves == len(got)


@pytest.mark.parametrize("K,J,n_obs,seed", [(16, 64, 256, 3), (8, 66, 132, 5), (8, 64, 320, 4)])
def test_slot_scatter_index_matches_jax(K, J, n_obs, seed):
    """On the banded PCG tests' problems (the last with its tail masked as
    padding): the port's slot routing equals JAX's."""
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from ceres_slam_tpu.solver import banded as jbanded

    problem, _ = ge._build_example(K=K, J=J, n_obs=n_obs, dtype=jnp.float64, seed=seed)
    st = problem.stereo
    valid = np.asarray(st.valid).copy()
    if seed == 4:
        valid[-8:] = False
    ref = jbanded.slot_scatter_index(
        jbanded.build_track_info(st.pose_idx, st.point_idx, K, J, valid=jnp.asarray(valid)), n_obs)
    tracks = banded.build_track_info(np.asarray(st.pose_idx), np.asarray(st.point_idx), K, J,
                                     valid=valid)
    got = banded.slot_scatter_index(tracks, n_obs)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    eligible = got[got < J * tracks.L]
    assert eligible.size == np.unique(eligible).size  # a slot has one observation


def test_initialize_without_a_coordinator_is_single_process(monkeypatch):
    for name in ("CERES_COORDINATOR_ADDRESS", "CERES_NUM_PROCESSES", "CERES_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    with pytest.raises(ValueError, match="process id"):
        multihost.initialize("localhost:1", 2, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("localhost:1", 2, 0, device="cpu", backend="nccl")


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        sharded_ba.make_mesh()


def _record_jax_figures(data: str):
    """The JAX figures that chip_smoke.py's dist phase holds the port's
    triangle200 runs to: the port's make_sim sim (seed 0, byte-identical
    to the JAX package's), read by the JAX dataset layer, its VO initial
    guess, the full-batch problem as dataset_vo --window 0 builds it, and
    the sharded functions on the 8 virtual CPU devices with solve_full's
    float64 configuration (float64, on the CPU)."""
    import time

    import jax

    from ceres_slam_tpu.parallel import sharded_ba as jsharded_ba
    from ceres_slam_tpu.parallel import sharded_pcg as jsharded_pcg
    from ceres_slam_tpu.problems.dataset import DatasetProblem as JDataset
    from ceres_slam_tpu.solver import dense as jdense
    from ceres_slam_tpu_torch.apps import make_sim

    base = os.path.join(data, "triangle200")
    if not os.path.exists(base + "_vo.csv"):
        make_sim.main([data, "--kind", "triangle", "--num-states", "200", "--sun-noise", "10"])
    jds = JDataset.read_csv(base + "_vo.csv")
    jds.compute_initial_guess()
    n_obs_pad, n_pts_pad, _ = jds._window_budget(jds.num_states)
    problem, state, _ = jds.build_window_problem(0, jds.num_states, n_obs_pad, n_pts_pad)
    config = jdense.SolveConfig(max_iters=1000, nonmonotonic=True, ftol=1e-6, xtol=1e-6)
    mesh = jsharded_ba.make_mesh()
    print(f"{len(jax.devices())} devices; N {problem.stereo.uvd.shape[0]}, initial cost "
          f"{float(jdense.ba_cost(problem, state))!r}", flush=True)
    t0 = time.perf_counter()
    out = jsharded_ba.gn_step_sharded(jsharded_ba.shard_problem(problem, mesh), state, mesh)
    print(f"gn_step_sharded: cost {float(jdense.ba_cost(problem, out))!r} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    runs = (("solve_ba_sharded",
             lambda: jsharded_ba.solve_ba_sharded(problem, state, mesh, config)),
            *((f"solve_ba_pcg_sharded {p}", lambda p=p: jsharded_pcg.solve_ba_pcg_sharded(
                problem, state, mesh, config, precond=p)) for p in ("jacobi", "banded")))
    for name, run in runs:
        t0 = time.perf_counter()
        _, summ = run()
        print(f"{name}: {int(summ.iterations)} iterations, cost {float(summ.initial_cost)!r} -> "
              f"{float(summ.final_cost)!r} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sharded.py DIR
    import sys

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _record_jax_figures(sys.argv[1])
