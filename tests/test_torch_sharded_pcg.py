"""Port parity: the distributed Schur-PCG solve (``parallel/sharded_pcg.py``,
block-Jacobi and banded) against the JAX package's, case by case as
tests/test_parallel.py's TestShardedPCG, TestShardedBandedPCG and
TestHybridMesh.test_hybrid_pcg_solve_matches_dense hold JAX: 1, 2 and 2x2
(hybrid) gloo ranks on the CPU against JAX on its 8 virtual devices. The
ranks are spawned as tests/test_torch_sharded.py spawns them (a
``file://`` rendezvous, 60 s timeouts, 120 s to finish) and run while JAX
computes. On the CPU K2 runs its plain version on each rank's shard plan.

Tolerances, JAX's own: block-Jacobi PCG final cost 1e-5 relative, poses
1e-5; banded PCG and the hybrid mesh 1e-6 and 1e-6. Every rank must return
the same bits. The ``_peer`` cases run with ``psum`` on the peer
all-reduce's route (its plain version here: the sum in rank order, as NCCL
ranks of one host reduce; tests/test_torch_sharded.py), held to the same
tolerances.
"""

import numpy as np
import pytest
import torch

from ceres_slam_tpu_torch.solver import lm
from tests.test_torch_sharded import (assert_ranks_identical, jax_problem, start_ranks,
                                      to_numpy)

torch.set_num_threads(1)

# each case's cost (relative) and pose (absolute) tolerance
TOL = {"jacobi": 1e-5, "banded": 1e-6, "banded_132": 1e-6, "masked_jacobi": 1e-5,
       "masked_banded": 1e-6, "hybrid": 1e-6}


# the cases whose device-loop body is also iterated on the host
BODY_CASES = ("jacobi", "banded")


def _banded_problem(K, J, n_obs, seed, dx_seed, mask_tail=False):
    """The banded tests' problem: ``__graft_entry__._build_example``, the
    state moved off its minimum by a seeded step; the tail masked as padding
    if asked."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from ceres_slam_tpu.solver import dense as jdense
    from ceres_slam_tpu_torch import convert

    problem, state0 = ge._build_example(K=K, J=J, n_obs=n_obs, dtype=jnp.float64, seed=seed)
    if mask_tail:
        valid = np.asarray(problem.stereo.valid).copy()
        valid[-8:] = False
        problem = problem._replace(stereo=problem.stereo._replace(valid=jnp.asarray(valid)))
    rng = np.random.default_rng(dx_seed)
    dx = np.concatenate([rng.normal(0, 0.01, 6 * K), rng.normal(0, 0.05, 3 * J)])
    init = jdense._retract_state(problem, state0, jnp.asarray(dx))
    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return (problem, init, to_numpy(convert.problem_from_numpy(np_tree(problem))),
            to_numpy(convert.state_from_numpy(np_tree(init))))


# name: (problem, LM iterations, CG tolerance, preconditioner)
CASES = {
    "jacobi": (("make", 5, 4, 50, 0.4), 25, 1e-10, "jacobi"),
    "banded": (("banded", 16, 64, 256, 3, 11), 25, 1e-10, "banded"),
    "banded_132": (("banded", 8, 66, 132, 5, 9), 15, 1e-10, "banded"),
    "masked_jacobi": (("banded_masked", 8, 64, 320, 4, 7), 20, 1e-10, "jacobi"),
    "masked_banded": (("banded_masked", 8, 64, 320, 4, 7), 20, 1e-10, "banded"),
    "hybrid": (("make", 4, 3, 40, 0.3), 20, 1e-12, "jacobi"),
}


def _problem(spec):
    kind, *args = spec
    if kind == "make":
        return jax_problem(*args)
    return _banded_problem(*args, mask_tail=kind == "banded_masked")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from jax.sharding import Mesh

    from ceres_slam_tpu.parallel import sharded_ba as jsharded_ba
    from ceres_slam_tpu.parallel import sharded_pcg as jsharded_pcg
    from ceres_slam_tpu.solver import dense as jdense

    tmp = tmp_path_factory.mktemp("sharded_pcg")
    problems = {name: _problem(spec) for name, (spec, *_) in CASES.items()}

    def case(name, mesh, kind="pcg"):
        _, iters, tol, precond = CASES[name]
        return (kind, mesh, *problems[name][2:], lm.SolveConfig(max_iters=iters), 200, tol,
                precond)

    waits = {1: start_ranks(tmp, 1, {"jacobi": case("jacobi", "global")}),
             2: start_ranks(tmp, 2, {**{name: case(name, "global") for name in CASES
                                        if name != "hybrid"},
                                     **{f"{name}_body": case(name, "global", "pcg_body")
                                        for name in BODY_CASES},
                                     "jacobi_peer": case("jacobi", "global", "peer:pcg")}),
             4: start_ranks(tmp, 4, {"hybrid": case("hybrid", "hybrid"),
                                     "hybrid_peer": case("hybrid", "hybrid", "peer:pcg")},
                            ranks_per_node=2)}

    mesh = jsharded_ba.make_mesh()
    hmesh = Mesh(np.asarray(jax.devices()).reshape(2, -1), ("dcn", "obs"))
    ref = {}
    for name, (_, iters, tol, precond) in CASES.items():
        problem, init = problems[name][:2]
        sol, summ = jsharded_pcg.solve_ba_pcg_sharded(
            problem, init, hmesh if name == "hybrid" else mesh,
            jdense.SolveConfig(max_iters=iters), max_cg_iters=200, cg_tol=tol, precond=precond)
        ref[name] = {"poses": np.asarray(sol.poses), "cost": float(summ.final_cost)}
    return {"ref": ref, **{world: wait() for world, wait in waits.items()}}


@pytest.mark.parametrize("world,name", [(1, "jacobi"), (2, "jacobi"), (2, "banded"),
                                        (2, "banded_132"), (2, "masked_jacobi"),
                                        (2, "masked_banded"), (4, "hybrid"), (2, "jacobi_peer"),
                                        (4, "hybrid_peer")],
                         ids=["jacobi1", "jacobi2", "banded2", "banded_132obs", "masked_jacobi",
                              "masked_banded", "hybrid2x2", "jacobi2_peer", "hybrid2x2_peer"])
def test_sharded_pcg_matches_jax(runs, world, name):
    ranks, ref = runs[world], runs["ref"][name.removesuffix("_peer")]
    assert_ranks_identical(ranks, name)
    got = ranks[0][name]
    tol = TOL[name.removesuffix("_peer")]
    assert got["cg_iterations"] >= got["iterations"] > 0
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=tol)
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=tol)


def test_masked_banded_equals_masked_jacobi(runs):
    """tests/test_parallel.py's masked-padding case compares the two
    preconditioners' sharded solves with each other: padding rows must not
    corrupt the banded structure."""
    got = runs[2]
    np.testing.assert_allclose(got[0]["masked_banded"]["cost"], got[0]["masked_jacobi"]["cost"],
                               rtol=1e-6)
    np.testing.assert_allclose(got[0]["masked_banded"]["poses"], got[0]["masked_jacobi"]["poses"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", BODY_CASES)
def test_node_body_on_the_host_equals_host_loops(runs, name):
    """The device LM loop's body, its CG loop on fixed buffers
    (``pcg.inner_cg``) and the shard's layout built before the loop,
    iterated on the host as the WHILE nodes run it, gives the host loops'
    (``lm.host_loop`` around ``pcg.cg``) bits, CG iterations included."""
    ranks = runs[2]
    assert_ranks_identical(ranks, f"{name}_body")
    got, ref = ranks[0][f"{name}_body"], ranks[0][name]
    for key, value in ref.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(value)), key
