"""Multi-process integration of the distributed layer, as tests/test_multihost.py
holds JAX: two separate processes join one process group through
``multihost.initialize`` from the ``CERES_*`` environment (a ``file://``
rendezvous), build the global mesh and the hybrid mesh by host names,
assemble the sharded normal equations on both and run the sharded LM
solve; both must return the same bits, and agree with JAX's single-process
dense reference (normal equations 1e-6 absolute, final cost 1e-9 relative,
JAX's own bounds). The processes are spawned as tests/test_torch_sharded.py
spawns them.
"""

import numpy as np
import pytest
import torch

from ceres_slam_tpu_torch.solver import lm
from tests.test_torch_sharded import assert_ranks_identical, jax_problem, start_ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from ceres_slam_tpu.solver import dense as jdense

    problem, init, port, port_init = jax_problem(0, 4, 50, 0.4)
    wait = start_ranks(tmp_path_factory.mktemp("multihost"), 2, {
        "meshes": ("meshes", "global"),
        "normal_eq": ("normal_eq", "global", port, port_init),
        "normal_eq_hybrid": ("normal_eq", "hybrid", port, port_init),
        "solve": ("solve_ba", "global", port, port_init, lm.SolveConfig(max_iters=25))})
    H_ref, _ = jdense.ba_normal_equations(problem, init)
    _, summ = jdense.solve_ba(problem, init, jdense.SolveConfig(max_iters=25))
    return wait(), np.asarray(H_ref), float(summ.final_cost)


def test_two_process_meshes(run):
    ranks, _, _ = run
    assert_ranks_identical(ranks, "meshes")
    assert ranks[0]["meshes"] == {"global": (2,), "hybrid": (1, 2)}  # one host, node-major


@pytest.mark.parametrize("name", ["normal_eq", "normal_eq_hybrid"])
def test_two_process_normal_eq(run, name):
    ranks, H_ref, _ = run
    assert_ranks_identical(ranks, name)
    assert np.abs(ranks[0][name]["H"] - H_ref).max() < 1e-6


def test_two_process_sharded_ba(run):
    ranks, _, cost_ref = run
    assert_ranks_identical(ranks, "solve")
    np.testing.assert_allclose(ranks[0]["solve"]["cost"], cost_ref, rtol=1e-9)
