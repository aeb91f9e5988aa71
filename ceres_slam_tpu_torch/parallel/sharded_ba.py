"""Distributed bundle adjustment over a ``torch.distributed`` device mesh.

Port of ``ceres_slam_tpu/parallel/sharded_ba.py``. Observations are
sharded over the ranks of a mesh (``parallel/multihost.py``); each rank
assembles the Gauss-Newton contribution of its own shard with the
single-device code, and the partial block systems are all-reduced. The
small damped solve and the retraction then run replicated on every rank,
under the port's host-controlled LM loop (``solver/lm.py``).

This is observation-parallel ("data parallel") BA. Torch has no global
arrays: a sharded problem is one rank's padded, contiguous observation
shard with the replicated rest (``shard_problem``). Every reduction goes
through ``psum``, which packs its tensors into one buffer and all-reduces
it once per mesh dimension, inner (``obs``) first and outer (``dcn``) last,
as JAX's ``psum`` over every mesh axis. The sums inside a rank have a fixed
order (``dense.segment_sum``), and every rank receives the same bits from
an all-reduce, so the host's decisions, which read only reduced or
replicated values, are the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ceres_slam_tpu_torch.parallel import multihost
from ceres_slam_tpu_torch.solver import dense, lm

OBS_AXIS = "obs"


def make_mesh() -> DeviceMesh:
    """1-D mesh over the observation axis: every rank of the process group."""
    return multihost.make_global_mesh(OBS_AXIS)


def psum(mesh: DeviceMesh, *tensors: torch.Tensor) -> tuple:
    """Sum of each tensor over every rank of ``mesh``: the tensors (of one
    dtype) packed into one buffer, all-reduced once per mesh dimension,
    the inner dimension first; returns the sums in the tensors' shapes.
    Counts its collectives and their bytes in ``psum.collectives`` and
    ``psum.bytes``."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for dim in reversed(range(mesh.ndim)):
        dist.all_reduce(flat, group=mesh.get_group(dim))
    psum.collectives += mesh.ndim
    psum.bytes += mesh.ndim * flat.numel() * flat.element_size()
    return tuple(x.view(t.shape) for x, t in zip(flat.split([t.numel() for t in tensors]),
                                                  tensors))


psum.collectives = 0
psum.bytes = 0


def pad_obs_to_multiple(stereo: dense.StereoObs, n: int) -> dense.StereoObs:
    """Pad the observation batch so it divides evenly across ``n`` ranks:
    zero measurements, identity stiffness, pose 0, landmark 0, invalid."""
    N = stereo.uvd.shape[0]
    pad = (-N) % n
    if pad == 0:
        return stereo
    eye = torch.eye(3, dtype=stereo.stiffness.dtype, device=stereo.stiffness.device)
    return dense.StereoObs(
        uvd=torch.cat([stereo.uvd, stereo.uvd.new_zeros((pad, 3))]),
        stiffness=torch.cat([stereo.stiffness, eye.expand(pad, 3, 3)]),
        pose_idx=torch.cat([stereo.pose_idx, stereo.pose_idx.new_zeros(pad)]),
        point_idx=torch.cat([stereo.point_idx, stereo.point_idx.new_zeros(pad)]),
        valid=torch.cat([stereo.valid, stereo.valid.new_zeros(pad)]),
    )


def local_rows(n_rows: int, mesh: DeviceMesh) -> slice:
    """This rank's rows of an observation array padded to ``n_rows`` (a
    multiple of the mesh's size): the shard at the rank's place in the
    mesh, node-major."""
    place = int((mesh.mesh.flatten() == dist.get_rank()).nonzero())
    m = n_rows // mesh.size()
    return slice(place * m, (place + 1) * m)


def shard_problem(problem: dense.StereoBAProblem, mesh: DeviceMesh) -> dense.StereoBAProblem:
    """This rank's observation shard (the batch padded to a multiple of the
    mesh's size, then cut into contiguous shards) with everything else
    replicated, on the problem's device."""
    stereo = pad_obs_to_multiple(problem.stereo, mesh.size())
    rows = local_rows(stereo.uvd.shape[0], mesh)
    return problem._replace(stereo=dense.StereoObs(*(x[rows] for x in stereo)))


def make_sharded_blocks(mesh: DeviceMesh):
    """Block-system assembly: the shard's stereo contribution all-reduced
    (``Hpp [K,6,6]``, ``Hll [J,3,3]``, ``W [K,J,6,3]``, ``gp``, ``gl`` in one
    buffer), then the replicated sun and prior blocks added once."""

    def blocks_fn(problem: dense.StereoBAProblem, state: dense.BAState) -> dense.BlockNormalEq:
        blocks = dense.stereo_block_contrib(problem.camera, problem.stereo, problem.point_valid,
                                            state)
        blocks = dense.BlockNormalEq(*psum(mesh, *blocks))
        Hpp_aux, gp_aux = dense.aux_pose_blocks(problem, state)
        return blocks._replace(Hpp=blocks.Hpp + Hpp_aux, gp=blocks.gp + gp_aux)

    return blocks_fn


def make_sharded_normal_eq(mesh: DeviceMesh):
    """Dense, gauge-masked ``(H, g)`` of the all-reduced block system."""
    blocks_fn = make_sharded_blocks(mesh)

    def normal_eq(problem: dense.StereoBAProblem, state: dense.BAState):
        H, g = dense.blocks_to_dense(blocks_fn(problem, state))
        return dense.apply_gauge_mask(problem, H, g)

    return normal_eq


def make_sharded_cost(mesh: DeviceMesh):
    """Cost with the stereo term all-reduced over the shards and the
    replicated sun and prior terms added once."""

    def cost(problem: dense.StereoBAProblem, state: dense.BAState) -> torch.Tensor:
        (c_stereo,) = psum(mesh, dense.stereo_sq_sum(problem, state))
        return 0.5 * c_stereo + dense.ba_cost_aux(problem, state)

    return cost


def solve_ba_sharded(problem: dense.StereoBAProblem, state0: dense.BAState, mesh: DeviceMesh,
                     config: lm.SolveConfig = lm.SolveConfig()):
    """Distributed LM solve: the single-device trust-region loop with the
    Gauss-Newton assembly and the cost sharded over the observations. Every
    rank calls it with the whole problem and the same ``state0``; every
    rank returns the same ``(state, SolveSummary)``."""
    problem = shard_problem(problem, mesh)
    normal_eq = make_sharded_normal_eq(mesh)
    cost = make_sharded_cost(mesh)
    return lm.lm_solve(state0, config, lambda s: cost(problem, s),
                       lm.dense_cholesky_step(lambda s: normal_eq(problem, s)),
                       lambda s, dx: dense._retract_state(problem, s, dx))


def gn_step_sharded(problem: dense.StereoBAProblem, state: dense.BAState,
                    mesh: DeviceMesh) -> dense.BAState:
    """One Gauss-Newton step of a sharded problem (``shard_problem``):
    the sharded assembly, then ``gn_step``, replicated."""
    return gn_step(problem, state, *make_sharded_normal_eq(mesh)(problem, state))


def gn_step(problem: dense.StereoBAProblem, state: dense.BAState, H: torch.Tensor,
            g: torch.Tensor) -> dense.BAState:
    """The damped solve of ``(H + 1e-4 diag(H)) dx = -g`` and the retraction."""
    diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
    L = lm._cholesky_or_nan(H + 1e-4 * torch.diag(diag))
    dx = torch.cholesky_solve(-g[:, None], L)[:, 0]
    return dense._retract_state(problem, state, dx)
