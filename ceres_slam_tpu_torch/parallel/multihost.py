"""Multi-process start-up and the meshes of the distributed layer.

Port of ``ceres_slam_tpu/parallel/multihost.py`` on ``torch.distributed``.
Every rank is one process that drives one device (a card, or the CPU), so
JAX's global device list becomes the process group's ranks, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over them. Each process calls
:func:`initialize` (driven by the ``CERES_*`` environment in launch
scripts), then builds a mesh; every collective of
``parallel/sharded_ba.py`` and ``parallel/sharded_pcg.py`` runs over it.

The backend is NCCL on CUDA and gloo on the CPU. Nothing falls back: a
card that is missing, or an NCCL start that fails, raises. gloo on CUDA
tensors (several ranks sharing one card, which NCCL refuses) is used only
when the caller asks for it (``backend="gloo"``).

The hybrid mesh is ``[nodes, ranks per node]``, ranks node-major: the outer
dimension crosses nodes, the inner stays on one node's cards (NVLink),
where the observation shards' reductions run first. ``initialize`` records
every rank's host name (``on_one_host``): the sharded solves' all-reduce
over ranks of one host is the port's own kernel (``ops/allreduce_kernel``),
whose workspaces ``shutdown`` frees.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ceres_slam_tpu_torch.ops import allreduce_kernel
from ceres_slam_tpu_torch.utils import device as device_mod

_ENV_COORD = "CERES_COORDINATOR_ADDRESS"
_ENV_NPROC = "CERES_NUM_PROCESSES"
_ENV_PID = "CERES_PROCESS_ID"
_hosts: list = []  # every rank's host name, by global rank (initialize)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None, device="cuda",
               backend: str | None = None, timeout_s: float = 120.0) -> bool:
    """``torch.distributed.init_process_group`` with explicit arguments or the
    ``CERES_COORDINATOR_ADDRESS`` / ``CERES_NUM_PROCESSES`` /
    ``CERES_PROCESS_ID`` environment. The address is ``host:port`` (a TCP
    rendezvous) or a URL (``tcp://...``, or ``file:///path`` for ranks on
    one machine). On ``cuda`` the rank drives card ``local_device_ids[0]``,
    by default ``process_id`` modulo the cards a node holds (ranks
    node-major), with NCCL unless ``backend`` says otherwise; on ``cpu``
    the backend is gloo. ``timeout_s`` bounds the rendezvous and every
    collective.

    Returns True if a process group was started, False for the
    single-process case (neither an address nor a process count given), as
    JAX's does."""
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"a process group needs an address, a process count and a process id "
                         f"(got {coordinator_address!r}, {num_processes}, {process_id})")
    dev = device_mod.resolve(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only")
    kwargs = {}
    if dev.type == "cuda":
        index = (local_device_ids[0] if local_device_ids is not None
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        if backend == "nccl":  # start NCCL now, so that a failing start raises here
            kwargs["device_id"] = torch.device("cuda", index)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _hosts[:] = [None] * num_processes
    dist.all_gather_object(_hosts, socket.gethostname())
    return True


def shutdown():
    """Free the peer all-reduce's workspaces (every rank together), then end
    the process group."""
    if dist.is_initialized():
        allreduce_kernel.close_all()
        dist.destroy_process_group()
    _hosts.clear()


def on_one_host(group=None) -> bool:
    """Whether every rank of ``group`` (default: all) runs on one host, by
    the host names ``initialize`` gathered."""
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    return len({_hosts[r] for r in ranks}) == 1


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize first")
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple) -> DeviceMesh:
    # the mesh's device type names the backend: gloo's groups are "cpu" groups,
    # whatever device the tensors they reduce live on
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_global_mesh(axis_name: str = "obs") -> DeviceMesh:
    """1-D mesh over every rank of every process: the mesh of the
    observation-sharded BA and PCG paths."""
    return _mesh((_world(),), (axis_name,))


def _ranks_per_node() -> int:
    """The ranks each node holds, from the ranks' host names; raises unless
    every node holds as many, numbered node-major."""
    n = _hosts.count(_hosts[0])
    runs = [_hosts[i:i + n] for i in range(0, len(_hosts), n)]
    if not (all(r == [r[0]] * n for r in runs) and len({r[0] for r in runs}) == len(runs)):
        raise ValueError(f"ranks are not node-major with as many on every node: {_hosts}")
    return n


def make_hybrid_mesh(axis_names: tuple = ("dcn", "obs"),
                     ranks_per_node: int | None = None) -> DeviceMesh:
    """2-D ``[nodes, ranks_per_node]`` mesh: the outer dimension crosses
    nodes, the inner stays on one node. ``ranks_per_node`` defaults to the
    count of ranks on this rank's host (ranks must be numbered node-major)."""
    world = _world()
    n = ranks_per_node or _ranks_per_node()
    if world % n:
        raise ValueError(f"uneven ranks per node: {world} ranks, {n} per node")
    return _mesh((world // n, n), axis_names)


def shard_problem_global(problem, mesh: DeviceMesh):
    """Multi-process counterpart of ``sharded_ba.shard_problem``. Torch has
    no global arrays: every rank keeps its own padded, contiguous
    observation shard (jointly over all mesh dimensions, node-major) and the
    replicated rest, which is what ``shard_problem`` does on any mesh."""
    from ceres_slam_tpu_torch.parallel import sharded_ba

    return sharded_ba.shard_problem(problem, mesh)
