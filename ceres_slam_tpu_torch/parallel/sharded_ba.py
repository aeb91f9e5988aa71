"""Distributed bundle adjustment over a ``torch.distributed`` device mesh.

Port of ``ceres_slam_tpu/parallel/sharded_ba.py``. Observations are
sharded over the ranks of a mesh (``parallel/multihost.py``); each rank
assembles the Gauss-Newton contribution of its own shard with the
single-device code, and the partial block systems are all-reduced. The
small damped solve and the retraction then run replicated on every rank,
under the port's LM loop (``solver/lm.py``).

This is observation-parallel ("data parallel") BA. Torch has no global
arrays: a sharded problem is one rank's padded, contiguous observation
shard with the replicated rest (``shard_problem``). Every reduction goes
through ``psum``, which packs its tensors into one buffer and all-reduces
it once per mesh dimension, inner (``obs``) first and outer (``dcn``) last,
as JAX's ``psum`` over every mesh axis. On an NCCL mesh whose ranks share a
host, each of those all-reduces is the port's kernel
(``ops/allreduce_kernel.peer_all_reduce``: every rank reads its peers'
buffers and sums them in rank order); across hosts it is NCCL's, and on
gloo ranks gloo's. The sums inside a rank have a fixed order
(``dense.gather_sum`` through the shard's ``dense.block_tables``), and
every rank receives the same bits from an all-reduce, so the loop's
decisions, which read only reduced or replicated values, are the same on
every rank.

The loop's forms, as JAX's ``lax.while_loop`` under ``jax.jit``
(``resolve_loop``): on an NCCL mesh whose every dimension stays on one
host (one rank, the ranks of one machine's cards, the hybrid mesh on one
machine) by default the whole LM solve is one conditional WHILE node on
the card (``lm.device_loop``), the peer all-reduce kernels captured inside
it; on gloo ranks (the CPU, or ranks that share a card) the loop runs on
the host (``lm.host_loop``), and ``device`` there raises: gloo's
collectives run on the host, which a graph cannot capture. So does a mesh
that spans hosts, whose all-reduce stays NCCL's: captured on several ranks
it holds event record and wait nodes, which a WHILE body cannot hold
(ROADMAP item 21b). The two forms give the same bits.
What the loop reads is built before it: the shard's gather tables, the
sun and prior terms (``dense.aux_terms``) and the all-reduce's workspaces
(``reserve``, at the largest buffer the loop reduces). ``gn_step_sharded``
replays one captured graph per shape when given a ``StepGraph`` (JAX jits
that step).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ceres_slam_tpu_torch.ops import allreduce_kernel, graph_loop
from ceres_slam_tpu_torch.parallel import multihost
from ceres_slam_tpu_torch.solver import dense, lm

OBS_AXIS = "obs"


def make_mesh() -> DeviceMesh:
    """1-D mesh over the observation axis: every rank of the process group."""
    return multihost.make_global_mesh(OBS_AXIS)


def peer_route(group) -> bool:
    """Whether ``psum`` reduces over ``group`` with the peer all-reduce
    kernel: an NCCL group whose ranks share a host."""
    return dist.get_backend(group) == "nccl" and multihost.on_one_host(group)


def psum(mesh: DeviceMesh, *tensors: torch.Tensor) -> tuple:
    """Sum of each tensor over every rank of ``mesh``: the tensors (of one
    dtype) packed into one buffer, all-reduced once per mesh dimension,
    the inner dimension first (``peer_all_reduce`` where ``peer_route``
    holds, else the group's backend); returns the sums in the tensors'
    shapes. Counts its collectives and their bytes in ``psum.collectives``
    and ``psum.bytes`` (its ``counters``: a captured loop that lists
    ``COUNTED`` scales them, and the kernel's launches, by the iterations
    the card ran). Safe under a capture on a peer route: one kernel on the
    current stream, no host synchronization (its workspace ``reserve``d
    before)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for dim in reversed(range(mesh.ndim)):
        group = mesh.get_group(dim)
        if peer_route(group):
            allreduce_kernel.peer_all_reduce(flat, group)
        else:
            dist.all_reduce(flat, group=group)
    psum.collectives += mesh.ndim
    psum.bytes += mesh.ndim * flat.numel() * flat.element_size()
    return tuple(x.view(t.shape) for x, t in zip(flat.split([t.numel() for t in tensors]),
                                                  tensors))


psum.collectives = 0
psum.bytes = 0
psum.counters = ("collectives", "bytes")
# the wrappers whose counts a captured sharded loop scales per iteration
COUNTED = (psum, allreduce_kernel.peer_all_reduce)


def reserve(mesh: DeviceMesh, numel: int, like: torch.Tensor) -> None:
    """Make the peer all-reduce's workspaces of ``mesh`` hold a packed
    buffer of ``numel`` elements of ``like``'s dtype on its device, before a
    loop (every rank together; nothing where ``peer_route`` does not hold)."""
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        if peer_route(group):
            allreduce_kernel.reserve(group, numel * like.element_size(), like.device)


def dense_psum_numel(K: int, J: int) -> int:
    """The largest buffer a dense sharded solve reduces: the block system
    ``Hpp``, ``Hll``, ``W``, ``gp``, ``gl``."""
    return K * 36 + J * 9 + K * J * 18 + K * 6 + J * 3


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


def resolve_loop(mesh: DeviceMesh, loop: str | None, name: str = "LM loop",
                 switch: str = "lm_loop") -> str:
    """The form of a sharded loop (``graph_loop.resolve_loop``'s): on an
    NCCL mesh whose every dimension's ranks share a host (``peer_route``)
    ``"device"`` by default; on gloo ranks and on NCCL meshes that span
    hosts ``"host"``, where ``"device"`` raises, naming the cause: gloo runs
    its all-reduce on the host, which a captured loop cannot hold; across
    hosts the all-reduce is NCCL's, whose capture on several ranks holds
    event record and wait nodes (its graph-mixing support), which a WHILE
    body cannot hold (on four cards such a node hung; ROADMAP item 21b).
    Nothing falls back."""
    backend = dist.get_backend(mesh.get_group(0))
    cause = None
    if backend != "nccl":
        cause = (f"it captures its all-reduces in a CUDA graph, which takes NCCL meshes only "
                 f"({backend} ranks run theirs on the host)")
    else:
        spans = [dim for dim in range(mesh.ndim) if not peer_route(mesh.get_group(dim))]
        if spans:
            cause = (f"mesh dimension(s) {spans} span hosts, where the all-reduce is NCCL's, "
                     f"whose capture holds event record and wait nodes, which a WHILE body "
                     f"cannot hold (ROADMAP item 21b); the captured forms take the peer "
                     f"all-reduce of the ranks of one host")
    if loop == "device" and cause:
        raise ValueError(f"the device {name} cannot run here: {cause}: use {switch}='host'")
    return graph_loop.resolve_loop("cpu" if cause else "cuda", loop, name, switch)


def make_sharded_blocks(mesh: DeviceMesh, tables: dense.BlockTables, terms: dense.AuxTerms):
    """Block-system assembly: the shard's stereo contribution through its
    gather ``tables`` (``dense.block_tables`` of the shard), all-reduced
    (``Hpp [K,6,6]``, ``Hll [J,3,3]``, ``W [K,J,6,3]``, ``gp``, ``gl`` in
    one buffer), then the replicated sun and prior blocks of ``terms``
    (``dense.aux_terms``) added once. Both are built before a loop: the
    assembly reads nothing on the host."""

    def blocks_fn(problem: dense.StereoBAProblem, state: dense.BAState) -> dense.BlockNormalEq:
        blocks = dense.stereo_block_contrib(problem.camera, problem.stereo, problem.point_valid,
                                            state, tables)
        blocks = dense.BlockNormalEq(*psum(mesh, *blocks))
        Hpp_aux, gp_aux = dense.aux_blocks(terms, state)
        return blocks._replace(Hpp=blocks.Hpp + Hpp_aux, gp=blocks.gp + gp_aux)

    return blocks_fn


def make_sharded_normal_eq(mesh: DeviceMesh, tables: dense.BlockTables | None = None,
                           terms: dense.AuxTerms | None = None):
    """Dense, gauge-masked ``(H, g)`` of the all-reduced block system
    (``make_sharded_blocks``). Tables or terms not given are built from the
    problem at each call (a host round trip)."""

    def normal_eq(problem: dense.StereoBAProblem, state: dense.BAState):
        blocks_fn = make_sharded_blocks(
            mesh, dense.block_tables(problem) if tables is None else tables,
            dense.aux_terms(problem) if terms is None else terms)
        H, g = dense.blocks_to_dense(blocks_fn(problem, state))
        return dense.apply_gauge_mask(problem, H, g)

    return normal_eq


def make_sharded_cost(mesh: DeviceMesh, terms: dense.AuxTerms):
    """Cost with the stereo term all-reduced over the shards and the
    replicated sun and prior terms (``dense.aux_terms``) added once."""

    def cost(problem: dense.StereoBAProblem, state: dense.BAState) -> torch.Tensor:
        (c_stereo,) = psum(mesh, dense.stereo_sq_sum(problem, state))
        return 0.5 * c_stereo + dense.aux_cost(terms, state)

    return cost


def loop_key(problem: dense.StereoBAProblem, mesh: DeviceMesh, *settings) -> tuple:
    """What a sharded loop's captured body holds as Python values: the
    camera, the prior's pose, the mesh (its communicators) and the
    caller's ``settings``."""
    return (problem.camera, int(problem.prior.pose_idx), id(mesh), *settings)


def lm_functions(shard: dense.StereoBAProblem, mesh: DeviceMesh, tables: dense.BlockTables,
                 terms: dense.AuxTerms):
    """The LM core's ``(cost_fn, step_fn, retract_fn)`` of a sharded dense
    solve of ``shard`` (``shard_problem``) over its gather ``tables`` and
    sun and prior ``terms``, built before the loop: none of them reads the
    device from the host."""
    normal_eq = make_sharded_normal_eq(mesh, tables, terms)
    cost = make_sharded_cost(mesh, terms)
    return (lambda s: cost(shard, s), lm.dense_cholesky_step(lambda s: normal_eq(shard, s)),
            lambda s, dx: dense._retract_state(shard, s, dx))


def solve_ba_sharded(problem: dense.StereoBAProblem, state0: dense.BAState, mesh: DeviceMesh,
                     config: lm.SolveConfig = lm.SolveConfig(), lm_loop: str | None = None,
                     graph: lm.LMGraph | None = None):
    """Distributed LM solve: the single-device trust-region loop with the
    Gauss-Newton assembly and the cost sharded over the observations. Every
    rank calls it with the whole problem and the same ``state0``; every
    rank returns the same ``(state, SolveSummary)``.

    ``lm_loop``: ``"device"`` (the default on an NCCL mesh of one host)
    runs the loop as one WHILE node with the all-reduces inside, kept in
    ``graph`` (an ``lm.LMGraph``) for the next solve of the same shape,
    which copies its ``dense.dense_loop_inputs`` in and restarts it;
    ``"host"`` (the default elsewhere, where ``"device"`` raises:
    ``resolve_loop``) iterates on the host. Both give the same bits."""
    lm_loop = resolve_loop(mesh, lm_loop)
    if lm_loop == "host" and graph is not None:
        raise ValueError("an LMGraph keeps the device LM loop: lm_loop='host' takes none")
    shard = shard_problem(problem, mesh)
    reserve(mesh, dense_psum_numel(state0.poses.shape[0], state0.points.shape[0]), state0.poses)
    tables, terms = dense.block_tables(shard), dense.aux_terms(shard)
    fns = lm_functions(shard, mesh, tables, terms)
    if lm_loop == "host":
        return lm.lm_solve(state0, config, *fns, loop="host")
    state0 = lm.tree_map(torch.clone, state0)  # the loop's own: a restart copies into it
    return lm.lm_solve(state0, config, *fns, loop="device", counted=COUNTED, graph=graph,
                       inputs=dense.dense_loop_inputs(shard, state0, terms, tables),
                       key=loop_key(shard, mesh, "sharded dense"))


class StepGraph:
    """``gn_step_sharded`` captured once per shape in a plain CUDA graph
    (``graph_loop.DeviceGraph``) and replayed for every step of that shape
    (``frontend/dense_stereo.MatcherGraph``'s pattern): a step copies its
    state, and its problem's tensors, gather tables and terms where the
    problem is not the one the graph last read, into the capture's own
    buffers, replays, and clones the new state. A new problem's tables and
    terms are built once, on the host. ``close()`` frees every capture."""

    def __init__(self):
        self.graphs: dict = {}
        self._src = self._prep = None

    def step(self, problem: dense.StereoBAProblem, state: dense.BAState,
             mesh: DeviceMesh) -> dense.BAState:
        if self._src is not problem:
            self._src, self._prep = problem, (dense.block_tables(problem),
                                              dense.aux_terms(problem))
        inputs = dense.dense_loop_inputs(problem, state, self._prep[1], self._prep[0])
        key = (loop_key(problem, mesh, "gn_step"), tuple((t.shape, t.dtype) for t in inputs))
        if key not in self.graphs:
            self.graphs[key] = self._capture(problem, state, mesh)
        entry = self.graphs[key]
        bufs, graph, out = entry[:3]
        # the problem's tensors only when another problem was read last
        n = 0 if entry[3] is not problem else len(inputs) - 2
        lm._copy_inputs(bufs[n:], inputs[n:])
        entry[3] = problem
        graph.replay()
        return lm.tree_map(torch.clone, out[0])

    @staticmethod
    def _capture(problem, state, mesh) -> list:
        """``[buffers, graph, output, problem read last]`` of a key: the
        buffers are clones of the problem's, its tables', its terms' and the
        state's tensors. The step runs once eagerly first, on the capture
        stream, its result dropped (the libraries' handles and workspaces
        are made there)."""
        problem, state = lm.tree_map(torch.clone, problem), lm.tree_map(torch.clone, state)
        reserve(mesh, dense_psum_numel(state.poses.shape[0], state.points.shape[0]), state.poses)
        tables, terms = dense.block_tables(problem), dense.aux_terms(problem)
        normal_eq = make_sharded_normal_eq(mesh, tables, terms)
        device, out = state.poses.get_device(), []

        def fn():
            return gn_step(problem, state, *normal_eq(problem, state))

        stream = graph_loop.capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graph = graph_loop.DeviceGraph(lambda: out.append(fn()), device, counted=COUNTED)
        return [dense.dense_loop_inputs(problem, state, terms, tables), graph, out, None]

    def close(self) -> None:
        for entry in self.graphs.values():
            entry[1].close()
        self.graphs = {}
        self._src = self._prep = None


def gn_step_sharded(problem: dense.StereoBAProblem, state: dense.BAState,
                    mesh: DeviceMesh, graph: StepGraph | None = None) -> dense.BAState:
    """One Gauss-Newton step of a sharded problem (``shard_problem``):
    the sharded assembly, then ``gn_step``, replicated. With a ``graph``
    (a ``StepGraph``, on an NCCL mesh of one host only: ``resolve_loop``)
    the step replays its captured graph
    for this shape (captured at the first step of the shape); without one
    it runs launch by launch. Both give the same bits."""
    if graph is not None:
        resolve_loop(mesh, "device", "GN step", "graph=None")
        return graph.step(problem, state, mesh)
    return gn_step(problem, state, *make_sharded_normal_eq(mesh)(problem, state))


def gn_step(problem: dense.StereoBAProblem, state: dense.BAState, H: torch.Tensor,
            g: torch.Tensor) -> dense.BAState:
    """The damped solve of ``(H + 1e-4 diag(H)) dx = -g`` (the factor
    applied by ``lm.cholesky_apply``: no host sync) and the retraction."""
    diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
    L = lm._cholesky_or_nan(H + 1e-4 * torch.diag(diag))
    dx = lm.cholesky_apply(L, -g)
    return dense._retract_state(problem, state, dx)
