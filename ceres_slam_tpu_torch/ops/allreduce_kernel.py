"""The sharded solves' all-reduce on the ranks of one host — CUDA kernel,
wrapper and plain version.

The JAX package's sharded solves reduce with XLA's ``psum`` inside their
compiled loops (``ceres_slam_tpu/parallel/sharded_ba.py``,
``sharded_pcg.py``); the port runs those loops as conditional WHILE nodes on
the card (``ops/graph_loop.py``), and ``parallel/sharded_ba.psum`` reduces
through ``peer_all_reduce`` on the ranks of one host: one kernel
(``csrc/peer_allreduce.cu``) in which every rank reads its peers' copies of
the buffer through CUDA IPC mappings (16-byte loads) and sums them in rank
order 0..n-1, after one round of flags (two slots a rank, one a round's
parity). So the sums are the same bits on every rank, in the host form and
in the node form, and the collective is one kernel node a conditional body
holds. On one rank the kernel returns at once (the sum is the buffer); the
launch stays, one a collective. It replaces no Pallas kernel.

A ``Workspace`` per process group holds this rank's two slots and flags,
mapped by every peer, and the grid every call on it launches (``grid_for``:
fixed, so that every block runs every round); it is made (a collective: the
ranks swap IPC handles through the group) by ``reserve``, before a loop, at
the largest packed buffer the loop reduces. Under a capture nothing is allocated or swapped: a buffer
larger than the workspace raises there. A larger reservation outside a
capture adds a workspace and keeps the old ones, which graphs captured
earlier still read; ``close_all`` frees them all (``multihost.shutdown``).

``peer_all_reduce_plain`` is the same function in PyTorch: ``all_gather``
into ``[n, numel]`` and the sum in rank order, left to right; the wrapper
takes it for a tensor on the CPU (gloo ranks).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("peer_allreduce.cu",)
_fns: dict = {}
_workspaces: dict = {}  # id(group) -> [Workspace, ...], the newest last
_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)
_SLOT_QUANTUM = 1 << 20
# the kernel's launch shape (csrc/peer_allreduce.cu: kThreads, kMaxBlocks,
# kMaxRanks) and the bytes of one load from a peer's slot
THREADS, BLOCKS, MAX_RANKS, VECTOR_BYTES = 512, 32, 8, 16


def grid_for(n: int) -> int:
    """The blocks of every call on a workspace of ``n`` ranks: one where
    the kernel returns at once (one rank), else ``BLOCKS`` (all resident on
    an H100 together, 16,384 threads: one or two vectors a thread at a CG
    iteration's U^T v of kitti1100)."""
    return 1 if n == 1 else BLOCKS


def padded_bytes(numel: int, itemsize: int) -> int:
    """The slot bytes a buffer takes: whole 16-byte vectors, the last one
    zero-padded."""
    return -(-numel * itemsize // VECTOR_BYTES) * VECTOR_BYTES


def build() -> str:
    """Compile (at first use) and load the kernel; returns the library path."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, numel, bases, rank, n, slot_bytes, blocks, device, multi_device, stream
    sig = [p, ll, p, i, i, ll, i, i, i, p]
    lib = cuda_build.load("peer_allreduce", _SOURCES, {
        "peer_allreduce_f32": sig, "peer_allreduce_f64": sig,
        # slot_bytes, n, device, base, handle
        "peer_workspace_create": [ll, i, i, ctypes.POINTER(p), p],
        "peer_workspace_open": [p, i, ctypes.POINTER(p)],  # handle, device, ptr
        "peer_workspace_close": [p, i, i]})  # ptr, own, device
    _fns.update({torch.float32: lib.peer_allreduce_f32, torch.float64: lib.peer_allreduce_f64,
                 "create": lib.peer_workspace_create, "open": lib.peer_workspace_open,
                 "close": lib.peer_workspace_close})
    return str(cuda_build.library_path("peer_allreduce", _SOURCES))


def _barrier(group) -> None:
    """Every rank of ``group`` here, on the host (any backend)."""
    dist.all_gather_object([None] * dist.get_world_size(group), 0, group=group)


class Workspace:
    """This rank's two slots of ``slot_bytes`` and its flags for ``group``,
    the addresses of every rank's in this process (``bases``, an int64
    device array) and the grid of every call on it (``blocks``). Made by
    every rank of the group together."""

    def __init__(self, group, slot_bytes: int, device: int):
        if not _fns:
            build()
        self.group, self.device, self.slot_bytes = group, device, slot_bytes
        self.rank, self.n = dist.get_rank(group), dist.get_world_size(group)
        if self.n > MAX_RANKS:
            raise ValueError(f"peer_all_reduce reduces over at most {MAX_RANKS} ranks of one "
                             f"host, not {self.n}")
        self.blocks = grid_for(self.n)
        base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(_HANDLE_BYTES)
        err = _fns["create"](slot_bytes, self.n, device, ctypes.byref(base), handle)
        if err:
            raise cuda_build.launch_error(err, "peer_workspace_create")
        self.own, self.opened = base.value, []
        handles = [None] * self.n
        dist.all_gather_object(handles, handle.raw, group=group)
        ptrs = []
        for q, h in enumerate(handles):
            if q == self.rank:
                ptrs.append(self.own)
                continue
            ptr = ctypes.c_void_p()
            err = _fns["open"](h, device, ctypes.byref(ptr))
            if err:
                self._free()
                raise cuda_build.launch_error(err, f"peer_workspace_open (rank {q}'s workspace)")
            self.opened.append(ptr.value)
            ptrs.append(ptr.value)
        self.bases = torch.tensor(ptrs, dtype=torch.int64, device=device)

    def _free(self) -> None:
        for ptr in self.opened:
            _fns["close"](ptr, 0, self.device)
        self.opened = []
        if self.own:
            _fns["close"](self.own, 1, self.device)
            self.own = None


def reserve(group, nbytes: int, device: torch.device) -> Workspace | None:
    """The workspace of ``group`` for buffers of up to ``nbytes`` on
    ``device`` (None on the CPU): the newest one if it is large enough, else
    a new one (a collective: every rank of the group must reserve the same
    size at the same point). Raises under a capture where a new one would be
    needed: reserve before the loop."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    spaces = _workspaces.setdefault(id(group), [])
    if spaces and spaces[-1].slot_bytes >= nbytes:
        return spaces[-1]
    if torch.cuda.is_current_stream_capturing():
        have = spaces[-1].slot_bytes if spaces else 0
        raise RuntimeError(f"the peer all-reduce's workspace holds {have} bytes and this buffer "
                           f"{nbytes}: a workspace is made by all ranks together, which a capture "
                           f"cannot hold; reserve it before the loop (allreduce_kernel.reserve)")
    slot = -(-max(nbytes, 1) // _SLOT_QUANTUM) * _SLOT_QUANTUM
    index = device.index if device.index is not None else torch.cuda.current_device()
    spaces.append(Workspace(group, slot, index))
    return spaces[-1]


def close_all() -> None:
    """Free every workspace of this process: every rank calls it together
    (``multihost.shutdown``). The card's work finishes first, each rank
    unmaps its peers' workspaces, then frees its own."""
    if not _workspaces:
        return
    torch.cuda.synchronize()
    spaces = [ws for group in _workspaces.values() for ws in group]
    for ws in spaces:
        _barrier(ws.group)  # no peer reads a slot any more
        for ptr in ws.opened:
            _fns["close"](ptr, 0, ws.device)
        ws.opened = []
    for ws in spaces:
        _barrier(ws.group)  # no peer maps a slot any more
        ws._free()
    _workspaces.clear()


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"peer_all_reduce takes float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("peer_all_reduce: the buffer must be contiguous")


def peer_all_reduce_plain(x: torch.Tensor, group) -> torch.Tensor:
    """Plain PyTorch version: ``all_gather`` of every rank's ``x`` into
    ``[n, numel]``, then the sum in rank order 0..n-1, left to right, written
    into ``x``; returns ``x``."""
    _check(x)
    n = dist.get_world_size(group)
    parts = x.new_empty((n, x.numel()))
    dist.all_gather(list(parts.unbind(0)), x.reshape(-1), group=group)
    acc = parts[0].clone()
    for q in range(1, n):
        acc += parts[q]
    x.copy_(acc.view(x.shape))
    return x


def peer_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` (contiguous, float32 or float64) over the ranks of
    ``group``, all on one host, in place; returns ``x``. CPU tensors take the
    plain version; CUDA tensors launch the kernel once on the current stream
    (counted in ``.launches``), which a CUDA graph can capture, on the
    group's workspace (``reserve``: outside a capture it grows here). Every
    rank gets the same bits, those of the plain version."""
    _check(x)
    if x.device.type == "cpu":
        return peer_all_reduce_plain(x, group)
    if x.device.type != "cuda":
        raise ValueError(f"peer_all_reduce runs on cpu or cuda, not {x.device}")
    ws = reserve(group, padded_bytes(x.numel(), x.element_size()), x.device)
    dev = x.get_device()
    if ws.device != dev:
        raise ValueError(f"the buffer is on cuda:{dev}, the group's workspace on cuda:{ws.device}")
    err = _fns[x.dtype](x.data_ptr(), x.numel(), ws.bases.data_ptr(), ws.rank, ws.n,
                        ws.slot_bytes, ws.blocks, dev, torch.cuda.device_count() > 1,
                        cuda_build.current_stream(dev))
    if err:
        raise cuda_build.launch_error(err, "peer_all_reduce")
    peer_all_reduce.launches += 1
    return x


peer_all_reduce.launches = 0
