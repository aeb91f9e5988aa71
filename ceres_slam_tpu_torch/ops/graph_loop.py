"""A while loop on the card: a CUDA graph with a conditional WHILE node.

The counterpart of ``jax.lax.while_loop``, in which the JAX package runs
every solver loop on the TPU, Pallas kernels included (K3 inside
``pcg_solve``; the probe's ``grid_in_while`` case,
``scripts/probe_pallas_scan.py:49-58``). ``DeviceWhile(body, pred)``
captures ``body`` once with PyTorch (``torch.cuda.CUDAGraph(keep_graph=
True)``), and ``csrc/graph_while.cu`` builds the loop around the captured
graph: a kernel that sets the condition from ``pred``, then a WHILE node
whose body is the capture (a child graph node) followed by a kernel that
sets the condition again. ``run()`` is one host call for the whole loop;
the host reads the iteration count once, after it.

``body`` runs the same kernels on the same addresses every iteration: it
reads and writes tensors allocated before the capture, and writes the
int32 ``pred`` (nonzero: run again). Its temporaries come from PyTorch's
graph pool, which ``DeviceWhile`` keeps alive with the executable graph.
A body that synchronizes with the host (``.item()``, ``bool()`` of a
device tensor, a blocking copy) cannot be captured: the capture raises,
and nothing falls back to a host loop. On the CPU there is no graph, so
``DeviceWhile`` raises; the loop's body is plain PyTorch, and a caller
iterates it on the host there.

Launch counts: a kernel wrapper counts one launch when the body is
captured, which is no launch; ``DeviceWhile`` takes the wrappers whose
counts it keeps (``counted``), takes the capture's counts back, and after
each ``run()`` adds each wrapper's counts per iteration times the
iterations the device ran. A wrapper names its counters in a
``counters`` attribute (default ``("launches",)``): the batched K1 also
counts the windows it served (``("launches", "windows")``), and each of
them is scaled (``CapturedCounts``).

Conditional nodes need CUDA 12.3 or newer in the toolkit, the driver and
PyTorch's runtime; ``versions()`` reads the three and ``build()`` raises
if any is older.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Iterable

import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("graph_while.cu",)
MIN_CUDA = (12, 3)
_fns: dict = {}
_capture_streams: dict = {}
_pools: dict = {}


def _version(v: int) -> tuple[int, int]:
    return v // 1000, v % 1000 // 10


def versions() -> dict:
    """The CUDA versions a device loop depends on, as ``(major, minor)``:
    the toolkit this library was built with, the driver, PyTorch's runtime."""
    if "versions" not in _fns:
        build()
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    err = _fns["versions"](ctypes.byref(runtime), ctypes.byref(driver))
    if err:
        raise cuda_build.launch_error(err, "graph_while_versions")
    torch_cuda = tuple(int(x) for x in (torch.version.cuda or "0.0").split(".")[:2])
    return {"toolkit": _version(runtime.value), "driver": _version(driver.value),
            "torch": torch_cuda}


def build() -> str:
    """Compile (at first use) and load the loop's library, and check that
    the toolkit, the driver and PyTorch's runtime are CUDA 12.3 or newer;
    returns the library path."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load("graph_while", _SOURCES, {
        "graph_while_versions": [ctypes.POINTER(i), ctypes.POINTER(i)],
        # body graph, pred, count, device, multi_device, out handle
        "graph_while_create": [p, p, p, i, i, ctypes.POINTER(p)],
        "graph_while_launch": [p, p],  # loop, stream
        "graph_while_destroy": [p]})
    _fns.update(versions=lib.graph_while_versions, create=lib.graph_while_create,
                launch=lib.graph_while_launch, destroy=lib.graph_while_destroy)
    old = {k: v for k, v in versions().items() if v < MIN_CUDA}
    if old:
        raise RuntimeError(f"a device while loop needs CUDA {MIN_CUDA[0]}.{MIN_CUDA[1]} or newer "
                           f"(conditional graph nodes); found {old}")
    return str(cuda_build.library_path("graph_while", _SOURCES))


def _pool(device: int):
    """The graph memory pool every capture on ``device`` shares. A capture
    of one tiny kernel holds it for the process: PyTorch's allocator
    refuses a pool handle whose graphs were all freed, and with the pool
    held, a capture reuses the blocks of the captures closed before it.
    Sharing is safe because a body keeps its state in tensors allocated
    before its capture: the pool holds only temporaries, dead between
    launches, and launches on one stream never overlap."""
    if device not in _pools:
        handle = torch.cuda.graph_pool_handle()
        keeper, flag = torch.cuda.CUDAGraph(keep_graph=True), torch.zeros(1, device=device)
        with torch.cuda.device(device), torch.cuda.stream(capture_stream(device)):
            keeper.capture_begin(pool=handle)
            flag.zero_()
            keeper.capture_end()
        _pools[device] = (handle, keeper, flag)
    return _pools[device][0]


def _abandon_capture(graph, device: int, pool) -> None:
    """End a capture whose body raised. The capture was invalidated, so
    ``capture_end`` raises before it stops routing the allocator to the
    pool: stop it here, and retire the pool, which PyTorch's allocator
    refuses to record into again (the next capture takes a new one). The
    body's error is the one to raise."""
    try:
        graph.capture_end()
    except RuntimeError:
        try:
            torch._C._cuda_endAllocateToPool(device, pool)
        except RuntimeError:
            pass  # capture_end had stopped it
        _pools.pop(device, None)


def capture_stream(device: int) -> torch.cuda.Stream:
    """The side stream every ``DeviceWhile`` on ``device`` captures on (one,
    so that PyTorch's per-stream cuBLAS workspace is made once)."""
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


class CapturedCounts:
    """The counters of the wrappers a captured body launches (``counters``,
    default ``("launches",)``): made before the capture, ``end()`` after it
    takes the capture's increments back and keeps them as the counts of
    one iteration, and ``add(n)`` adds them ``n`` times."""

    def __init__(self, wrappers: Iterable):
        self.names = [(w, name) for w in wrappers
                      for name in getattr(w, "counters", ("launches",))]
        self.before = [getattr(w, name) for w, name in self.names]
        self.per_iteration: list = []

    def end(self) -> None:
        self.per_iteration = [getattr(w, name) - n
                              for (w, name), n in zip(self.names, self.before)]
        for (w, name), n in zip(self.names, self.before):
            setattr(w, name, n)

    def add(self, n: int) -> None:
        for (w, name), per in zip(self.names, self.per_iteration):
            setattr(w, name, getattr(w, name) + per * n)


class DeviceGraph:
    """``fn()`` captured once in a plain CUDA graph (no loop) and replayed on
    the current stream, on the pool every capture on ``device`` shares: a
    window loop's restart (``solver/window.py``) is one replay. ``counted``
    as ``DeviceWhile``'s: each replay adds the capture's counts once."""

    def __init__(self, fn: Callable[[], None], device: int, counted: Iterable = ()):
        if "create" not in _fns:
            build()
        counts = CapturedCounts(counted)
        pool = _pool(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(capture_stream(device)):
            self.graph.capture_begin(pool=pool)
            try:
                fn()
            except BaseException:
                _abandon_capture(self.graph, device, pool)
                raise
            finally:
                counts.end()
            self.graph.capture_end()
        self.counts, self.fn = counts, fn  # the graph reads what fn's closure holds

    def replay(self) -> None:
        self.graph.replay()
        self.counts.add(1)

    def close(self) -> None:
        self.graph = self.fn = None


class DeviceWhile:
    """``while pred: body()`` on the card, as one graph launch.

    ``pred``: an int32 tensor of one element on the card, which ``body``
    writes; the loop tests it before every iteration, so it runs zero
    times if ``pred`` is 0 at ``run()``. ``counted``: the kernel wrappers
    (functions with a ``.launches`` count, and the other ``counters`` they
    name) whose launches the body makes.
    The body is captured here, on ``capture_stream``; a capture or graph
    build that fails raises."""

    def __init__(self, body: Callable[[], None], pred: torch.Tensor, counted: Iterable = ()):
        if pred.device.type != "cuda":
            raise ValueError(f"DeviceWhile runs on the card: pred is on {pred.device} (on the "
                             "CPU iterate the body on the host)")
        if pred.dtype != torch.int32 or pred.numel() != 1 or not pred.is_contiguous():
            raise ValueError(f"pred must be one contiguous int32, got {pred.dtype} of shape "
                             f"{tuple(pred.shape)}")
        if "create" not in _fns:
            build()
        self.device = pred.get_device()
        self.body, self.pred = body, pred  # the graph reads what the body's closure holds
        self.count = torch.zeros(1, dtype=torch.int32, device=pred.device)
        self._handle = None
        counts = CapturedCounts(counted)
        t0 = time.perf_counter()
        pool = _pool(self.device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(self.device), torch.cuda.stream(capture_stream(self.device)):
            self.graph.capture_begin(pool=pool)
            try:
                body()
            except BaseException:
                _abandon_capture(self.graph, self.device, pool)
                raise
            finally:
                counts.end()
            self.graph.capture_end()
        self.counts = counts
        t1 = time.perf_counter()
        handle = ctypes.c_void_p()
        err = _fns["create"](self.graph.raw_cuda_graph(), pred.data_ptr(), self.count.data_ptr(),
                             self.device, torch.cuda.device_count() > 1, ctypes.byref(handle))
        if err:
            raise cuda_build.launch_error(err, "graph_while_create")
        self._handle = handle
        # host seconds of the capture and of the loop's build and instantiation
        self.capture_s, self.build_s = t1 - t0, time.perf_counter() - t1

    def launch(self) -> None:
        """Enqueue the whole loop on the current stream (no host sync, no
        launch counted: ``run`` counts)."""
        if self._handle is None:
            raise RuntimeError("this DeviceWhile was closed")
        err = _fns["launch"](self._handle, cuda_build.current_stream(self.device))
        if err:
            raise cuda_build.launch_error(err, "graph_while_launch")

    def run(self) -> int:
        """Run the loop and return its iterations, read once on the host
        after the loop; each counted wrapper gets its counts."""
        self.launch()
        n = int(self.count.item())
        self.counts.add(n)
        return n

    def close(self) -> None:
        """Free the executable graph and PyTorch's capture (its blocks go
        back to the shared pool); a loop in flight finishes first."""
        if self._handle is not None:
            _fns["destroy"](self._handle)
            self._handle = None
        self.graph = self.body = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None and _fns:
            self.close()
