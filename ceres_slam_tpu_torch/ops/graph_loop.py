"""A while loop on the card: a CUDA graph with a conditional WHILE node.

The counterpart of ``jax.lax.while_loop``, in which the JAX package runs
every solver loop on the TPU, Pallas kernels included (K3 inside
``pcg_solve``, itself inside ``lm_solve``; the probe's ``grid_in_while``
case, ``scripts/probe_pallas_scan.py:49-58``). ``DeviceWhile(body, pred)``
captures ``body`` once with PyTorch (``torch.cuda.CUDAGraph(keep_graph=
True)``), and ``csrc/graph_while.cu`` builds the loop around the captured
graph: a kernel that sets the condition from ``pred``, then a WHILE node
whose body is the capture (a child graph node) followed by a kernel that
sets the condition again. ``run()`` is one host call for the whole loop;
the host reads the iteration count once, after it.

A loop inside the body: ``while_loop(body, pred)`` called while a
``DeviceWhile`` captures its body puts a WHILE node of its own into the
outer body. The outer body is captured in segments, one PyTorch capture
after another on one stream and one graph pool: the part before the inner
loop, the inner loop's body, the part after it; ``csrc/graph_while.cu``
composes them (child graph, the inner condition kernel, the inner WHILE
node, child graph, the outer condition kernel). The captures run in the
order the segments run, so the pool never hands a segment a block that an
earlier segment's tensors still hold, and the inner body reads the outer
body's tensors by address, with no copies. Called outside a capture,
``while_loop`` iterates the body on the host (the test of ``pred`` read
every iteration): the same body, so the same bits.

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
iterations the device ran. An inner loop's wrappers (``while_loop``'s
``counted``) get their counts per inner iteration times the inner
iterations summed over the whole run, which the device counts beside the
outer loop's. A wrapper names its counters in a ``counters`` attribute
(default ``("launches",)``): the batched K1 also counts the windows it
served (``("launches", "windows")``), and each of them is scaled
(``CapturedCounts``).

A conditional body holds kernels, empty, memcpy and memset nodes, child
graphs and conditional nodes only: ``DeviceWhile`` refuses a capture that
holds any other node type (a library's host node or event record or wait),
naming the segment and the type (``csrc/graph_while.cu``), and
``node_types`` lists a captured graph's node types. ``CAPTURE_ERROR_MODE``
is the captures' ``capture_error_mode`` (PyTorch's default ``"global"``).

Device timers: the loop's condition kernels also stamp the device's
global timer, so a run leaves the node's device nanoseconds (entry to its
last test) and each inner loop's (summed over the run) in ``ns``, beside
the iteration counts in ``count``; the host reads both in the one copy it
makes after the loop (``readings``), and ``add_counts`` keeps them as
``device_ns``. The stamps add no kernel and no node.

Conditional nodes need CUDA 12.3 or newer in the toolkit, the driver and
PyTorch's runtime, and a loop nested in another 12.4 or newer (CUDA 12.9's
headers list conditional nodes among those a conditional body may hold);
``versions()`` reads the three, ``build()`` raises if any is older than
12.3, and a nested ``while_loop`` raises if any is older than 12.4.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Iterable

import torch

from ceres_slam_tpu_torch.ops import cuda_build

_SOURCES = ("graph_while.cu",)
MIN_CUDA = (12, 3)
MIN_CUDA_NESTED = (12, 4)
_fns: dict = {}
_capturing: list = []  # the DeviceWhile whose body is being captured (innermost last)
_capture_streams: dict = {}
_pools: dict = {}
CAPTURE_ERROR_MODE = "global"
# cudaGraphNodeType's names (the runtime's enum; 12: CUDA's batch memory operation node)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph", 5: "empty",
              6: "event wait", 7: "event record", 8: "external semaphore signal",
              9: "external semaphore wait", 10: "memory allocation", 11: "memory free",
              12: "batch memory operation", 13: "conditional"}


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
        # segments, their preds, n, pred, counts, ns, num_counts, device, multi_device,
        # refused, out
        "graph_while_create": [p, p, i, p, p, p, i, i, i, ctypes.POINTER(i), ctypes.POINTER(p)],
        "graph_while_launch": [p, p],  # loop, stream
        "graph_while_destroy": [p],
        # graph, types, max, count
        "graph_node_types": [p, ctypes.POINTER(i), i, ctypes.POINTER(i)]})
    _fns.update(versions=lib.graph_while_versions, create=lib.graph_while_create,
                launch=lib.graph_while_launch, destroy=lib.graph_while_destroy,
                node_types=lib.graph_node_types)
    require(MIN_CUDA, "a device while loop", "conditional graph nodes")
    return str(cuda_build.library_path("graph_while", _SOURCES))


def require(minimum: tuple, what: str, feature: str) -> None:
    """Raise unless the toolkit, the driver and PyTorch's runtime are all
    CUDA ``minimum`` or newer."""
    old = {k: v for k, v in versions().items() if v < minimum}
    if old:
        raise RuntimeError(f"{what} needs CUDA {minimum[0]}.{minimum[1]} or newer ({feature}); "
                           f"found {old}")


def node_types(graph: torch.cuda.CUDAGraph) -> dict:
    """``{type name: count}`` of the nodes of a capture kept with
    ``keep_graph=True`` (child graphs' nodes included)."""
    if "node_types" not in _fns:
        build()
    types, count = (ctypes.c_int * 4096)(), ctypes.c_int()
    err = _fns["node_types"](graph.raw_cuda_graph(), types, 4096, ctypes.byref(count))
    if err:
        raise cuda_build.launch_error(err, "graph_node_types")
    out: dict = {}
    for t in types[:min(count.value, 4096)]:
        name = NODE_TYPES.get(t, f"type {t}")
        out[name] = out.get(name, 0) + 1
    return out


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
    window loop's restart (``solver/window.py``) and the dense matcher
    (``frontend/dense_stereo.py``) are one replay each. ``counted`` as
    ``DeviceWhile``'s: each replay adds the capture's counts once. A capture
    that fails raises; ``capture_s`` and ``instantiate_s`` are the host
    seconds of the capture and of its instantiation."""

    def __init__(self, fn: Callable[[], None], device: int, counted: Iterable = ()):
        if "create" not in _fns:
            build()
        counts = CapturedCounts(counted)
        pool = _pool(device)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.device(device), torch.cuda.stream(capture_stream(device)):
            self.graph.capture_begin(pool=pool, capture_error_mode=CAPTURE_ERROR_MODE)
            try:
                fn()
            except BaseException:
                _abandon_capture(self.graph, device, pool)
                raise
            finally:
                counts.end()
            self.graph.capture_end()
            t1 = time.perf_counter()
            self.graph.instantiate()
        self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
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
    name) whose launches the body makes. The body may run inner loops
    through ``while_loop`` (nested WHILE nodes).
    The body is captured here, on ``capture_stream``; a capture or graph
    build that fails raises."""

    def __init__(self, body: Callable[[], None], pred: torch.Tensor, counted: Iterable = ()):
        _check_pred(pred, "DeviceWhile")
        if "create" not in _fns:
            build()
        self.device = pred.get_device()
        self.body, self.pred = body, pred  # the graph reads what the body's closure holds
        self._handle = self._graph = None
        # [(PyTorch's capture, the inner loop's pred or None, its CapturedCounts or None)]
        self.segments: list = []
        self.iterations, self.inner_iterations, self.device_ns = 0, [], []
        counts = CapturedCounts(counted)
        t0 = time.perf_counter()
        self._pool = _pool(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(capture_stream(self.device)):
            self._begin()
            _capturing.append(self)
            try:
                body()
            except BaseException:
                self._abandon()
                raise
            finally:
                _capturing.pop()
                counts.end()
            self._end()
        self.counts = counts
        inner = [(p, c) for _, p, c in self.segments if p is not None]
        self.count = torch.zeros(1 + len(inner), dtype=torch.int32, device=pred.device)
        # the loops' device nanoseconds, then their start stamps (loop kernels alone write it)
        self.ns = torch.zeros(2 * self.count.numel(), dtype=torch.int64, device=pred.device)
        t1 = time.perf_counter()
        n = len(self.segments)
        graphs = (ctypes.c_void_p * n)(*(g.raw_cuda_graph() for g, _, _ in self.segments))
        preds = (ctypes.c_void_p * n)(*(None if p is None else p.data_ptr()
                                        for _, p, _ in self.segments))
        handle, refused = ctypes.c_void_p(), (ctypes.c_int * 2)()
        err = _fns["create"](graphs, preds, n, pred.data_ptr(), self.count.data_ptr(),
                             self.ns.data_ptr(), self.count.numel(), self.device,
                             torch.cuda.device_count() > 1, refused, ctypes.byref(handle))
        if err and refused[0] >= 0:
            raise RuntimeError(
                f"graph_while_create: captured segment {refused[0]} of {n} holds a "
                f"{NODE_TYPES.get(refused[1], f'type {refused[1]}')} node, which a conditional "
                f"WHILE body cannot hold (its nodes: {node_types(self.segments[refused[0]][0])})")
        if err:
            raise cuda_build.launch_error(err, "graph_while_create")
        self._handle = handle
        # host seconds of the capture and of the loop's build and instantiation
        self.capture_s, self.build_s = t1 - t0, time.perf_counter() - t1

    def _begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._graph.capture_begin(pool=self._pool, capture_error_mode=CAPTURE_ERROR_MODE)

    def _end(self, pred=None, counts=None) -> None:
        self._graph.capture_end()
        self.segments.append((self._graph, pred, counts))
        self._graph = None

    def _abandon(self) -> None:
        if self._graph is not None:
            _abandon_capture(self._graph, self.device, self._pool)
            self._graph = None

    def _inner(self, body: Callable[[], None], pred: torch.Tensor, counted: Iterable) -> None:
        """``while_loop`` inside this loop's capture: close the segment so
        far, capture ``body`` as the inner loop's own segment, open the
        next one."""
        _check_pred(pred, "a nested while loop")
        if pred.get_device() != self.device:
            raise ValueError(f"the inner loop's pred is on cuda:{pred.get_device()}, the loop's "
                             f"on cuda:{self.device}")
        require(MIN_CUDA_NESTED, "a while loop inside a device while loop",
                "nested conditional graph nodes")
        self._end()
        counts = CapturedCounts(counted)
        self._begin()
        try:
            body()
        finally:
            counts.end()
        self._end(pred, counts)
        self._begin()

    def launch(self) -> None:
        """Enqueue the whole loop on the current stream (no host sync, no
        launch counted: ``run`` counts)."""
        if self._handle is None:
            raise RuntimeError("this DeviceWhile was closed")
        err = _fns["launch"](self._handle, cuda_build.current_stream(self.device))
        if err:
            raise cuda_build.launch_error(err, "graph_while_launch")

    def readings(self) -> list:
        """What a run leaves for the host, to read in one copy
        (``torch.cat`` them with whatever else it reads): ``count`` and the
        loops' device nanoseconds."""
        return [self.count, self.ns[:self.count.numel()]]

    def add_counts(self, counts) -> None:
        """Give each counted wrapper its counts for a run whose
        ``readings`` the host read as ``counts``: the loop's iterations, then
        each inner loop's, summed over the run, then the same loops' device
        nanoseconds (kept as ``device_ns``)."""
        counts = [int(c) for c in counts]
        k = self.count.numel()
        if len(counts) != 2 * k:
            raise ValueError(f"expected {2 * k} readings (counts, then device ns), got "
                             f"{len(counts)}")
        self.counts.add(counts[0])
        inner = [c for _, p, c in self.segments if p is not None]
        for c, n in zip(inner, counts[1:k]):
            c.add(n)
        self.iterations, self.inner_iterations, self.device_ns = counts[0], counts[1:k], counts[k:]

    def run(self) -> int:
        """Run the loop and return its iterations, read once on the host
        after the loop (with the inner loops' in ``inner_iterations`` and
        the device nanoseconds in ``device_ns``); each counted wrapper gets
        its counts."""
        self.launch()
        self.add_counts(torch.cat(self.readings()).tolist())
        return self.iterations

    def close(self) -> None:
        """Free the executable graph and PyTorch's captures (their blocks go
        back to the shared pool); a loop in flight finishes first."""
        if self._handle is not None:
            _fns["destroy"](self._handle)
            self._handle = None
        self.segments, self.body = [], None

    def __del__(self):
        if getattr(self, "_handle", None) is not None and _fns:
            self.close()


def _check_pred(pred: torch.Tensor, what: str) -> None:
    if pred.device.type != "cuda":
        raise ValueError(f"{what} runs on the card: pred is on {pred.device} (on the CPU "
                         "iterate the body on the host)")
    if pred.dtype != torch.int32 or pred.numel() != 1 or not pred.is_contiguous():
        raise ValueError(f"pred must be one contiguous int32, got {pred.dtype} of shape "
                         f"{tuple(pred.shape)}")


def resolve_loop(device, loop: str | None, name: str = "LM loop",
                 switch: str = "lm_loop") -> str:
    """The form of a loop (``name``, set by ``switch``) on ``device``: on the
    card (``"device"``, the default on CUDA: a WHILE node, or a captured
    graph) or on the host (``"host"``, the default elsewhere). The device
    form off the card raises, as does an unknown form: nothing falls
    back."""
    if loop not in (None, "device", "host"):
        raise ValueError(f"unknown {name}: {loop!r}")
    on_card = torch.device(device).type == "cuda"
    if loop == "device" and not on_card:
        raise ValueError(f"the device {name} runs on the card: use {switch}='host'")
    return loop or ("device" if on_card else "host")


def not_in_capture(what: str, where: str) -> None:
    """Raise if the current stream is capturing: ``what`` is a host round
    trip, which a captured loop cannot make (``where`` builds it before the
    loop)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} is a host round trip, which a captured loop cannot make: "
                           f"build it before the loop, as {where} does")


def while_loop(body: Callable[[], None], pred: torch.Tensor, counted: Iterable = ()) -> None:
    """``while pred: body()``, with ``pred`` an int32 of one element that
    ``body`` writes. Inside the body of a ``DeviceWhile`` being captured,
    a WHILE node nested in that loop's body (``counted``: the kernel
    wrappers ``body`` launches, counted per inner iteration the card
    runs); anywhere else on the host, the test read every iteration (the
    CPU's form, and the card's outside a capture). Inside another capture
    it raises: a host loop cannot be captured."""
    if _capturing:
        _capturing[-1]._inner(body, pred, counted)
        return
    if pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("while_loop inside a capture that is not a DeviceWhile's: a loop "
                           "on the host cannot be captured")
    while int(pred.reshape(-1)[0]):
        body()
