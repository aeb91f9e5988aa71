"""The traced run: torch.profiler over the window, CUDA events around every
WHILE-node launch, host ranges around the driver's phases.

The profiler records only the first pass of a conditional WHILE node's body,
so a node is timed by CUDA events around ``DeviceWhile.launch`` and the
kernels the profiler ties to a graph launch are left out of its sums; the
device is busy over the union of the other device operations and the nodes'
spans (gaps inside a node count as busy). The spans are placed on the
profiler's clock at the first device operation of their launch, which gives
the idle gaps and the host range each falls in.

A driver that sets ``gated`` profiles only the segments it opens and closes
through the tracer (``open()``, ``close()``): under the profiler, a WHILE
node captured in the session and launched again and again can fault on the
card (PERF.md, Open questions), so such a driver keeps its captures out of
the profiled segments, and keeps the segments short, since the profiler's
cost on every host operation inflates a host-paced step several times. The
traced window is then the sum of the segments; the node spans and counts
cover the whole window, and a host metric reads the steps outside the
segments (``quiet_node_s``)."""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
import time
from contextlib import ExitStack

import torch

NODE = "DeviceWhile node (CUDA events)"
NODE_RANGE = "bench.node_launch"
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What a traced window left: node spans and iterations over the whole
    window, the profiled segments' length, device busy time and breakdown,
    graph statistics over the window."""

    def __init__(self):
        self.node_s: list[float] = []
        self.quiet_node_s: list[float] = []  # the spans outside profiled segments
        self.node_iterations = 0  # the outer loops' iterations the card ran
        self.window_s = 0.0  # the profiled segments, summed
        self.busy_s = 0.0
        self.graph_stats: dict = {}
        self.device_ops: list = []
        self.idle_gaps: list = []


def _graph_stats() -> dict:
    from ceres_slam_tpu_torch.solver import lm

    return {"lm": dict(lm.GRAPH_STATS)}


class Tracer:
    """A context over the window; ``phases`` are ``(module, attribute)``
    pairs of the program (the attribute may be ``Class.method``) whose calls
    get a host range ``bench.<function name>``; with ``gated`` the driver
    opens and closes the profiled segments."""

    def __init__(self, phases=(), gated: bool = False):
        self.phases, self.gated = phases, gated
        self.trace = Trace()
        self._spans: list = []  # (start event, end event, profiled)
        self._stack = ExitStack()
        self._prof = None
        self._closed: list = []  # (profiler, first span, end span) of each segment
        self._by_name: dict = {}
        self._gaps: dict = {}

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._stack.callback(setattr, owner, name, orig)

    def __enter__(self):
        from ceres_slam_tpu_torch.ops import graph_loop

        spans, trace = self._spans, self.trace

        def timed(orig):
            def launch(node):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                with torch.profiler.record_function(NODE_RANGE):
                    s.record()
                    orig(node)
                    e.record()
                spans.append((s, e, self._prof is not None))
            return launch

        def counted(orig):
            def add_counts(node, counts):
                trace.node_iterations += int(counts[0])
                return orig(node, counts)
            return add_counts

        self._wrap(graph_loop.DeviceWhile, "launch", timed)
        self._wrap(graph_loop.DeviceWhile, "add_counts", counted)
        for module, attr in self.phases:
            def ranged(orig, label=f"bench.{attr.rsplit('.', 1)[-1]}"):
                def call(*a, **k):
                    with torch.profiler.record_function(label):
                        return orig(*a, **k)
                return call
            owner = importlib.import_module(module)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            self._wrap(owner, name, ranged)
        self._stats0 = _graph_stats()
        if not self.gated:
            self.open()
        return self

    def open(self) -> None:
        """Start a profiled segment (no-op while one is open)."""
        if self._prof is not None:
            return
        torch.cuda.synchronize()
        self._first_span = len(self._spans)
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                        torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._segment = torch.profiler.record_function("bench.window")
        self._segment.__enter__()
        self._t0 = time.perf_counter()

    def close(self) -> None:
        """End the open segment (no-op without one); its events are reduced
        when the window has closed."""
        if self._prof is None:
            return
        self._segment.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.trace.window_s += time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._closed.append((prof, self._first_span, len(self._spans)))

    def _reduce(self, prof, first: int, end: int) -> None:
        spans = [s.elapsed_time(e) / 1e3 for s, e, on in self._spans[first:end] if on]
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        busy, by_name, gaps = reduce_events(events, spans)
        self.trace.busy_s += busy
        for acc, part in ((self._by_name, by_name), (self._gaps, gaps)):
            for k, v in part.items():
                acc[k] = acc.get(k, 0.0) + v

    @property
    def profiling(self) -> bool:
        return self._prof is not None

    def item(self):
        return torch.profiler.record_function("bench.item")

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        elif self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        torch.cuda.synchronize()
        self._stack.close()
        if exc[0] is None:
            for segment in self._closed:
                self._reduce(*segment)
        t = self.trace
        stats1 = _graph_stats()
        t.graph_stats = {k: {n: stats1[k][n] - self._stats0[k][n] for n in stats1[k]}
                         for k in stats1}
        t.node_s = [s.elapsed_time(e) / 1e3 for s, e, _ in self._spans]
        t.quiet_node_s = [s.elapsed_time(e) / 1e3 for s, e, on in self._spans if not on]
        t.device_ops = _top(self._by_name)
        t.idle_gaps = _top(self._gaps)
        return False


def _top(d: dict) -> list:
    return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]


def reduce_events(events, node_s: list) -> tuple[float, dict, dict]:
    """``(busy seconds, device seconds by operation, idle seconds by host
    range)`` of one profiled segment (Kineto's chrome-trace events) whose
    nodes took ``node_s`` by events."""
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = [e for e in xs if e.get("cat") == "user_annotation"]
    node_ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in ranges if e["name"] == NODE_RANGE)
    starts = [a for a, _ in node_ranges]

    def in_node_range(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= node_ranges[i][1]

    # the runtime's graph launches inside a node's launch range are the
    # nodes'; the kernels of any other graph (a plain replay) are seen whole
    launches = sorted((e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "GraphLaunch" in e.get("name", "") and in_node_range(e["ts"])),
                      key=lambda e: e["ts"])
    graph_corr = {e.get("args", {}).get("correlation") for e in launches}
    gpu = [e for e in xs if e.get("cat") in GPU_CATS]
    first_op: dict = {}
    eager = []
    for e in gpu:
        c = e.get("args", {}).get("correlation")
        if c in graph_corr:
            first_op[c] = min(first_op.get(c, e["ts"]), e["ts"])
        else:
            eager.append(e)
    window = [e for e in ranges if e["name"] == "bench.window"]
    w0, w1 = ((window[0]["ts"], window[0]["ts"] + window[0]["dur"]) if window
              else (min((e["ts"] for e in gpu), default=0.0),
                    max((e["ts"] + e["dur"] for e in gpu), default=0.0)))
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in eager]
    placed = len(launches) == len(node_s)
    if placed:
        for e, span in zip(launches, node_s):
            start = first_op.get(e.get("args", {}).get("correlation"), e["ts"])
            intervals.append((start, start + span * 1e6))
    merged = _merge(intervals)
    busy = (_inside(merged, w0, w1) if placed
            else _inside(_merge([(e["ts"], e["ts"] + e["dur"]) for e in eager]), w0, w1)
            + sum(node_s))
    by_name: dict = {}
    for e in eager:
        by_name[e["name"][:96]] = by_name.get(e["name"][:96], 0.0) + e["dur"] / 1e6
    if node_s:
        by_name[NODE] = sum(node_s)
    gaps = {}
    if placed:
        gaps = _gaps(merged, w0, w1, [e for e in ranges if e["name"].startswith("bench.")
                                      and e["name"] not in ("bench.window", NODE_RANGE)])
    return busy, by_name, gaps


def idle_pct(run) -> float | None:
    """The device's idle share of a traced window, in percent: 100 (1 -
    busy / the profiled length)."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _inside(merged, w0, w1) -> float:
    """Seconds of the merged intervals (µs) inside ``[w0, w1]``."""
    return sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in merged) / 1e6


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gaps(merged, w0, w1, ranges) -> dict:
    """The device's idle seconds in ``[w0, w1]`` by the innermost host range
    at each gap's middle (``between items`` outside every range)."""
    edges, prev = [], w0
    for a, b in merged:
        if a > prev:
            edges.append((prev, min(a, w1)))
        prev = max(prev, b)
    if w1 > prev:
        edges.append((prev, w1))
    total: dict = {}
    for a, b in edges:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = [r for r in ranges if r["ts"] <= mid <= r["ts"] + r["dur"]]
        label = min(inner, key=lambda r: r["dur"])["name"] if inner else "between items"
        total[label] = total.get(label, 0.0) + (b - a) / 1e6
    return total
