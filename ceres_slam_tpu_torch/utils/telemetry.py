"""Solver reports, the program's spans and counters, a device trace and a
wall-clock section timer.

Port of ``ceres_slam_tpu/utils/telemetry.py`` (``brief_report``,
``full_report``, ``trace``, ``Stopwatch``), kept in the port because
importing anything under ``ceres_slam_tpu`` imports JAX. The reference's
only performance signal is Ceres' BriefReport per window; the LM loops
record the per-iteration history when ``SolveConfig.record_history`` is
set, and ``full_report`` prints it. ``trace`` records a ``torch.profiler``
trace (the host and, where there is a card, the device) in place of the
JAX module's ``jax.profiler`` one.

Spans and counters. ``span(name, **attrs)`` marks a phase of the program's
host work: while spans record, each keeps ``(id, parent, request, name,
t0, t1, attrs)`` on ``time.perf_counter`` (``parent``: the innermost span
open on the thread when it opened; ``request``: the id of its top-level
span, shared by the whole tree) in a bounded in-memory store (``spans()``,
the oldest dropped first and counted, ``dropped()``), and opens
``torch.profiler.record_function(name)``, so that an exported profiler
trace shows the phase beside the device operations. ``count(name, n)``
adds to the innermost open span; a span's counts are its subtree's.
``to_device`` is the program's one upload of host data, counted as
``h2d_bytes``.

Spans record inside ``record()`` (no profiler: what the apps' ``--trace``
uses), inside ``trace()``, and whenever a ``torch.profiler`` session is
active. Otherwise a span checks those two states and reads the clock at its
ends (``seconds``), nothing more: it stores nothing and never synchronizes
with the device.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
import warnings

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def brief_report(summary) -> str:
    """One-line report in the spirit of ceres BriefReport."""
    return (
        f"iterations: {int(summary.iterations)}, "
        f"initial cost: {float(summary.initial_cost):.6e}, "
        f"final cost: {float(summary.final_cost):.6e}, "
        f"grad max-norm: {float(summary.final_grad_norm):.3e}, "
        f"lambda: {float(summary.final_lambda):.3e}"
    )


def full_report(summary) -> str:
    """Multi-line per-iteration report (needs record_history=True)."""
    lines = [brief_report(summary)]
    if summary.cost_history is not None:
        ch = np.asarray(summary.cost_history)
        lh = np.asarray(summary.lambda_history)
        gh = np.asarray(summary.grad_norm_history)
        ah = np.asarray(summary.step_accepted)
        n = int(summary.iterations)
        lines.append(" it |        cost |    lambda | grad max | accepted")
        for i in range(n):
            lines.append(
                f"{i:>3} | {ch[i]:>11.5e} | {lh[i]:>9.3e} | {gh[i]:>8.2e} | "
                f"{'yes' if ah[i] else 'no'}"
            )
    return "\n".join(lines)


# the span store's capacity: a traced benchmark window keeps well under it
CAPACITY = 1 << 16
_store: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_recorders = 0  # the ``record`` blocks open
_ids = itertools.count(1)
_local = threading.local()


def recording() -> bool:
    """Whether a span opened now records."""
    return _recorders > 0 or bool(_autograd_profiler._is_profiler_enabled)


def spans() -> list:
    """The recorded spans, oldest first by their end, as dicts ``id``,
    ``parent`` (None at the top), ``request``, ``name``, ``t0``, ``t1``
    (``time.perf_counter`` seconds), ``attrs`` (the span's own and its
    subtree's counts)."""
    return list(_store)


def dropped() -> int:
    """Spans the bounded store dropped (the oldest first)."""
    return _dropped


def reset() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    _store.clear()
    _dropped = 0


@contextlib.contextmanager
def record(path: str | None = None):
    """Record spans over a code block, with no profiler; at its end write
    the spans opened in it to ``path`` where given (JSON, a list of
    ``spans()``'s records), and warn if the store dropped any of them."""
    global _recorders
    first, lost = next(_ids), _dropped
    _recorders += 1
    try:
        yield
    finally:
        _recorders -= 1
        if path is not None:
            with open(path, "w") as f:
                json.dump([r for r in spans() if r["id"] > first], f)
        if _dropped > lost:
            warnings.warn(f"the span store dropped {_dropped - lost} spans (capacity "
                          f"{_store.maxlen}); the oldest are missing", stacklevel=3)


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One ``span``: a context manager whose ``seconds`` is its wall on the
    host clock, recorded or not, and whose ``set(**attrs)`` adds attributes
    to its record."""

    __slots__ = ("name", "attrs", "counts", "t0", "t1", "id", "parent", "request", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self._range = name, attrs, None

    def __enter__(self):
        if recording():
            stack = _open()
            up = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent, self.request = (None, self.id) if up is None else (up.id, up.request)
            self.counts = {}
            stack.append(self)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            stack = _open()
            stack.remove(self)
            if stack:
                up = stack[-1].counts
                for k, v in self.counts.items():
                    up[k] = up.get(k, 0) + v
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append({"id": self.id, "parent": self.parent, "request": self.request,
                           "name": self.name, "t0": self.t0, "t1": self.t1,
                           "attrs": {**self.attrs, **self.counts}})
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def span(name: str, **attrs) -> _Span:
    """A span named ``name`` with ``attrs`` (JSON values): ``with span(...)
    as s:``; ``s.set(...)`` adds attributes before it closes."""
    return _Span(name, attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the innermost open span's counter ``name`` (nothing
    while no span records)."""
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1].counts
        top[name] = top.get(name, 0) + n


def to_device(x, device, dtype: torch.dtype | None = None,
              non_blocking: bool = False) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype).to(device)``: the program's upload
    of host data. A host array going to a CUDA device counts its bytes as
    ``h2d_bytes``."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device, non_blocking=non_blocking)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace around a code block and write it
    as a Chrome trace (``trace.json``, viewable in Perfetto) into
    ``log_dir``, by default ``ceres_slam_tpu_torch_trace`` in the temporary
    directory, with the spans the block recorded beside it
    (``spans.json``, a list of ``spans()``'s records). Yields ``log_dir``.
    On the card, a WHILE node captured while the profiler runs, or after
    it ran, can fault when launched (PERF.md, Open questions): record the
    spans of a path that captures with ``record`` instead."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ceres_slam_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, record(os.path.join(log_dir, "spans.json")):
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Stopwatch:
    """Wall-clock section timer; ``sync_value`` (a tensor or array) is read
    back before the section's clock stops, so that queued device work is
    inside it. Each section is a ``span`` of its name."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        s = span(name)
        try:
            with s:
                try:
                    yield
                finally:
                    if sync_value is not None:
                        float(np.asarray(sync_value.cpu() if hasattr(sync_value, "cpu")
                                         else sync_value).ravel()[0])
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + s.seconds

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total: {total:.3f}s"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v:.3f}s ({100 * v / max(total, 1e-12):.1f}%)")
        return "\n".join(lines)
