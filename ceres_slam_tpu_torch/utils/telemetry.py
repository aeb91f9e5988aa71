"""Solver reports, a device trace and a wall-clock section timer.

Port of ``ceres_slam_tpu/utils/telemetry.py`` (``brief_report``,
``full_report``, ``trace``, ``Stopwatch``), kept in the port because
importing anything under ``ceres_slam_tpu`` imports JAX. The reference's
only performance signal is Ceres' BriefReport per window; the LM loops
record the per-iteration history when ``SolveConfig.record_history`` is
set, and ``full_report`` prints it. ``trace`` records a ``torch.profiler``
trace (the host and, where there is a card, the device) in place of the
JAX module's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


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


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Record a ``torch.profiler`` trace around a code block and write it
    as a Chrome trace (``trace.json``, viewable in Perfetto) into
    ``log_dir``, by default ``ceres_slam_tpu_torch_trace`` in the temporary
    directory. Yields ``log_dir``."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "ceres_slam_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Stopwatch:
    """Wall-clock section timer; ``sync_value`` (a tensor or array) is read
    back before the section's clock stops, so that queued device work is
    inside it."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                float(np.asarray(sync_value.cpu() if hasattr(sync_value, "cpu")
                                 else sync_value).ravel()[0])
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total: {total:.3f}s"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v:.3f}s ({100 * v / max(total, 1e-12):.1f}%)")
        return "\n".join(lines)
