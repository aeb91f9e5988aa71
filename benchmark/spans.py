"""The program's own spans over a traced window.

The port records spans (``ceres_slam_tpu_torch.utils.telemetry``) while a
``torch.profiler`` session runs, as it does over a traced run's window: each
a dict ``id``, ``parent`` (None for a top-level span), ``request`` (its
top-level span's id), ``name``, ``t0``, ``t1`` (``time.perf_counter``, the
clock the harness stamps its items with) and ``attrs``. A reader takes the
spans that start inside the window, from the first item's start to the last
one's end, so that the warm-up's stay out. A program that keeps no spans
gives ``None``, never an error, and so does a store that dropped spans: a
reader would count short."""

from __future__ import annotations


def window(run) -> list | None:
    """The program's spans that start inside the window, or None where
    there are none or the store dropped any."""
    try:
        from ceres_slam_tpu_torch.utils import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "spans", None)
    if read is None or not run.records or telemetry.dropped():
        return None
    w0, w1 = run.records[0]["t0"], run.records[-1]["t1"]
    inside = [s for s in read() if w0 <= s["t0"] <= w1]
    return inside or None


def named(run, name: str) -> list:
    """The window's spans named ``name`` (empty where there are none)."""
    return [s for s in window(run) or () if s["name"] == name]


def units(run) -> int:
    """The solves (or runs) the window completed."""
    return sum(r["solves"] for r in run.records)


def node_ms(run, part) -> float | None:
    """Milliseconds an LM iteration of the window's LM nodes (``lm.node``
    spans) spend in ``part(device_ns)`` (the node's device nanoseconds, then
    each inner loop's, summed over its run), over the iterations they ran;
    None without such spans or where a node has no inner loop."""
    nodes = named(run, "lm.node")
    its = sum(s["attrs"]["iterations"] for s in nodes)
    if not its or any(len(s["attrs"].get("device_ns", ())) < 2 for s in nodes):
        return None
    return sum(part(s["attrs"]["device_ns"]) for s in nodes) / its / 1e6
