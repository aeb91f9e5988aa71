"""Milliseconds of host work a step: the host-clock walls of the steps
outside the traced run's profiled segments (the profiler's cost on every
host operation would inflate them) less the spans of their nodes by CUDA
events, over those steps."""


def read(run):
    t = run.trace
    steps = [s for r in run.records for s in r.get("quiet_steps_ms", [])]
    if t is None or not steps or len(t.quiet_node_s) != len(steps):
        return None
    return (sum(steps) - 1e3 * sum(t.quiet_node_s)) / len(steps)
