"""The 95th percentile of the steps of the traced window outside its profiled
segment (the profiler's cost on every host operation would inflate them),
in milliseconds: a step is one window index of every chain, timed on the
host to the end of its one read. What a rover running VO online feels;
host-paced, so a per-layer metric beside ``windows_per_s``. One reader for
every cell's ``step_p95_ms.<suffix>``."""

from benchmark import stats


def read(run):
    return stats.percentile([s for r in run.records for s in r.get("quiet_steps_ms", [])], 95)
