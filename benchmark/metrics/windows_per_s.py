"""Windows solved a second: every window of the window (every chain's),
over its whole wall."""

from benchmark import stats


def read(run):
    return stats.rate(sum(r["windows"] for r in run.records), run.window_s)
