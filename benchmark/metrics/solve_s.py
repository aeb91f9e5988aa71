"""Seconds a solve: the window's wall over the whole solves completed in it."""

from benchmark import stats


def read(run):
    return stats.per_item(run.window_s, sum(r["solves"] for r in run.records))
