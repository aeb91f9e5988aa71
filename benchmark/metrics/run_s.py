"""Seconds a run (``dataset_ba_phong`` after its CSV is read, its stages
restarting captures kept from the warm-up): the window's wall over the
whole runs completed in it."""

from benchmark import stats


def read(run):
    return stats.per_item(run.window_s, sum(r["solves"] for r in run.records))
