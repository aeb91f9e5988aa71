"""Milliseconds of host time a solve spends in ``pcg.prepare`` (the gather
tables, the full-batch plan, the banded preconditioner's tracks, the sun and
prior terms: its ``pcg.prepare`` spans), over the solves of the traced
window."""

from benchmark import spans


def read(run):
    prep = spans.named(run, "pcg.prepare")
    n = spans.units(run)
    if not prep or not n:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in prep) / n
