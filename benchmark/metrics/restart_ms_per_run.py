"""Milliseconds of host time a run spends restarting its stages' captured LM
loops (copying the run's inputs into the captured tensors: ``lm.GRAPH_STATS``
``restart_s`` over the traced window, over the runs completed in it)."""


def read(run):
    t = run.trace
    n = sum(r["solves"] for r in run.records)
    if t is None or not n or not t.graph_stats["lm"]["restarts"]:
        return None
    return 1e3 * t.graph_stats["lm"]["restart_s"] / n
