"""Milliseconds of host wall a run spends in the program outside its LM
nodes: its top-level spans (the initial guess, the padded problem, each
stage, the solution absorbed) less the ``lm.node`` spans in their trees
(launch to the read after it), summed over the traced window, over the runs
completed in it. It holds the host's work (the problems' and the solver's:
RANSAC's host chain, the tables, the restarts, the readouts) and the host's
waits on device work outside the nodes (RANSAC's batched solves), and, read
in a traced run, the profiler's cost on each host operation. The harness's
own work between the program's calls (the dataset's copy) falls outside
every span."""

from benchmark import spans


def read(run):
    inside = spans.window(run) or ()
    top = [s for s in inside if s["parent"] is None]
    n = spans.units(run)
    if not top or not n:
        return None
    roots = {s["id"] for s in top}
    nodes = sum(s["t1"] - s["t0"] for s in inside
                if s["name"] == "lm.node" and s["request"] in roots)
    return 1e3 * (sum(s["t1"] - s["t0"] for s in top) - nodes) / n
