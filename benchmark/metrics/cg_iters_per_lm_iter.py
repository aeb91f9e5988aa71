"""CG iterations an LM iteration (``linear_iterations / iterations``), over
every solve of the traced window."""


def read(run):
    lm = sum(r["iterations"] for r in run.records)
    cg = sum(r.get("cg_iterations", 0) for r in run.records)
    return cg / lm if lm and cg else None
