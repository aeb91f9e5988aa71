"""Trust-region (LM or dogleg) iterations a window, from the windows'
``SolveSummary`` over the traced window."""


def read(run):
    n = sum(r["windows"] for r in run.records)
    return sum(r["iterations"] for r in run.records) / n if n else None
