"""LM iterations an item's solve or run (``SolveSummary.iterations``, summed
over a run's stages), over every solve or run of the traced window. One
reader for every cell's ``lm_iters.<suffix>``."""


def read(run):
    n = sum(r["solves"] for r in run.records)
    return sum(r["iterations"] for r in run.records) / n if n else None
