"""Megabytes (1e6 bytes) the program uploads from the host to the card a
solve or run: the ``h2d_bytes`` its top-level spans count (every upload
through ``telemetry.to_device`` in their subtree), summed over the traced
window, over the solves or runs completed in it. One reader for every
cell's ``h2d_mb.<suffix>``."""

from benchmark import spans


def read(run):
    top = [s for s in spans.window(run) or () if s["parent"] is None]
    n = spans.units(run)
    if not top or not n:
        return None
    return sum(s["attrs"].get("h2d_bytes", 0) for s in top) / 1e6 / n
