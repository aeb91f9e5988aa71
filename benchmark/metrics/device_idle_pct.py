"""The device's idle share of the traced window, in percent: 100 (1 - busy /
wall), busy the union of the device operations the profiler sees outside
WHILE nodes and each node's span by CUDA events (gaps inside a node count as
busy). One reader for every cell's ``device_idle_pct.<suffix>``."""

from benchmark import trace


def read(run):
    return trace.idle_pct(run)
