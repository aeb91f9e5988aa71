"""Milliseconds of device time an LM iteration in the nodes: CUDA events
around every ``DeviceWhile.launch`` of the traced window, summed, over the
LM iterations the nodes ran (their counts, as the host reads them after each
launch; where a stage is captured, its first iteration runs eagerly, outside
the node, and in the cells that restart kept captures no capture falls in
the window). One reader for every cell's ``lm_iter_ms.<suffix>``."""


def read(run):
    t = run.trace
    if t is None or not t.node_s or not t.node_iterations:
        return None
    return 1e3 * sum(t.node_s) / t.node_iterations
