"""Microseconds of device time a trust-region iteration in the node: CUDA
events around every ``DeviceWhile.launch`` of the traced window, summed,
over the iterations the nodes ran (their counts as the host reads them; a
batch of windows iterates in lockstep, one count for all)."""


def read(run):
    t = run.trace
    if t is None or not t.node_s or not t.node_iterations:
        return None
    return 1e6 * sum(t.node_s) / t.node_iterations
