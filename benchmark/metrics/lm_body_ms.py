"""Milliseconds of device time an LM iteration spends outside the nested CG
loop (K2's assembly, the right-hand side, the back-substitution, the
retraction, the trial cost, the control): the LM nodes' nanoseconds less
their CG loops' (``lm.node`` ``device_ns[0] - device_ns[1]``), summed over
the traced window, over the LM iterations the nodes ran."""

from benchmark import spans


def read(run):
    return spans.node_ms(run, lambda ns: ns[0] - ns[1])
