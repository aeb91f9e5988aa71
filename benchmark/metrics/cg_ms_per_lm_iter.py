"""Milliseconds of device time an LM iteration spends in the nested CG loop:
the LM nodes' inner-loop nanoseconds (the WHILE node's own timers, read with
its iteration counts: ``lm.node`` ``device_ns[1]``), summed over the traced
window, over the LM iterations the nodes ran."""

from benchmark import spans


def read(run):
    return spans.node_ms(run, lambda ns: ns[1])
