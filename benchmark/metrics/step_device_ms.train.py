"""Busy device milliseconds per traced training step: the union of the
device intervals inside the steps, over the number of steps."""


def read(trace):
    return trace.busy_ns() / 1e6 / len(trace.units)
