"""Percent of the traced progressive renders (whole frames)' wall time in which no operation ran on
the device: 100 x (1 - union of the device intervals / the traced window),
both from torch.profiler over the same whole renders."""


def read(trace):
    return trace.idle_percent()
