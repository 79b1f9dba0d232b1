"""Device milliseconds per traced training step of the kernels launched
inside the program's ``pt.intersect`` spans: each ``closest_hit`` (its
material lookup included) and ``occluded_before`` call's torch ops and its
kernel, in the forward waves and the path replay. Nothing to read where the
program records no ``pt.train_step``."""

from benchmark import spans


def read(trace):
    return spans.per_step(trace, spans.device_ns_in(trace, "pt.intersect") / 1e6)
