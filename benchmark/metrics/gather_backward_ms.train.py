"""Device milliseconds per traced training step of the kernels launched
inside the program's ``pt.gather_backward`` spans: the backward of the
material gathers, summing every path's gradient into its material's row. A
kernel counts by its launch's host time, not by its name. Nothing to read
where the program records no ``pt.train_step``."""

from benchmark import spans


def read(trace):
    return spans.per_step(trace, spans.device_ns_in(trace, "pt.gather_backward") / 1e6)
