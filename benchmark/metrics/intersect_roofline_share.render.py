"""Percent of the roofline that the intersection calls reach: the summed
bound (``reference/roofline.py``) of every ``closest_hit`` and
``occluded_before`` call the bounce layer made in the traced renders, over
the device time of the kernels launched inside those calls. A kernel counts
by its launch's host time falling inside the harness's ``bench.intersect``
range around a call, not by its name."""


def read(trace):
    bound = trace.counters.get("intersect_bound_ms", 0.0)
    mask = trace.launched_in("bench.intersect")
    device_ms = float((trace.kernels[mask, 1] - trace.kernels[mask, 0]).sum()) / 1e6
    return 100.0 * bound / device_ms if bound and device_ms else None
