"""Idle device milliseconds per traced training step whose gap ended with a
kernel launched inside the program's ``pt.bounce`` spans (forward waves and
path replay): the device waiting on the bounce's host dispatch, after each
sync among them. Nothing to read where the program records no
``pt.train_step``."""

from benchmark import spans


def read(trace):
    return spans.per_step(trace, spans.idle_ns_in(trace, "pt.bounce") / 1e6)
