"""Host waits for the device per traced training step: the program's
``pt.sync`` spans (the bounce loop's ``bool(torch.any(alive))``) over its
``pt.train_step`` spans. Nothing to read where the program records none."""

from benchmark import spans


def read(trace):
    return spans.per_step(trace, float(len(spans.spans(trace, "pt.sync"))))
