"""CUDA-graph replays per traced training step: the program's
``pt.graph_replay`` spans (``inverse.make_train_step`` replaying the step's
captured graph) over its ``pt.train_step`` spans; 1.0 where every step
replays, 0.0 where every step dispatches its ops one by one. Nothing to read
where the program records no ``pt.train_step``."""

from benchmark import spans


def read(trace):
    return spans.per_step(trace, float(len(spans.spans(trace, "pt.graph_replay"))))
