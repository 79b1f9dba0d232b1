"""``graph_replays_per_step.train`` on a synthetic trace: the program's
``pt.graph_replay`` spans over its ``pt.train_step`` spans, 1.0 where every
step replays its graph, 0.0 where none does, and nothing to read where the
program records no step."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

READER = "graph_replays_per_step.train"


def _trace(steps: bool = True, replays: bool = True):
    """Two units of one step each; with ``replays`` each step replays its
    graph once, and a third replay lies outside the units."""
    units = np.array([[0.0, 100.0], [200.0, 300.0]])
    kernels = np.array([[12.0, 15.0], [40.0, 45.0], [215.0, 218.0], [160.0, 170.0]])
    launch = np.array([11.0, 10.5, 212.0, 150.5])
    host = [(10.0, 11.5, "aten::copy_"), (211.0, 212.5, "aten::copy_")]
    if steps:
        host += [(1.0, 99.0, "pt.train_step"), (201.0, 299.0, "pt.train_step")]
    if replays:
        host += [(10.4, 11.2, "pt.graph_replay"), (211.9, 212.2, "pt.graph_replay"),
                 (150.0, 151.0, "pt.graph_replay")]
    host.sort()
    return harness.Trace(units=units, kernels=kernels, names=["k"] * len(kernels),
                         launch=launch, ranges={},
                         host=tuple(list(x) for x in zip(*host)), counters={})


@pytest.mark.parametrize("steps, replays, want", [(True, True, 1.0), (True, False, 0.0),
                                                  (False, True, None),
                                                  (False, False, None)],
                         ids=["replayed", "eager", "no_steps", "bare"])
def test_graph_replays_per_step(steps, replays, want):
    got = harness.metric_reader(READER)(_trace(steps, replays))
    assert got == want
