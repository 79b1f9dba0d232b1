"""The program's spans in a synthetic trace: ``benchmark/spans.py``'s launch
and gap attribution, a launch just outside a span, and the four readers of
the ``pt.*`` spans, with nothing to read where the program records none."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, spans

READERS = ("gather_backward_ms.train", "bounce_idle_ms.train", "intersect_device_ms.train",
           "host_syncs_per_step.train")


def _trace(with_steps: bool = True):
    """Two units of one step each. Kernels by index: 0 and 4 launched in an
    intersection call inside a bounce, 1 and 5 in a bounce (5 at its very
    end), 2 and 3 in the gather backward, 6 just after a gather backward
    ended, 7 between the units."""
    units = np.array([[0.0, 100.0], [200.0, 300.0]])
    kernels = np.array([[12.0, 15.0], [40.0, 45.0], [55.0, 80.0], [256.0, 270.0],
                        [215.0, 218.0], [244.0, 250.0], [290.0, 295.0], [160.0, 170.0]])
    launch = np.array([11.0, 25.0, 52.0, 255.0, 212.0, 240.0, 262.5, 150.5])
    host = [(1.0, 99.0, "pt.train_step"), (201.0, 299.0, "pt.train_step"),
            (5.0, 30.0, "pt.bounce"), (205.0, 240.0, "pt.bounce"),
            (10.0, 20.0, "pt.intersect"), (210.0, 220.0, "pt.intersect"),
            (50.0, 60.0, "pt.gather_backward"), (250.0, 262.0, "pt.gather_backward"),
            (31.0, 32.0, "pt.sync"), (241.0, 242.0, "pt.sync"), (243.0, 244.0, "pt.sync"),
            (150.0, 151.0, "pt.sync"), (11.0, 11.5, "aten::mul"), (240.0, 240.2, "aten::add")]
    if not with_steps:
        host = [h for h in host if h[2] != "pt.train_step"]
    host.sort()
    return harness.Trace(units=units, kernels=kernels, names=["k"] * len(kernels),
                         launch=launch, ranges={},
                         host=tuple(list(x) for x in zip(*host)), counters={})


def test_spans_inside_the_units():
    t = _trace()
    assert spans.spans(t, "pt.sync").tolist() == [[31.0, 32.0], [241.0, 242.0],
                                                   [243.0, 244.0]]
    assert len(spans.spans(t, spans.STEP)) == 2
    assert spans.spans(t, "pt.none").shape == (0, 2)


def test_launch_attribution():
    t = _trace()
    assert spans.launched_in(t, "pt.bounce").tolist() == [
        True, True, False, False, True, True, False, False]
    # kernel 6 was launched at 262.5, just after the gather backward's end
    assert spans.launched_in(t, "pt.gather_backward").tolist() == [
        False, False, True, True, False, False, False, False]
    # kernel 7's launch lies in a span outside the units: not counted
    assert not spans.launched_in(t, "pt.sync").any()
    assert spans.device_ns_in(t, "pt.intersect") == 6.0
    assert spans.device_ns_in(t, "pt.gather_backward") == 39.0


def test_gap_attribution():
    t = _trace()
    gap, ending = spans.gaps(t)
    assert gap.tolist() == [12.0, 25.0, 10.0, 15.0, 26.0, 6.0, 20.0]
    assert ending.tolist() == [0, 1, 2, 4, 5, 3, 6]
    assert sum(v for _, v in t.breakdown()["idle_gaps"]) == pytest.approx(gap.sum() / 1e9)
    assert spans.idle_ns_in(t, "pt.bounce") == 12.0 + 25.0 + 15.0 + 26.0
    assert spans.idle_ns_in(t, "pt.gather_backward") == 16.0
    assert spans.idle_ns_in(t, "pt.bounce") / 2 <= (t.window_ns() - t.busy_ns()) / 2


def test_readers_per_step():
    t = _trace()
    got = {name: harness.metric_reader(name)(t) for name in READERS}
    assert got == pytest.approx({"gather_backward_ms.train": 19.5e-6,
                                 "bounce_idle_ms.train": 39e-6,
                                 "intersect_device_ms.train": 3e-6,
                                 "host_syncs_per_step.train": 1.5})


def test_readers_find_nothing_without_the_programs_spans():
    bare = _trace(with_steps=False)
    assert all(harness.metric_reader(name)(bare) is None for name in READERS)
    plain = harness.Trace(units=np.array([[0.0, 10.0]]), kernels=np.array([[1.0, 2.0]]),
                          names=["k"], launch=np.array([0.5]), ranges={},
                          host=([0.0], [1.0], ["aten::mul"]), counters={})
    assert all(harness.metric_reader(name)(plain) is None for name in READERS)
