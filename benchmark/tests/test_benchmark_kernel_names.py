"""``segment_sum_ms.train`` and ``intersect_kernels_ms.train`` on a synthetic
trace: device ms per step of the kernels with their names, wherever they
were launched from (inside a span, or all from one graph launch), and
nothing to read where no such kernel ran or the program records no step."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

GATHER = ["void (anonymous namespace)::segment_sum_partial<long>(float const*, long const*)",
          "void (anonymous namespace)::segment_sum_finish(float const*, long long, float*)"]
INTERSECT = ["void (anonymous namespace)::small_kernel<false>(float const*, float const*)",
             "void (anonymous namespace)::small_kernel<true>(float const*, float const*)",
             "void shortlist_kernel<false>(float const*)", "void tiled_kernel<true>(float const*)",
             "void cluster_kernel<false>(float const*)"]
OTHER = ["void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float> >",
         "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >",
         "void my_small_kernel<false>(float const*)", "void segment_sum_partials(float const*)"]


def _trace(names, steps: bool = True):
    """Two units of one step each; kernel ``i`` lasts ``i + 1`` ns, the last
    one starts outside the units; every launch is one replay's."""
    n = len(names)
    starts = np.r_[np.linspace(10.0, 90.0, n - 1), 150.0]
    kernels = np.stack([starts, starts + np.arange(1, n + 1)], axis=1)
    host = [(5.0, 6.0, "pt.graph_replay")]
    if steps:
        host += [(1.0, 99.0, "pt.train_step"), (201.0, 299.0, "pt.train_step")]
    host.sort()
    return harness.Trace(units=np.array([[0.0, 100.0], [200.0, 300.0]]), kernels=kernels,
                         names=list(names), launch=np.full(n, 5.5), ranges={},
                         host=tuple(list(x) for x in zip(*host)), counters={})


def _want_ms(names, wanted):
    """The wanted kernels' ns inside the units (all but the last), per step."""
    return sum(i + 1 for i, n in enumerate(names[:-1]) if n in wanted) / 1e6 / 2


@pytest.mark.parametrize("reader, wanted", [("segment_sum_ms.train", GATHER),
                                            ("intersect_kernels_ms.train", INTERSECT)],
                         ids=["segment_sum", "intersect_kernels"])
@pytest.mark.parametrize("case", ["all", "none", "no_steps"])
def test_kernels_by_name(reader, wanted, case):
    names = OTHER + GATHER + INTERSECT + wanted[:1]
    if case == "none":
        names = [n for n in names if n not in wanted]
    got = harness.metric_reader(reader)(_trace(names, steps=case != "no_steps"))
    if case == "all":
        assert got == pytest.approx(_want_ms(names, wanted), rel=1e-12) and got > 0
    else:
        assert got is None
