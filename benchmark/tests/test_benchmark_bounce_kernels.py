"""``bounce_kernels_ms.train`` on a synthetic trace: device ms per step of the
three bounce kernels by name, wherever they were launched from, lookalike
names left out, and nothing to read where no such kernel ran or the program
records no step."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.test_benchmark_kernel_names import _trace

BOUNCE = ["(anonymous namespace)::bounce_shade_kernel(BounceScene, float const*, float const*)",
          "(anonymous namespace)::bounce_finish_kernel(BounceScene, float*, float*)",
          "(anonymous namespace)::bounce_adjoint_kernel(BounceScene, float const*)"]
LOOKALIKES = ["void my_bounce_shade_kernel(float const*)",
              "void bounce_finish_kernels(float const*)",
              "void at::native::bounce_adjoint_kernel_impl<float>(float const*)",
              "void (anonymous namespace)::segment_sum_partial<int>(float const*, int const*)",
              "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>"]


@pytest.mark.parametrize("case", ["all", "none", "no_steps"])
def test_bounce_kernels_by_name(case):
    names = LOOKALIKES + BOUNCE + BOUNCE[:1]
    if case == "none":
        names = [n for n in names if n not in BOUNCE]
    got = harness.metric_reader("bounce_kernels_ms.train")(_trace(names, steps=case != "no_steps"))
    if case == "all":
        want = sum(i + 1 for i, n in enumerate(names[:-1]) if n in BOUNCE) / 1e6 / 2
        assert got == pytest.approx(want, rel=1e-12) and got > 0
    else:
        assert got is None
