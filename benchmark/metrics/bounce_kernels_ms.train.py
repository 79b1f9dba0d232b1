"""Device milliseconds per traced training step of the bounce kernels, found
by kernel name: ``bounce_shade_kernel``, ``bounce_finish_kernel`` and
``bounce_adjoint_kernel`` (``pathtracer_tpu_torch/csrc/bounce.cu``), the
fit's waves and their path replay. By name, the kernels count wherever they
were launched from, a replayed CUDA graph's launch included; only kernels
that start inside the timed units count. Nothing to read where no such
kernel ran (the program runs the bounce as torch ops) or the program records
no ``pt.train_step``."""

import re

import numpy as np

from benchmark import spans

NAME = re.compile(r"(^|[\s:])bounce_(shade|finish|adjoint)_kernel\(")


def read(trace):
    hit = {n: bool(NAME.search(n)) for n in set(trace.names)}
    mask = np.fromiter(map(hit.__getitem__, trace.names), dtype=bool,
                       count=len(trace.names))
    if not mask.any():
        return None
    k = trace.kernels[mask]
    k = k[spans._inside(spans._sorted_units(trace), k[:, 0])]
    return spans.per_step(trace, float(np.sum(k[:, 1] - k[:, 0])) / 1e6)
