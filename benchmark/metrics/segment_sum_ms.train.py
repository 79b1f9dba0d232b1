"""Device milliseconds per traced training step of the material gathers'
backward, found by kernel name: ``segment_sum_partial`` and
``segment_sum_finish`` (``pathtracer_tpu_torch/csrc/gather_backward.cu``).
By name, the kernels count wherever they were launched from, a replayed
CUDA graph's launch included; only kernels that start inside the timed
units count. Nothing to read where no such kernel ran or the program
records no ``pt.train_step``."""

import re

import numpy as np

from benchmark import spans

NAME = re.compile(r"(^|[\s:])segment_sum_(partial|finish)[<(]")


def read(trace):
    hit = {n: bool(NAME.search(n)) for n in set(trace.names)}
    mask = np.fromiter(map(hit.__getitem__, trace.names), dtype=bool,
                       count=len(trace.names))
    if not mask.any():
        return None
    k = trace.kernels[mask]
    k = k[spans._inside(spans._sorted_units(trace), k[:, 0])]
    return spans.per_step(trace, float(np.sum(k[:, 1] - k[:, 0])) / 1e6)
