"""Device milliseconds per traced training step of the intersection
kernels, found by kernel name: ``small_kernel``, ``shortlist_kernel``,
``tiled_kernel`` and ``cluster_kernel`` (``pathtracer_tpu_torch/csrc/``),
closest and any-hit, in the forward waves and the path replay. The kernels
alone: the wrappers' torch ops and the material lookup are not counted. By
name, the kernels count wherever they were launched from, a replayed CUDA
graph's launch included; only kernels that start inside the timed units
count. Nothing to read where no such kernel ran or the program records no
``pt.train_step``."""

import re

import numpy as np

from benchmark import spans

NAME = re.compile(r"(^|[\s:])(small|shortlist|tiled|cluster)_kernel<")


def read(trace):
    hit = {n: bool(NAME.search(n)) for n in set(trace.names)}
    mask = np.fromiter(map(hit.__getitem__, trace.names), dtype=bool,
                       count=len(trace.names))
    if not mask.any():
        return None
    k = trace.kernels[mask]
    k = k[spans._inside(spans._sorted_units(trace), k[:, 0])]
    return spans.per_step(trace, float(np.sum(k[:, 1] - k[:, 0])) / 1e6)
