"""Device milliseconds per traced training step of the shortlist kernel's
any-hit entry, found by kernel name: ``shortlist_kernel<true>``
(``pathtracer_tpu_torch/csrc/intersect_shortlist.cu``), the shadow rays of
the fit's waves. By name, the kernel counts wherever it was launched from,
a replayed CUDA graph's launch included; only kernels that start inside the
timed units count. Nothing to read where no such kernel ran (a scene below
the shortlist's triangle count) or the program records no
``pt.train_step``."""

import re

import numpy as np

from benchmark import spans

NAME = re.compile(r"(^|[\s:])shortlist_kernel<true>")


def read(trace):
    hit = {n: bool(NAME.search(n)) for n in set(trace.names)}
    mask = np.fromiter(map(hit.__getitem__, trace.names), dtype=bool,
                       count=len(trace.names))
    if not mask.any():
        return None
    k = trace.kernels[mask]
    k = k[spans._inside(spans._sorted_units(trace), k[:, 0])]
    return spans.per_step(trace, float(np.sum(k[:, 1] - k[:, 0])) / 1e6)
