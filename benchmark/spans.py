"""The program's own spans in a traced window.

The port records ``torch.profiler`` ranges named ``pt.*`` around its layers
(``pathtracer_tpu_torch/utils/profiling.py`` lists them). They are host
events on the profiler's clock, so ``harness.trace_from_profiler`` keeps them
in ``Trace.host`` beside the aten ops. Here they are read the way
``Trace.launched_in`` reads the harness's own ranges: a kernel belongs to a
span when its launch lies inside it, and an idle gap belongs to the span in
which the kernel that ended the gap was launched. Only spans that start
inside the timed units count. A program that records no span leaves every
per-step value ``None``.
"""

from __future__ import annotations

import numpy as np

STEP = "pt.train_step"


def _sorted_units(trace) -> np.ndarray:
    return trace.units[np.argsort(trace.units[:, 0], kind="stable")]


def _inside(intervals: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Mask of the times ``t`` inside one of the ``intervals`` ([n, 2],
    sorted by start, none enclosing another); a nan time lies in none."""
    t = np.asarray(t, dtype=np.float64)
    out = np.zeros(len(t), dtype=bool)
    if not len(intervals):
        return out
    i = np.searchsorted(intervals[:, 0], t, side="right") - 1
    ok = (i >= 0) & ~np.isnan(t)
    out[ok] = t[ok] <= intervals[i[ok], 1]
    return out


def spans(trace, name: str) -> np.ndarray:
    """[n, 2] (start, end) of the host spans called ``name`` that start
    inside a unit, sorted by start."""
    starts, ends, names = trace.host
    s = np.asarray([(a, b) for a, b, n in zip(starts, ends, names) if n == name],
                   dtype=np.float64).reshape(-1, 2)
    s = s[np.argsort(s[:, 0], kind="stable")]
    return s[_inside(_sorted_units(trace), s[:, 0])]


def launched_in(trace, name: str) -> np.ndarray:
    """Mask of the kernels whose launch lies inside a span called ``name``
    (spans of one name never nest: the program enters none inside itself)."""
    return _inside(spans(trace, name), trace.launch)


def device_ns_in(trace, name: str) -> float:
    """Device ns of the kernels launched inside the spans called ``name``."""
    k = trace.kernels[launched_in(trace, name)]
    return float(np.sum(k[:, 1] - k[:, 0]))


def gaps(trace) -> tuple[np.ndarray, np.ndarray]:
    """(ns, ending kernel's index) of each idle gap inside the units, as
    ``Trace.breakdown`` finds them: from a unit's start or the end of the
    device's last busy interval in it to the start of the next one."""
    units = _sorted_units(trace)
    busy = trace.busy()
    busy = busy[np.argsort(busy[:, 0], kind="stable")]
    if not len(busy):
        return np.zeros(0), np.zeros(0, dtype=np.int64)
    unit_of = np.searchsorted(units[:, 0], busy[:, 0], side="right") - 1
    prev_end = units[unit_of, 0].copy()
    same = np.r_[False, unit_of[1:] == unit_of[:-1]]
    prev_end[same] = busy[:-1, 1][same[1:]]
    gap = busy[:, 0] - prev_end
    keep = gap > 0
    order = np.argsort(trace.kernels[:, 0], kind="stable")
    first = np.searchsorted(trace.kernels[order, 0], busy[keep, 0])
    return gap[keep], order[np.minimum(first, len(order) - 1)]


def idle_ns_in(trace, name: str) -> float:
    """Idle ns of the gaps whose ending kernel was launched inside a span
    called ``name``."""
    gap, ending = gaps(trace)
    return float(np.sum(gap[launched_in(trace, name)[ending]]))


def per_step(trace, value: float) -> float | None:
    """``value`` over the training steps (``pt.train_step`` spans) inside
    the units; ``None`` where the program recorded none."""
    n = len(spans(trace, STEP))
    return value / n if n else None
