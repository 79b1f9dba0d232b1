"""The general part of the benchmark: finding a cell's files by name, the
measured window, the traced window and its reduction, and the result line.

What belongs to one configuration, cell, driver or per-layer metric sits in
a file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json``: the scene and its settings;
- ``benchmark/workloads/<cell>.json``: the configuration, the driver, the
  traffic's parameters, the chips and why the cell exists;
- ``benchmark/drivers/<driver>.py``: ``run(ctx) -> Outcome``;
- ``benchmark/metrics/<metric>.py``: ``read(trace) -> float | None``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracer_tpu")
UNIT = "bench.unit"  # the profiler range around one timed unit
TOP = 10


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, spec: dict) -> dict:
    """The cell's file, checked against its entry in ``BENCHMARK.json``."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    cell = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise SystemExit(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    cell["name"] = name
    return cell


def load_config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in spec["per_layer"] if cell in m["workloads"]]
    return e2e, layer


# --- statistics of the end-to-end metrics ---
def rate(count: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    return count / seconds


def p95(values) -> float:
    """95th percentile, ``statistics.quantiles`` (inclusive) of every sample."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


# --- the window ---
@dataclasses.dataclass
class Window:
    """Whole units run until ``seconds`` have passed: each unit's host
    seconds (start to its ``torch.cuda.synchronize()``) and the total."""

    units: list
    seconds: float


def run_window(unit, seconds: float, sync, traced: bool = False, after=None) -> Window:
    """Run ``unit(i)`` for i = 0, 1, ... until the window holds ``seconds``;
    every unit ends in ``sync()``. A traced window wraps each unit in a
    profiler range and calls ``after(i)`` between units, outside them."""
    from torch.profiler import record_function

    spans = []
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        with (record_function(UNIT) if traced else contextlib.nullcontext()):
            unit(i)
            sync()
        b = time.perf_counter()
        spans.append(b - a)
        if after is not None:
            after(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            print(f"[bench] window: {len(spans)} units in {b - t0:.4f} s; unit s min "
                  f"{min(spans):.4f} median {statistics.median(spans):.4f} max "
                  f"{max(spans):.4f}", file=sys.stderr)
            return Window(units=spans, seconds=b - t0)


# --- the traced window ---
@dataclasses.dataclass
class Trace:
    """What a traced window saw, on the profiler's clock (ns).

    ``units``: [n, 2] spans of the timed units; ``kernels``: [k, 2] device
    intervals with ``names`` and ``launch`` (the host time of each one's
    launch, nan where the trace had none); ``ranges``: spans of the
    harness's own profiler ranges by name; ``host``: (starts, ends, names)
    of host ops sorted by start; ``counters``: counts the harness took
    around the program's calls."""

    units: np.ndarray
    kernels: np.ndarray
    names: list
    launch: np.ndarray
    ranges: dict
    host: tuple
    counters: dict

    def window_ns(self) -> float:
        return float(np.sum(self.units[:, 1] - self.units[:, 0]))

    def busy(self) -> np.ndarray:
        """[m, 2] union of the device intervals, clipped to the units."""
        out = []
        for a, b in self.units:
            k = self.kernels[(self.kernels[:, 1] > a) & (self.kernels[:, 0] < b)]
            if not len(k):
                continue
            k = np.clip(k, a, b)
            k = k[np.argsort(k[:, 0], kind="stable")]
            s, e = k[0]
            for x, y in k[1:]:
                if x > e:
                    out.append((s, e))
                    s, e = x, y
                else:
                    e = max(e, y)
            out.append((s, e))
        return np.asarray(out, dtype=np.float64).reshape(-1, 2)

    def busy_ns(self) -> float:
        b = self.busy()
        return float(np.sum(b[:, 1] - b[:, 0]))

    def idle_percent(self) -> float:
        return 100.0 * (1.0 - self.busy_ns() / self.window_ns())

    def launched_in(self, range_name: str) -> np.ndarray:
        """Mask of the kernels whose launch lies inside a range of that name."""
        spans = np.asarray(self.ranges.get(range_name, []), dtype=np.float64).reshape(-1, 2)
        if not len(spans):
            return np.zeros(len(self.launch), dtype=bool)
        spans = spans[np.argsort(spans[:, 0])]
        i = np.searchsorted(spans[:, 0], self.launch, side="right") - 1
        ok = (i >= 0) & ~np.isnan(self.launch)
        inside = np.zeros(len(self.launch), dtype=bool)
        inside[ok] = self.launch[ok] <= spans[i[ok], 1]
        return inside

    def breakdown(self) -> dict:
        """The device ops with the most time, and the idle gaps inside the
        units by the host op in whose span the next kernel was launched."""
        by_op: dict = {}
        dur = self.kernels[:, 1] - self.kernels[:, 0]
        for name, t in zip(self.names, dur):
            by_op[name] = by_op.get(name, 0.0) + float(t)
        busy = self.busy()
        starts, ends, hnames = self.host
        order = np.argsort(self.kernels[:, 0], kind="stable")
        k_start = self.kernels[order, 0]
        gaps: dict = {}
        unit_of = np.searchsorted(self.units[:, 0], busy[:, 0], side="right") - 1
        for j in range(len(busy)):
            prev_end = (busy[j - 1, 1] if j and unit_of[j - 1] == unit_of[j]
                        else self.units[unit_of[j], 0])
            gap = busy[j, 0] - prev_end
            if gap <= 0:
                continue
            nxt = order[min(np.searchsorted(k_start, busy[j, 0]), len(order) - 1)]
            label = _host_at(self.launch[nxt], starts, ends, hnames)
            gaps[label] = gaps.get(label, 0.0) + gap
        top = lambda d: [[k[:160], v / 1e9] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def _host_at(t, starts, ends, names, look_back: int = 256) -> str:
    """The innermost host op running at ``t`` among the ``look_back`` that
    started last before it (a launch lies inside the op that made it)."""
    if math.isnan(t):
        return "unknown"
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if ends[j] >= t:
            return names[j]
    return "none"


_LAUNCH_PREFIXES = ("cuda", "cu")


def trace_from_profiler(prof, counters: dict) -> Trace:
    """Reduce a ``torch.profiler`` run to a ``Trace``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, names, corr, links = [], [], [], []
    launches: dict = {}
    ranges: dict = {}
    host = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name.startswith("bench."):
                continue  # the harness's ranges, mirrored on the device's timeline
            kernels.append((start, end))
            names.append(name)
            corr.append(e.correlation_id())
            links.append(e.linked_correlation_id())
        elif name.startswith("bench."):
            ranges.setdefault(name, []).append((start, end))
        elif name.startswith(_LAUNCH_PREFIXES):
            launches[e.correlation_id()] = start
        else:
            host.append((start, end, name))
    if not kernels:
        raise RuntimeError("the profiler recorded no device interval")
    launch = np.array([launches.get(c, launches.get(l, np.nan)) for c, l in zip(corr, links)],
                      dtype=np.float64)
    host.sort()
    units = np.asarray(ranges.pop(UNIT), dtype=np.float64).reshape(-1, 2)
    print(f"[bench] trace: {len(kernels)} device intervals, "
          f"{int(np.sum(~np.isnan(launch)))} with a launch, {len(host)} host ops, "
          f"{len(units)} units", file=sys.stderr)
    return Trace(units=units, kernels=np.asarray(kernels, dtype=np.float64),
                 names=names, launch=launch, ranges=ranges,
                 host=([h[0] for h in host], [h[1] for h in host], [h[2] for h in host]),
                 counters=counters)


# --- the run ---
@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration, the run's seed and
    window, whether to trace, the device, and the process's start."""

    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    workdir: str
    overrides: dict = dataclasses.field(default_factory=dict)

    def settings(self) -> dict:
        """The configuration's settings with the test-only overrides."""
        s = dict(self.config["settings"])
        s.update(self.overrides)
        return s


@dataclasses.dataclass
class Outcome:
    """What a driver returns: its end-to-end values (``setup_s`` included),
    units attempted and failed, the compared numbers as (name, value,
    limit), the peak device memory and, from a traced run, its ``Trace``."""

    metrics: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    trace: Trace | None = None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(spec: dict, ctx: Context, out: Outcome, device: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, the
    breakdown (traced) and the compared numbers with their limits."""
    e2e, layer = cell_metrics(spec, ctx.cell["name"])
    metrics = {}
    if ctx.trace:
        for m in layer:
            v = metric_reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = dict(device, busy_s=out.trace.busy_ns() / 1e9,
                      window_s=out.trace.window_ns() / 1e9)
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    correct = all(v <= lim for _, v, lim in out.checks) and out.failed == 0
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if ctx.trace:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line
