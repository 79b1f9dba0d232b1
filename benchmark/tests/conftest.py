"""CPU runs of the benchmark's drivers at test sizes."""

from __future__ import annotations

import time

import pytest

from benchmark import harness

# Test sizes: a 16x16 image, few samples and bounces, on the CPU.
SMALL = {"width": 16, "height": 16, "samples_per_pixel": 4, "max_depth": 6}

# The entries that bring back the render and preview cells, whose files stay
# under benchmark/ while the card's small kernel fails their exact ray count
# (PERF.md, Open questions). Their bounds are placeholders: a cell that
# comes back is measured anew.
LEFT_OUT = {
    "workloads": [
        {"name": "cornell_render_512_spp50", "config": "cornell_box_full_lighting",
         "traffic": "offline_regen", "chips": 1, "why": "renders through the pool"},
        {"name": "cornell_preview_512_scan", "config": "cornell_box_full_lighting",
         "traffic": "preview_scan", "chips": 1, "why": "progressive frames of the scan"},
    ],
    "end_to_end": [
        {"name": "paths_per_s", "unit": "paths/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["cornell_render_512_spp50"]},
        {"name": "frame_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["cornell_preview_512_scan"]},
    ],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": moves, "workloads": [cell]}
        for name, unit, better, source, layer, moves, cell in (
            ("device_idle_share.render", "%", "lower", "device_trace", "Device",
             "paths_per_s", "cornell_render_512_spp50"),
            ("pool_iter_ms.render", "ms", "lower", "program_counter", "Pool",
             "paths_per_s", "cornell_render_512_spp50"),
            ("intersect_roofline_share.render", "%", "higher", "device_trace",
             "Intersection", "paths_per_s", "cornell_render_512_spp50"),
            ("device_idle_share.preview", "%", "lower", "device_trace", "Device",
             "frame_p95_ms", "cornell_preview_512_scan"))
    ],
}


def spec_with_left_out() -> dict:
    """``BENCHMARK.json`` with the left-out cells' entries added back."""
    spec = harness.load_spec()
    for key, entries in LEFT_OUT.items():
        spec[key] = spec[key] + [dict(e) for e in entries]
    return spec


def run_cell(name: str, tmp_path, seed: int = 2**31 + 7, seconds: float = 0.0,
             overrides=None, spec=None, trace: bool = False):
    """One run of a cell on the CPU, past the harness's look for a card:
    (context, outcome, result line)."""
    spec = spec or spec_with_left_out()
    cell = harness.load_cell(name, spec)
    ctx = harness.Context(cell=cell, config=harness.load_config(cell["config"]), seed=seed,
                          seconds=seconds, trace=trace, device="cpu", t0=time.perf_counter(),
                          workdir=str(tmp_path), overrides=dict(SMALL, **(overrides or {})))
    out = harness.driver(cell["driver"]).run(ctx)
    return ctx, out, harness.result_line(spec, ctx, out, {"platform": "cpu"})


@pytest.fixture
def cell_run(tmp_path):
    def go(name, **kw):
        return run_cell(name, tmp_path, **kw)
    return go
