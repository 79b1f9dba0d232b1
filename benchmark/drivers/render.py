"""Offline renders: the window runs ``render.render_stats`` back to back,
each render with its own seed (the run's seed plus one plus its index), and
ends each in ``torch.cuda.synchronize()``. ``paths_per_s`` is width x height
x spp of every render over the window's wall time. After the window one
render drawn from the seed is rendered again by the plain reference: its
rays must be equal and its image equal up to the order of summation."""

from __future__ import annotations

import random
import time

import torch

from benchmark import checks, harness, program
from benchmark.reference import roofline


def intersect_bound_ms(calls, bounds) -> float:
    """The roofline bound (ms) of the intersection calls that ``calls``
    holds, which it then forgets; ``bounds`` = (cluster bounds, table rows)."""
    boxes, rows = bounds
    total = 0.0
    with torch.no_grad():
        for o, d, t in calls.closest:
            total += roofline.bound_ms(roofline.tests_needed(boxes, o, d, t),
                                       o.shape[0], rows, False)
        for o, d, t_cut, occ in calls.occluded:
            total += roofline.bound_ms(roofline.tests_needed(boxes, o, d, t_cut, occ),
                                       o.shape[0], rows, True)
    calls.closest.clear()
    calls.occluded.clear()
    return total


def scene_bounds(ctx):
    """Cluster bounds and table rows of the configuration's scene, packed
    by the reference in the port's order."""
    from benchmark import scenes
    from benchmark.reference import pack

    sc = pack.pack(scenes.load(ctx.config)[0], ctx.device)
    return (roofline.cluster_bounds(sc["tri_v0"], sc["tri_e1"], sc["tri_e2"]),
            roofline.padded_rows(sc["num_tris"]))


def traced_window(ctx, unit, sync) -> harness.Trace:
    """The traced run's window: ``trace_seconds`` of whole units under the
    profiler, with the pool's iterations and the intersection calls'
    roofline bound counted between units."""
    calls = program.Calls()
    bounds = scene_bounds(ctx)
    bound = [0.0]

    def after(_):
        bound[0] += intersect_bound_ms(calls, bounds)

    with program.wrapped(calls), program.profiler(ctx.device) as prof:
        harness.run_window(unit, min(ctx.seconds, ctx.cell["trace_seconds"]), sync,
                           traced=True, after=after)
    return harness.trace_from_profiler(
        prof, {"pool_iterations": calls.iterations, "intersect_bound_ms": bound[0]})


def run(ctx) -> harness.Outcome:
    from pathtracer_tpu_torch.render import render_stats

    scene, camera, settings = program.load(ctx)
    sync = program.sync(ctx.device)
    render_stats(scene, camera, settings)  # warm-up: builds and loads the kernels
    sync()
    st = ctx.settings()
    done = []

    def unit(i):
        done.append(render_stats(scene, camera, program.with_seed(settings, ctx.seed + 1 + i)))

    metrics = {"setup_s": time.perf_counter() - ctx.t0}
    trace = None
    if ctx.trace:
        trace = traced_window(ctx, unit, sync)
    else:
        window = harness.run_window(unit, ctx.seconds, sync)
        paths = st["width"] * st["height"] * st["samples_per_pixel"] * len(done)
        metrics["paths_per_s"] = harness.rate(paths, window.seconds)
    peak = program.peak_bytes(ctx.device)

    k = random.Random(ctx.seed).randrange(len(done))
    img, rays = done[k][0].detach().cpu(), int(done[k][1])
    attempted = len(done)
    del done, scene
    ref_img, ref_rays = checks.reference_render(ctx, ctx.seed + 1 + k)
    out = [checks.checked("rays_gap", checks.rays_gap(rays, ref_rays), ctx.cell),
           checks.checked("image_rel_rms", checks.image_rel_rms(img, ref_img), ctx.cell)]
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, checks=out,
                           memory_peak_bytes=peak, trace=trace)
