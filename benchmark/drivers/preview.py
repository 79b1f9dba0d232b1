"""Progressive preview, the reference's own frame loop: the window runs
``render.render_stats`` with the cell's scheduler and ``preview_every=1``,
and a ``preview_fn`` that copies the running mean to the host, as the
preview server needs it. Renders run back to back, each with its own seed.
A frame runs from the previous frame's delivery to the moment this one's
mean is on the host; the last frame of a render is its result, copied to
the host. ``frame_p95_ms`` is the 95th percentile over every frame of the
window. A traced run profiles the first ``trace_frames`` whole frames of its
first render, each frame one unit. After the window one render drawn from
the seed is rendered again by the plain reference: its rays, its image and
its frame ``k`` (drawn from the seed) are compared."""

from __future__ import annotations

import random
import time

from benchmark import checks, harness, program


def run(ctx) -> harness.Outcome:
    from torch.profiler import record_function

    from pathtracer_tpu_torch.render import render_stats

    scene, camera, settings = program.load(ctx)
    sync = program.sync(ctx.device)
    spp = ctx.settings()["samples_per_pixel"]
    pick = random.Random(ctx.seed)
    frame_k = pick.randrange(1, spp)  # a progressive frame, not the last
    frames_ms: list = []
    renders: list = []
    last = [0.0]
    traced = {"left": 0, "range": None, "prof": None}

    def deliver(done, mean):
        host = mean.cpu()
        now = time.perf_counter()
        frames_ms.append(1e3 * (now - last[0]))
        last[0] = now
        if done == frame_k:
            renders[-1]["frame"] = host
        if traced["range"] is not None:  # the traced run: one range a frame
            traced["range"].__exit__(None, None, None)
            traced["range"] = None
            traced["left"] -= 1
            if traced["left"]:
                traced["range"] = record_function(harness.UNIT)
                traced["range"].__enter__()
            else:
                traced["prof"].stop()

    def unit(i):
        renders.append({})
        img, rays = render_stats(scene, camera, program.with_seed(settings, ctx.seed + 1 + i),
                                 preview_every=ctx.cell["preview_every"], preview_fn=deliver)
        renders[-1].update(image=img.cpu(), rays=rays)
        deliver(spp, img)

    last[0] = time.perf_counter()
    unit(-1)  # warm-up: builds and loads the kernels, warms every frame's shapes
    sync()
    renders.clear()
    frames_ms.clear()
    metrics = {"setup_s": time.perf_counter() - ctx.t0}
    trace = None
    if ctx.trace:
        traced["left"] = min(ctx.cell["trace_frames"], spp)
        traced["prof"] = prof = program.profiler(ctx.device)
        prof.start()
        traced["range"] = record_function(harness.UNIT)
        traced["range"].__enter__()
        last[0] = time.perf_counter()
        unit(0)
        trace = harness.trace_from_profiler(prof, {})
    else:
        last[0] = time.perf_counter()
        harness.run_window(unit, ctx.seconds, sync)
        metrics["frame_p95_ms"] = harness.p95(frames_ms)
    peak = program.peak_bytes(ctx.device)

    k = pick.randrange(len(renders))
    got = renders[k]
    attempted = len(frames_ms)
    del renders, scene
    ref_frame = {}

    def on_sample(done, mean):
        if done == frame_k:
            ref_frame["frame"] = mean.cpu()

    ref_img, ref_rays = checks.reference_render(ctx, ctx.seed + 1 + k, on_sample)
    out = [checks.checked("rays_gap", checks.rays_gap(int(got["rays"]), ref_rays),
                          ctx.cell),
           checks.checked("image_rel_rms", checks.image_rel_rms(got["image"], ref_img),
                          ctx.cell),
           checks.checked("frame_rel_rms", checks.image_rel_rms(got["frame"], ref_frame["frame"])
                          if "frame" in got else float("inf"), ctx.cell)]
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, checks=out,
                           memory_peak_bytes=peak, trace=trace)
