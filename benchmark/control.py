"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--out FILE]

Program readings: for each seed, one run of the cell with a window of one
unit (the driver's own set-up, timed path and check) prints the compared
numbers; with ``--fault NAME`` the run has that fault planted under its
timed path (``RENDER_FAULTS``, ``FIT_FAULTS``). Control readings: the
reference computed in bfloat16 (the nearest precision below the
configurations' float32) in the program's place, at the cell's own size,
against the float32 reference: it has to fail. All in one process; the
benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import checks, harness  # noqa: E402
from benchmark.reference import fit as ref_fit  # noqa: E402
from benchmark.reference import pack, tracer  # noqa: E402


# --- faults planted under the timed path: each has to make ``correct`` false ---
def _half_samples(render_stats):
    """Half of the batch left out: each render traces half its samples and
    returns their mean."""
    def broken(scene, camera, settings, *a, **kw):
        half = dataclasses.replace(settings,
                                   samples_per_pixel=max(1, settings.samples_per_pixel // 2))
        return render_stats(scene, camera, half, *a, **kw)
    return broken


def _altered_image(render_stats):
    """An answer altered where it is produced: one pixel of every image."""
    def broken(*a, **kw):
        img, rays = render_stats(*a, **kw)
        img = img.clone()
        img[img.shape[0] // 2, img.shape[1] // 2] *= 1.5
        return img, rays
    return broken


def _unchanged_state(make_train_step):
    """A step that returns its state unchanged: the loss is computed, the
    optimizer never steps."""
    def make(settings, optimizer, mesh=None, loss_space="radiance"):
        from pathtracer_tpu_torch import inverse

        def step(params, scene, frame, target_rows, pixel_ids, ids_a, ids_b):
            loss, _ = inverse.loss_and_grads(params, scene, settings, frame, target_rows,
                                             pixel_ids, ids_a, ids_b, loss_space)
            return loss
        return step
    return make


def _half_rows(make_train_step):
    """Half of the batch left out, the mean taken over the rest."""
    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def half(params, scene, frame, target_rows, pixel_ids, ids_a, ids_b):
            n = pixel_ids.shape[0] // 2
            return step(params, scene, frame, target_rows[:n], pixel_ids[:n], ids_a[:n],
                        ids_b[:n])
        return half
    return make


def _stale_samples(make_train_step, warm: int = 3):
    """Stale inputs after the warm-up, as a step captured once and replayed
    would have: every call after the ``warm``-th traces that call's sample
    ids again."""
    def make(*a, **kw):
        step = make_train_step(*a, **kw)
        calls = []

        def stale(params, scene, frame, target_rows, pixel_ids, ids_a, ids_b):
            calls.append((ids_a, ids_b))
            return step(params, scene, frame, target_rows, pixel_ids,
                        *calls[min(len(calls), warm) - 1])
        return stale
    return make


def _altered_loss(make_train_step):
    """An answer altered where it is produced: the step's loss."""
    def make(*a, **kw):
        step = make_train_step(*a, **kw)
        return lambda *args: step(*args) * 1.01
    return make


RENDER_FAULTS = {"half_samples": ("render", "render_stats", _half_samples),
                 "altered_image": ("render", "render_stats", _altered_image)}
FIT_FAULTS = {"unchanged_state": ("inverse", "make_train_step", _unchanged_state),
              "half_rows": ("inverse", "make_train_step", _half_rows),
              "altered_loss": ("inverse", "make_train_step", _altered_loss),
              "stale_samples": ("inverse", "make_train_step", _stale_samples)}


@contextlib.contextmanager
def planted(fault):
    """The program's entry ``fault`` names, broken by it, while in the block."""
    module, name, breaker = fault
    mod = importlib.import_module(f"pathtracer_tpu_torch.{module}")
    orig = getattr(mod, name)
    setattr(mod, name, breaker(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def control_render(ctx, seed: int, frame_k: int | None) -> list:
    frames = {}

    def grab(tag):
        def on_sample(done, mean):
            if done == frame_k:
                frames[tag] = mean.float().cpu()
        return on_sample

    low, low_rays = checks.reference_render(ctx, seed, grab("low"), dtype=torch.bfloat16)
    ref, ref_rays = checks.reference_render(ctx, seed, grab("ref"))
    out = [("rays_gap", checks.rays_gap(low_rays, ref_rays)),
           ("image_rel_rms", checks.image_rel_rms(low.float(), ref))]
    if frame_k is not None:
        out.append(("frame_rel_rms", checks.image_rel_rms(frames["low"], frames["ref"])))
    return out


def control_fit(ctx, seed: int) -> list:
    """The reference in bfloat16 against the reference in float32: the
    first steps from the start, then one more step from the float32
    reference's state after them (the window step's numbers)."""
    from benchmark.drivers import fit

    ctx.seed = seed
    true_mesh, start, camera = fit.start_mesh(ctx)
    target_rows = fit.target(ctx, true_mesh, camera)
    st = checks.reference_settings(ctx, seed)
    n_check, lr = ctx.cell["check_steps"], ctx.cell["learning_rate"]
    scenes, runs, state = {}, {}, None
    for dtype in (torch.bfloat16, torch.float32):
        sc = pack.pack(start, ctx.device, dtype)
        frame = tracer.ray_frame(camera, st["width"], st["height"], ctx.device, dtype)
        scenes[dtype] = (sc, frame)
        p0 = {k: sc[k] for k in ctx.cell["fields"]}
        losses, first, state = ref_fit.follow(sc, st, frame, p0, target_rows.to(dtype),
                                              n_check, lr)
        runs[dtype] = (losses, {k: v.float() for k, v in first.items()},
                       {k: (state["params"][k] - p0[k]).float() for k in p0})
    window = {}
    for dtype, (sc, frame) in scenes.items():
        cast = {part: {k: v.to(dtype) for k, v in state[part].items()}
                for part in ("params", "m", "v")}
        loss, grads, after = ref_fit.step_from(sc, st, frame, dict(cast, t=state["t"]),
                                               target_rows.to(dtype), n_check, lr)
        window[dtype] = (loss, {k: v.float() for k, v in grads.items()},
                         {k: (after[k] - cast["params"][k]).float() for k in after})
    (l_lo, g_lo, c_lo), (l_r, g_r, c_r) = runs[torch.bfloat16], runs[torch.float32]
    (wl_lo, wg_lo, wc_lo), (wl_r, wg_r, wc_r) = window[torch.bfloat16], window[torch.float32]
    counted = checks.counted_leaves(g_r)
    w_counted = checks.counted_leaves(wg_r)
    return [("loss_gap", checks.loss_gap(l_lo, l_r)),
            ("grad_gap", checks.leaf_gap(g_lo, g_r, counted)),
            ("change_gap", checks.leaf_gap(c_lo, c_r, counted)),
            ("window_loss_gap", checks.loss_gap([wl_lo], [wl_r])),
            ("window_grad_gap", checks.leaf_gap(wg_lo, wg_r, w_counted)),
            ("window_change_gap", checks.leaf_gap(wc_lo, wc_r, w_counted))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None,
                    help="plant this fault under the timed path of the program runs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.load_cell(args.workload, spec)

    def emit(kind, seed, readings):
        line = {"kind": kind, "seed": seed, **{n: v for n, v in readings}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    faults = {**RENDER_FAULTS, **FIT_FAULTS}
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as work, \
                (planted(faults[args.fault]) if args.fault else contextlib.nullcontext()):
            ctx = harness.Context(cell=cell, config=harness.load_config(cell["config"]),
                                  seed=seed, seconds=0.0, trace=False, device=args.device,
                                  t0=time.perf_counter(), workdir=work)
            out = harness.driver(cell["driver"]).run(ctx)
        emit(args.fault or "program", seed, [(n, v) for n, v, _ in out.checks])
    for seed in args.control_seeds:
        ctx = harness.Context(cell=cell, config=harness.load_config(cell["config"]), seed=seed,
                              seconds=0.0, trace=False, device=args.device,
                              t0=time.perf_counter(), workdir="")
        if cell["driver"] == "fit":
            readings = control_fit(ctx, seed)
        else:
            import random
            spp = ctx.settings()["samples_per_pixel"]
            k = random.Random(seed).randrange(1, spp) if cell["driver"] == "preview" else None
            readings = control_render(ctx, seed + 1, k)
        emit("control", seed, readings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
