"""Inverse rendering (BASELINE configuration 5): the window runs the port's
``inverse.make_train_step`` back to back, one synchronized step per unit.

Set-up writes the scene with its materials perturbed from the seed (the
start), renders the target from the true materials with the plain
reference (its seconds are not set-up's: ``setup_s`` leaves them out),
builds one training step (Adam over the material fields, the paired
objective in the cell's loss space, every pixel, two one-sample waves a
step) and drives it through its first ``check_steps`` steps; the window
continues that same step. Step i draws samples 2i and 2i + 1, so every
step's rows differ. ``train_steps_per_s`` is the window's steps over its
wall time.

After the window the reference checks two things. The start: it follows the
first steps from the same start and target, and each step's loss, the first
gradient as Adam holds it after one step, and the parameters' change over
those steps are compared, leaf by leaf. The window: one step drawn from the
seed among the window's, from the state Adam held before it (kept in the
window: the parameters and moments, a few hundred bytes a step, its rows
matched to the reference's materials by their values at the start), is
taken again by the reference, and its loss, its gradient (worked out from
Adam's moments before and after it) and the parameters' change are
compared."""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from benchmark import checks, harness, program, scenes
from benchmark.reference import fit as ref_fit
from benchmark.reference import pack, tracer


def start_mesh(ctx):
    """(true mesh, start mesh, camera): each material's Kd and Ke scaled by
    factors drawn from the seed in the cell's ``perturb`` range, Kd clipped
    to [0, 1]."""
    mesh, camera = scenes.load(ctx.config)
    rng = np.random.default_rng(ctx.seed)
    lo, hi = ctx.cell["perturb"]
    mats = []
    for m in mesh.materials:
        kd = np.clip(np.asarray(m["Kd"]) * rng.uniform(lo, hi, 3), 0.0, 1.0)
        ke = np.asarray(m["Ke"]) * rng.uniform(lo, hi, 3)
        mats.append(dict(m, Kd=tuple(map(float, kd)), Ke=tuple(map(float, ke))))
    start = scenes.Mesh(mesh.positions, mesh.faces, mesh.face_material, mats)
    return mesh, start, camera


def target(ctx, mesh, camera):
    """The target rows [H*W, 3]: the reference's render of the true scene,
    on a stream of its own (the seed plus one)."""
    st = checks.reference_settings(ctx, ctx.seed + 1)
    st["samples_per_pixel"] = ctx.cell["target_spp"]
    sc = pack.pack(mesh, ctx.device)
    frame = tracer.ray_frame(camera, st["width"], st["height"], ctx.device, torch.float32)
    with torch.no_grad():
        img, _ = tracer.render(sc, st, frame)
    return img.reshape(-1, 3)


def adam_state(opt, params: dict) -> dict:
    """Copies of what Adam holds for ``params`` before its next step: the
    parameters, the moments ``m`` and ``v``, and ``t`` steps taken (an
    optimizer that never stepped holds none: zeros)."""
    out = {"params": {}, "m": {}, "v": {}, "t": 0}
    for k, p in params.items():
        s = opt.state.get(p, {})
        out["params"][k] = p.detach().clone()
        out["m"][k] = s["exp_avg"].detach().clone() if s else torch.zeros_like(p.detach())
        out["v"][k] = s["exp_avg_sq"].detach().clone() if s else torch.zeros_like(p.detach())
        out["t"] = int(s["step"]) if s else 0
    return out


def step_grads(before: dict, after: dict, beta1: float) -> dict:
    """The gradient a step handed Adam: (m after - beta1 m before) / (1 - beta1)."""
    return {k: (after["m"][k] - beta1 * before["m"][k]) / (1.0 - beta1) for k in after["m"]}


def run(ctx) -> harness.Outcome:
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

    sync = program.sync(ctx.device)
    true_mesh, start, camera = start_mesh(ctx)
    t_target = time.perf_counter()
    target_rows = target(ctx, true_mesh, camera)
    sync()
    t_target = time.perf_counter() - t_target  # the reference's seconds, not set-up's
    print(f"[bench] target: {t_target:.4f} s of the reference, left out of setup_s",
          file=sys.stderr)
    scene, camera_p, settings = program.load(ctx, mesh=start)
    fields = tuple(ctx.cell["fields"])
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(scene, fields).items()}
    lr = ctx.cell["learning_rate"]
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    beta1 = opt.defaults["betas"][0]
    step = inverse.make_train_step(settings, opt, loss_space=ctx.cell["loss_space"])
    frame = ray_frame_tensors(camera_p, settings.width, settings.height, scene.device)
    n = settings.width * settings.height
    pixel = torch.arange(n, dtype=torch.int64, device=scene.device)
    losses = []

    def unit(i):
        ids_a = torch.full_like(pixel, 2 * i)
        ids_b = torch.full_like(pixel, 2 * i + 1)
        losses.append(step(params, scene, frame, target_rows, pixel, ids_a, ids_b))

    n_check = ctx.cell["check_steps"]
    s0 = adam_state(opt, params)
    for i in range(n_check):  # the first steps: warm-up, and the start's check
        unit(i)
        sync()
        if i == 0:
            first = step_grads(s0, adam_state(opt, params), beta1)
    p_after = {k: v.detach().clone() for k, v in params.items()}
    checked_losses = [float(x) for x in losses]

    states = []  # Adam's state before each window step, then after the last

    def steps(i):
        states.append(adam_state(opt, params))
        unit(n_check + i)

    metrics = {"setup_s": time.perf_counter() - ctx.t0 - t_target}
    trace = None
    if ctx.trace:
        with program.profiler(ctx.device) as prof:
            harness.run_window(steps, min(ctx.seconds, ctx.cell["trace_seconds"]), sync,
                               traced=True)
        trace = harness.trace_from_profiler(prof, {})
    else:
        window = harness.run_window(steps, ctx.seconds, sync)
        metrics["train_steps_per_s"] = harness.rate(len(window.units), window.seconds)
    peak = program.peak_bytes(ctx.device)
    states.append(adam_state(opt, params))
    attempted = len(states) - 1
    j = random.Random(ctx.seed).randrange(attempted)  # the window step checked
    before, after = states[j], states[j + 1]
    window_loss = float(losses[n_check + j])
    del params, opt, step, scene, losses, states

    ref_scene = pack.pack(start, ctx.device)
    st = checks.reference_settings(ctx, ctx.seed)
    rframe = tracer.ray_frame(camera, st["width"], st["height"], ctx.device, torch.float32)
    start_params = {k: ref_scene[k] for k in fields}
    r_losses, r_first, r_state = ref_fit.follow(ref_scene, st, rframe, start_params, target_rows,
                                                n_check, lr)
    counted = checks.counted_leaves(r_first)
    change = {k: p_after[k] - s0["params"][k] for k in fields}
    r_change = {k: r_state["params"][k] - start_params[k] for k in fields}
    rows = checks.row_map(s0["params"], start_params).to(ctx.device)
    w_state = {part: {f: before[part][f][rows] for f in fields} for part in ("params", "m", "v")}
    w_state["t"] = before["t"]
    w_loss, w_grads, w_after = ref_fit.step_from(ref_scene, st, rframe, w_state, target_rows,
                                                 n_check + j, lr)
    w_counted = checks.counted_leaves(w_grads)
    w_change = {f: after["params"][f] - before["params"][f] for f in fields}
    w_r_change = {f: w_after[f] - w_state["params"][f] for f in fields}
    out = [checks.checked("loss_gap", checks.loss_gap(checked_losses, r_losses), ctx.cell),
           checks.checked("grad_gap", checks.leaf_gap(first, r_first, counted), ctx.cell),
           checks.checked("change_gap", checks.leaf_gap(change, r_change, counted), ctx.cell),
           checks.checked("window_loss_gap", checks.loss_gap([window_loss], [w_loss]), ctx.cell),
           checks.checked("window_grad_gap",
                          checks.leaf_gap(step_grads(before, after, beta1), w_grads, w_counted),
                          ctx.cell),
           checks.checked("window_change_gap", checks.leaf_gap(w_change, w_r_change, w_counted),
                          ctx.cell)]
    return harness.Outcome(metrics=metrics, attempted=attempted, failed=0, checks=out,
                           memory_peak_bytes=peak, trace=trace)
