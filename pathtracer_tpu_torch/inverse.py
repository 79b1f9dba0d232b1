"""Inverse rendering: the differentiable loss and the training step.

Port of ``pathtracer_tpu/inverse.py``. Pixel gradients with respect to the
material arrays (albedo Kd, emission Ke, specular Ks, Phong exponent Ns) by
**path-replay backpropagation**: with a material tensor requiring grad, the
integrator runs each bounce under ``torch.utils.checkpoint``
(ops.integrator), so the backward pass replays each bounce from its inputs,
drawing the same decisions again from the counter-based RNG instead of
storing them. The forward pass and the replay trace their rays through the
same intersection kernels as a render does. The kernels have no backward and
need none: the gradients reach the materials through gathers by material id
(``ops.intersect.material_lookup``, ``ops.lights``). On a card, for the
settings ``ops.path_replay.covers``, each wave is ``path_replay.RadianceWave``
instead: the bounce and its replay as CUDA kernels, with the same radiance.

Discrete path structure (hit ids, RR survival, lobe choices, sampled
directions) receives no gradient, as in any path-replay estimator; gradients
flow through the BSDF and emission *values* along the fixed paths.

Where torch's rules differ from JAX's on the differentiated path, the port
follows JAX's: the per-sample clamp at zero and the tonemap's bounds pass
half the gradient at an exact tie (``ops.tonemap.maximum`` and ``clip``), as
``jnp.maximum`` and ``jnp.clip`` do; ``torch.clamp`` would pass all of it.

The optimizer is a ``torch.optim`` one (optax is absent on the card): by
default Adam with ``cosine_decay_schedule``, optax's cosine decay. With a
mesh (``parallel.mesh``) the step is data-parallel: each shard differentiates
its slice of the rows, and the gradients sum once over shards and processes.

On a CUDA device the unsharded step replays ``loss_and_grads`` as one CUDA
graph: a step is tens of thousands of small kernels, whose launches one by
one cost the host more than the card takes to run them. The first step of
each capture key (``make_train_step``) runs eagerly, the second captures the
graph, and every later one copies its rows and sample ids into the graph's
inputs and replays it; the optimizer and the clip run eagerly after it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os

import torch

from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import radiance_batch
from pathtracer_tpu_torch.ops.tonemap import maximum, tonemap_reference
from pathtracer_tpu_torch.parallel.distributed import sync_global_devices
from pathtracer_tpu_torch.parallel.mesh import all_reduce, replicas, shard_rows
from pathtracer_tpu_torch.utils.profiling import span

# Differentiable material arrays. ``mat_Ns`` (Phong roughness exponent) is
# optimizable too; fit it with ``compat_count_light_pdf=False`` (or the
# Beckmann lobe), since the compat NEE keys the glossy lobe on Ns == 40.0
# exactly, which makes the loss discontinuous in Ns; the corrected estimator
# keys on Ks > 0 and is smooth in Ns.
PARAM_FIELDS = ("mat_Kd", "mat_Ke", "mat_Ks", "mat_Ns")

# The physical range each field is projected onto after an update: albedo and
# specular in [0, 1], emission >= 0, Phong exponent in [1, 499] (the mirror
# lane gates on Ns > 500; crossing it would flip the lobe discontinuously).
CLIPS = {
    "mat_Kd": (0.0, 1.0),
    "mat_Ks": (0.0, 1.0),
    "mat_Ke": (0.0, None),
    "mat_Ns": (1.0, 499.0),
}


def material_params(scene, fields=PARAM_FIELDS) -> dict:
    """The differentiable material arrays of a Scene, by field name.

    ``fields`` restricts which arrays are optimized (e.g. ``("mat_Kd",)`` to
    fit albedo with known emission); unlisted fields stay frozen at the
    scene's values.
    """
    return {f: getattr(scene, f) for f in fields}


def with_material_params(scene, params: dict):
    """Scene with its material arrays replaced by ``params``. The scene's
    ``cache`` dict is shared: the intersectors' tables hold geometry only."""
    return dataclasses.replace(scene, **params)


def _render_rows(params, scene, settings, frame, pixel_ids, sample_ids):
    """Radiance for a pixel subset [b] under the given material params."""
    scene = with_material_params(scene, params)
    jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    return maximum(radiance_batch(scene, settings, o, d, pixel_ids, sample_ids), 0.0)


def pixel_loss(params, scene, settings, frame, target_rows, pixel_ids, sample_ids):
    """MSE between rendered radiance and target rows for a pixel subset."""
    rad = _render_rows(params, scene, settings, frame, pixel_ids, sample_ids)
    return torch.mean((rad - target_rows) ** 2)


def _paired_objective(
    params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
):
    """Surrogate whose gradient is an *unbiased* estimate of d MSE(E[X], t).

    A naive MSE on a Monte Carlo render is biased: E[(X - t)^2] =
    (E[X] - t)^2 + Var(X), so gradient descent trades brightness for lower
    path variance. Two independent sample waves with cross detaches fix it:

        d/dθ mean[ sg(X_a - t)·X_b + sg(X_b - t)·X_a ]
          = 2 (E[X] - t)·dE[X]  =  d/dθ (E[X] - t)^2,

    because X_a ⟂ X_b. With ids_a == ids_b this reduces exactly to the plain
    per-wave MSE gradient. Returns (surrogate, monitoring MSE of the 2-wave
    mean estimate).
    """
    rad_a = _render_rows(params, scene, settings, frame, pixel_ids, ids_a)
    rad_b = _render_rows(params, scene, settings, frame, pixel_ids, ids_b)
    resid_a = rad_a.detach() - target_rows
    resid_b = rad_b.detach() - target_rows
    surrogate = torch.mean(resid_a * rad_b + resid_b * rad_a)
    monitor = torch.mean((0.5 * (rad_a.detach() + rad_b.detach()) - target_rows) ** 2)
    return surrogate, monitor


def _display_loss(rows, target_rows):
    return torch.mean((tonemap_reference(rows) - target_rows) ** 2)


def _display_weight(rows, target_rows):
    """The gradient of the display loss at the detached ``rows``: the
    counterpart of ``jax.grad(display_loss)(stop_gradient(rows))``."""
    x = rows.detach().requires_grad_(True)
    with torch.enable_grad():
        (w,) = torch.autograd.grad(_display_loss(x, target_rows), x)
    return w


def _paired_objective_tonemapped(
    params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
):
    """Paired surrogate for a loss in *display* space: MSE(f(E[X]), t) with
    f = the reference tonemap (ops.tonemap.tonemap_reference).

    Fitting against a real PNG (8-bit display-space files) puts the loss
    behind the tonemap. Chain rule: dL/dθ = w · dE[X]/dθ with w = 2 (f(m) - t)
    f'(m) at m = E[X]. The weight is estimated from one wave (detached) and
    the unbiased dE[X] factor from the *other*, symmetrized: the same
    decoupling as ``_paired_objective``.

    Residual bias: the weight uses f at a one-wave estimate of m, so f's
    curvature leaks a Jensen-gap term of order Var(X)·f''. The reference
    tonemap is nearly linear (a ``lum_o**0.01`` scale), so this is
    second-order small; it vanishes as spp grows.
    """
    rad_a = _render_rows(params, scene, settings, frame, pixel_ids, ids_a)
    rad_b = _render_rows(params, scene, settings, frame, pixel_ids, ids_b)
    w_a = _display_weight(rad_a, target_rows)
    w_b = _display_weight(rad_b, target_rows)
    surrogate = 0.5 * torch.sum(w_a * rad_b + w_b * rad_a)
    monitor = _display_loss(0.5 * (rad_a.detach() + rad_b.detach()), target_rows)
    return surrogate, monitor


_OBJECTIVES = {
    "radiance": _paired_objective,
    "display": _paired_objective_tonemapped,
}


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax's ``cosine_decay_schedule(init_value, decay_steps)``: step t ->
    ``init_value * 0.5 * (1 + cos(pi * min(t, decay_steps) / decay_steps))``,
    the full value at step 0."""

    def schedule(t: int) -> float:
        return init_value * 0.5 * (1.0 + math.cos(math.pi * min(t, decay_steps) / decay_steps))

    return schedule


def project_params(params: dict) -> None:
    """Clip each field of ``params`` in place onto its range in ``CLIPS``.

    This bounds the Adam random walk on parameters with weak pixel coverage
    (Adam rescales even noise-dominated gradients to full lr-sized steps).
    """
    with torch.no_grad():
        for k, v in params.items():
            if k in CLIPS:
                lo, hi = CLIPS[k]
                v.clamp_(min=lo, max=hi)


def loss_and_grads(params, scene, settings, frame, target_rows, pixel_ids, ids_a,
                   ids_b, loss_space: str = "radiance"):
    """One paired step's (monitoring loss, gradients by field): the
    objective of ``loss_space`` ("radiance" or "display") on two waves,
    differentiated with respect to ``params`` (tensors requiring grad) by
    path replay. A field the paths never reach gets a zero gradient."""
    surrogate, loss = _OBJECTIVES[loss_space](
        params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
    )
    grads = torch.autograd.grad(surrogate, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def _sharded_loss_and_grads(params, scene, settings, frame, target_rows, pixel_ids,
                            ids_a, ids_b, loss_space, mesh):
    """``loss_and_grads`` over the mesh's shards: the mean of the shard
    losses and of the shard gradients, on the params' devices."""
    slices = [shard_rows(x, mesh) for x in (target_rows, pixel_ids, ids_a, ids_b)]
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    loss = torch.zeros((), device=next(iter(grads.values())).device)
    for i, (sc, fr) in enumerate(replicas(scene, frame, mesh)):
        dev = sc.device
        local = {k: p.detach().to(dev).requires_grad_(True) for k, p in params.items()}
        rows = [x[i].to(dev) for x in slices]
        shard_loss, shard_grads = loss_and_grads(local, sc, settings, fr, *rows, loss_space)
        loss += shard_loss.to(loss.device)
        for k, g in shard_grads.items():
            grads[k] += g.to(grads[k].device)
    loss = all_reduce(loss, mesh) / mesh.size
    return loss, {k: all_reduce(g, mesh) / mesh.size for k, g in grads.items()}


def _key_part(v):
    """A value's part of a capture key: a tensor by address and layout, a
    dict (the scene's cache) by identity, anything else by value."""
    if isinstance(v, torch.Tensor):
        return (v.data_ptr(), tuple(v.shape), v.dtype, v.device)
    return id(v) if isinstance(v, dict) else v


def _capture_key(params, scene, frame, inputs) -> tuple:
    """What a captured step reads by address (the params, the scene's
    fields and tables, the frame) and the layout of what it copies in (the
    rows and ids): a step whose key differs cannot replay the graph."""
    return (
        tuple((k, id(p), p.requires_grad, _key_part(p)) for k, p in params.items()),
        tuple(_key_part(getattr(scene, f.name)) for f in dataclasses.fields(scene)
              if f.name not in params),
        tuple((k, _key_part(v)) for k, v in frame.items()),
        tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
    )


class _GraphedLossAndGrads:
    """``loss_and_grads`` of one training step, replayed from a CUDA graph.

    One graph at a time, for the capture key it was recorded under. A step
    with a new key frees the graph and runs eagerly on a side stream (as
    torch's CUDA graphs want before a capture; it also fills ``scene.cache``
    and builds the kernels); the next step with that key captures. The graph
    keeps the objects it reads by address alive (``held``)."""

    def __init__(self, settings, loss_space):
        self.settings, self.loss_space = settings, loss_space
        self.key = self.held = self.graph = self.inputs = self.loss = self.grads = None

    def _drop(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.inputs = self.loss = self.grads = None

    def __call__(self, params, scene, frame, inputs):
        key = _capture_key(params, scene, frame, inputs)
        if key != self.key:
            self._drop()
            self.key, self.held = key, (dict(params), scene, dict(frame))
            return self._eager(params, scene, frame, inputs)
        if self.graph is None:
            self._capture(params, scene, frame, inputs)
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        with span("pt.graph_replay"):
            self.graph.replay()
        # Fresh tensors: the next replay overwrites the graph's outputs.
        return self.loss.clone(), {k: g.clone() for k, g in self.grads.items()}

    def _eager(self, params, scene, frame, inputs):
        main = torch.cuda.current_stream(inputs[0].device)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            loss, grads = loss_and_grads(params, scene, self.settings, frame, *inputs,
                                         self.loss_space)
        main.wait_stream(side)
        for t in (loss, *grads.values()):
            t.record_stream(main)
        return loss, grads

    def _capture(self, params, scene, frame, inputs):
        self.inputs = [x.clone() for x in inputs]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.loss, self.grads = loss_and_grads(params, scene, self.settings, frame,
                                                   *self.inputs, self.loss_space)
        self.graph = graph


def make_train_step(settings, optimizer, mesh=None, loss_space="radiance"):
    """A training step over material params.

    ``optimizer`` is a ``torch.optim.Optimizer`` over the tensors of the
    ``params`` dict the step is called with (leaf tensors requiring grad);
    it holds its own state. The returned ``train_step(params, scene, frame,
    target_rows, pixel_ids, sample_ids_a, sample_ids_b)`` computes the paired
    gradient from two independent waves (``loss_and_grads``; pass the same
    ids twice for the plain biased-MSE gradient), takes one optimizer step,
    projects the params onto ``CLIPS`` in place and returns the monitoring
    loss (a detached 0-dim tensor). ``loss_space``: "radiance" fits
    pre-tonemap radiance; "display" fits through the reference tonemap
    against display-space targets (real PNGs).

    With ``mesh`` (``parallel.mesh.Mesh``) the step is data-parallel: the
    rows split into ``mesh.size`` equal slices (a row count that does not
    divide raises ``ValueError``), each shard computes ``loss_and_grads`` on
    its slice with a copy of the params on its device, the shard gradients
    sum once (over this process's shards, then ``all_reduce`` over the
    processes) and divide by ``mesh.size``, as the loss does: the mean of the
    shard means. The update then runs once on the params, which every
    process holds alike.

    Without a mesh, on a CUDA device, ``loss_and_grads`` runs as one CUDA
    graph (module docstring): the step's first call with a new capture key
    (the params' and the scene's tensors by identity and address, the
    frame's, the inputs' shapes, dtypes and device) runs eagerly, the second
    captures, later ones replay. The params change in place between steps
    and the graph reads them there; the rows and sample ids are copied in on
    every call. Each call returns a loss tensor of its own.
    """
    if loss_space not in _OBJECTIVES:
        raise ValueError(f"unknown loss_space {loss_space!r}")
    graphed = _GraphedLossAndGrads(settings, loss_space)

    def train_step(params, scene, frame, target_rows, pixel_ids, sample_ids_a,
                   sample_ids_b):
        inputs = (target_rows, pixel_ids, sample_ids_a, sample_ids_b)
        with span("pt.train_step"):
            if mesh is None and next(iter(params.values())).is_cuda:
                loss, grads = graphed(params, scene, frame, inputs)
            else:
                args = (params, scene, settings, frame, *inputs, loss_space)
                loss, grads = (loss_and_grads(*args) if mesh is None
                               else _sharded_loss_and_grads(*args, mesh=mesh))
            for k, p in params.items():
                p.grad = grads[k]
            optimizer.step()
            project_params(params)
        return loss

    return train_step


def _state_like(optimizer):
    """The structure of ``optimizer.state_dict()["state"]`` once it has
    stepped (torch optimizers create their state at the first step), from
    one step of a copy with zero gradients."""
    probe = copy.deepcopy(optimizer)
    for group in probe.param_groups:
        for p in group["params"]:
            p.grad = torch.zeros_like(p)
    probe.step()
    return probe.state_dict()["state"]


def recover_materials(
    scene,
    camera,
    settings,
    target_image,
    steps: int = 100,
    learning_rate: float = 5e-2,
    init_params: dict | None = None,
    mesh=None,
    callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    fields=PARAM_FIELDS,
    stop_after: int | None = None,
    loss_space: str = "radiance",
    samples_per_step: int = 1,
    optimizer=None,
):
    """Gradient-descent recovery of material arrays from a target render.

    ``target_image``: [H, W, 3] mean radiance (pre-tonemap), or, with
    ``loss_space="display"``, a display-space [0, 1] image (e.g. a decoded
    ground-truth PNG) fit through the reference tonemap. Returns (recovered
    params, detached tensors on the scene's device, list of losses).
    BASELINE.json config 5. ``mesh``: each step runs data-parallel over it
    (``make_train_step``); the pixel count times ``samples_per_step`` must
    divide by ``mesh.size``.

    ``checkpoint_path``: persist (params, optimizer state, step) every
    ``checkpoint_every`` steps via ``utils.checkpoint.save_pytree`` and
    resume from it when present. Sample ids derive from the step index and
    the learning rate from the step's place in the schedule, so a resumed
    run repeats the straight run's arithmetic. Over a mesh of several
    processes, whose params are the same after every step, process 0 writes
    the file and the others wait for it.

    ``samples_per_step``: paths per pixel per wave per step. Adam normalizes
    even noise-dominated gradients to full lr-sized steps, so a parameter
    whose signal is far below the 1-sample gradient noise (e.g. the Phong
    exponent's highlight-shape signal) drifts at ~lr * SNR per step; raising
    this multiplies the SNR by sqrt(samples_per_step).

    ``optimizer``: a callable from a list of parameter tensors to a
    ``torch.optim.Optimizer``, replacing the default Adam with the cosine
    decay of ``learning_rate`` over ``steps`` (the override keeps its own
    learning rate). The default follows the *normalized* gradient, whose
    drift direction is the gradient's median-ish sign, wrong for
    heavy-tailed Monte Carlo gradients; for such parameters pass Adam with a
    long first-moment window, ``lambda ps: torch.optim.Adam(ps, lr,
    betas=(0.98, 0.999))``, which tracks the gradient *mean* across steps.
    """
    from pathtracer_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    dev = scene.device
    init = init_params or material_params(scene, fields)
    params = {
        k: torch.as_tensor(v, dtype=torch.float32, device=dev).detach().clone()
        .requires_grad_(True)
        for k, v in init.items()
    }
    # Adam moves each parameter ~lr per step regardless of scale, so the peak
    # lr must cover the largest parameter excursion (emission is O(10));
    # cosine decay then polishes the O(1) albedos.
    schedule = None
    if optimizer is None:
        schedule = cosine_decay_schedule(learning_rate, max(steps, 1))
        opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    else:
        opt = optimizer(list(params.values()))
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = load_pytree(
            checkpoint_path, {"params": params, "opt": _state_like(opt), "step": 0}
        )
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(state["params"][k])
        opt.load_state_dict(
            {"state": state["opt"], "param_groups": opt.state_dict()["param_groups"]}
        )
        start = state["step"]
    train_step = make_train_step(settings, opt, mesh=mesh, loss_space=loss_space)

    frame = ray_frame_tensors(camera, settings.width, settings.height, dev)
    n_pixels = settings.width * settings.height
    k = max(1, samples_per_step)
    pixel_ids = torch.arange(n_pixels, dtype=torch.int64, device=dev).repeat(k)
    target_rows = torch.as_tensor(target_image, dtype=torch.float32, device=dev)
    target_rows = target_rows.reshape(n_pixels, 3).repeat(k, 1)
    sub = torch.arange(k, dtype=torch.int64, device=dev).repeat_interleave(n_pixels)

    # ``stop_after`` bounds this run's steps while keeping the lr schedule on
    # the full ``steps`` horizon: a later resumed run then repeats a straight
    # run's steps.
    end = steps if stop_after is None else min(steps, start + stop_after)
    losses = []
    for step_idx in range(start, end):
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = schedule(step_idx)
        # Two fresh independent waves per step (see _paired_objective); each
        # wave draws k samples per pixel from disjoint id ranges.
        ids_a = 2 * step_idx * k + sub
        ids_b = (2 * step_idx + 1) * k + sub
        loss = train_step(params, scene, frame, target_rows, pixel_ids, ids_a, ids_b)
        losses.append(float(loss))
        if callback is not None:
            callback(step_idx, losses[-1], params)
        if checkpoint_path and (
            (step_idx + 1) % checkpoint_every == 0 or step_idx + 1 == end
        ):
            if mesh is None or mesh.rank == 0:
                save_pytree(
                    checkpoint_path,
                    {"params": params, "opt": opt.state_dict()["state"], "step": step_idx + 1},
                )
            if mesh is not None:
                sync_global_devices("checkpoint")
    return {k: v.detach() for k, v in params.items()}, losses


def downsample_display(img, factor: int):
    """Box-average a display-space [H, W, 3] image by ``factor``.

    Matching resolutions this way (fit at H/f x W/f against the averaged
    PNG) is the standard trick for cheap fits against a full-res target; the
    tonemap and the box filter do not exactly commute, but the reference
    tonemap is nearly linear so the gap is far below the cross-renderer noise
    floor.
    """
    h, w, c = img.shape
    return img.reshape(h // factor, factor, w // factor, factor, c).mean(axis=(1, 3))


def recover_from_ground_truth(
    ini_path: str,
    target_png: str,
    fit_size: int = 64,
    steps: int = 120,
    learning_rate: float = 5e-2,
    fields=("mat_Kd",),
    perturb: float = 0.5,
    samples_per_pixel: int = 8,
    max_depth: int = 9,
    scene_override=None,
    device="cuda",
):
    """BASELINE.json config 5: recover CornellBox materials from a
    ground-truth PNG (display space).

    Loads the scene from ``ini_path`` onto ``device``, perturbs the chosen
    material fields by ``perturb``, and fits them against the decoded
    ``target_png`` through the reference tonemap at ``fit_size`` (the PNG is
    box-averaged down to match). Returns (true scene, perturbed scene,
    recovered params, losses).
    """
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.utils.image import read_png

    scene, camera, settings, _ = load_scene(
        ini_path,
        device=device,
        width=fit_size,
        height=fit_size,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        scheduler="scan",
    )
    if scene_override is not None:
        scene = scene_override(scene)
    target = read_png(target_png)
    target = downsample_display(target, target.shape[0] // fit_size)

    pert = with_material_params(scene, {f: getattr(scene, f) * perturb for f in fields})
    params, losses = recover_materials(
        pert, camera, settings, target,
        steps=steps, learning_rate=learning_rate, fields=fields,
        loss_space="display",
    )
    return scene, pert, params, losses
