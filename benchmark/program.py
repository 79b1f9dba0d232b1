"""The benchmark's side of the program under test: loading a configuration's
scene through the port's frontend, and, in a traced run, the harness's own
ranges and counts around the port's calls.

The scene is written as the files users hand the port (INI, XML, OBJ, MTL)
and loaded by ``models.scene.load_scene``. In a traced run
``pathtracer_tpu_torch.ops.integrator``'s bindings of ``closest_hit`` and
``occluded_before`` are wrapped in a ``bench.intersect`` profiler range that
keeps each call's inputs and answer, and ``ops.wavefront.render_pool`` in one
that counts the pool's iterations. The wrappers are undone when the traced
window ends; an untraced run wraps nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmark import scenes

# RenderSettings fields a configuration or cell may set beyond the INI's.
_SETTING_KEYS = ("max_depth", "intersector", "compat_count_light_pdf",
                 "compat_fixed_eta", "compat_sticky_specular", "scheduler", "ray_sort",
                 "spawn_chunk", "batch_size")


def load(ctx, mesh=None, **overrides):
    """(scene, camera, RenderSettings) of the context's configuration, loaded
    by the port from files written into the run's work directory. ``mesh``
    replaces the configuration's (the fit's perturbed start)."""
    from pathtracer_tpu_torch.models.scene import load_scene

    st = ctx.settings()
    cfg_mesh, camera = scenes.load(ctx.config)
    ini = scenes.write_scene_files(ctx.workdir, ctx.cell["config"], mesh or cfg_mesh,
                                   camera, st)
    kw = {k: st[k] for k in _SETTING_KEYS if k in st}
    kw.update({k: ctx.cell[k] for k in _SETTING_KEYS if k in ctx.cell})
    kw.update(overrides)
    scene, camera, settings, _ = load_scene(ini, device=ctx.device, seed=ctx.seed, **kw)
    return scene, camera, settings


def with_seed(settings, seed: int):
    return dataclasses.replace(settings, seed=seed)


def sync(device: str):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def peak_bytes(device: str) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


@dataclasses.dataclass
class Calls:
    """The traced window's intersection calls and pool iterations."""

    closest: list = dataclasses.field(default_factory=list)  # (o, d, t)
    occluded: list = dataclasses.field(default_factory=list)  # (o, d, t_cut, occ)
    iterations: int = 0


@contextlib.contextmanager
def wrapped(calls: Calls):
    """Wrap the integrator's intersection entries and the pool for a traced
    window; restore them on exit."""
    from torch.profiler import record_function

    from pathtracer_tpu_torch.ops import integrator, wavefront

    orig = (integrator.closest_hit, integrator.occluded_before, wavefront.render_pool)

    def closest_hit(scene, o, d, settings):
        with record_function("bench.intersect"):
            hit, mat = orig[0](scene, o, d, settings)
        calls.closest.append((o.detach(), d.detach(), hit.t.detach()))
        return hit, mat

    def occluded_before(scene, o, d, t_max, settings, rel_eps: float = 1e-3):
        with record_function("bench.intersect"):
            occ, hit_any = orig[1](scene, o, d, t_max, settings, rel_eps)
        calls.occluded.append((o.detach(), d.detach(), (t_max * (1.0 - rel_eps)).detach(),
                               occ.detach()))
        return occ, hit_any

    def render_pool(*args, **kwargs):
        out = orig[2](*args, **kwargs)
        calls.iterations += int(out[2])
        return out

    integrator.closest_hit, integrator.occluded_before = closest_hit, occluded_before
    wavefront.render_pool = render_pool
    try:
        yield calls
    finally:
        integrator.closest_hit, integrator.occluded_before, wavefront.render_pool = orig


def profiler(device: str):
    """``torch.profiler`` over host ops and, on a card, its kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)

