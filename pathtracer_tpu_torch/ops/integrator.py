"""Wavefront path-tracing integrator.

Port of ``pathtracer_tpu/ops/integrator.py``: a flat SoA batch of rays
advances one masked bounce at a time. Per bounce, in the reference's order:

  1. closest-hit intersect
  2. emissive add at depth 0 / after specular, then terminate
  3. NEE: sample area light, shadow test, add contribution
  4. ``directLightingOnly`` break when the shadow ray hit
  5. Russian roulette
  6. BSDF select + sample: dielectric / mirror / glossy / diffuse

All randomness is counter-based on (pixel, sample, bounce) (ops.rng), so a
path's radiance does not depend on its lane or batch.

Path replay: when a scene tensor requires grad (inverse rendering,
``pathtracer_tpu_torch.inverse``), ``radiance_batch_stats`` runs each bounce
under ``torch.utils.checkpoint``, the counterpart of the JAX package's
``jax.checkpoint`` around its scan step. The forward pass keeps only each
bounce's inputs; the backward pass replays the bounce from them, and the
counter RNG draws the same decisions again. The replay traces its rays
through the same intersection kernels as the forward pass. A render whose
scene needs no gradient runs the bounces as they are. On CUDA, for the
settings ``ops.path_replay.covers``, a wave's bounces and their replay are
hand-written kernels instead (``path_replay.RadianceWave``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from pathtracer_tpu_torch.models.scene import TENSOR_FIELDS
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.bsdf import (
    dielectric_directions,
    eval_beckmann,
    eval_phong,
    eval_phong_bounce,
    reflect,
    sample_cosine_hemisphere,
)
from pathtracer_tpu_torch.ops.intersect import closest_hit, occluded_before, unit_axis
from pathtracer_tpu_torch.ops.lights import (
    sample_area_lights,
    sample_area_lights_detailed,
)
from pathtracer_tpu_torch.utils.profiling import span

PI = math.pi
NEE_OFFSET = 1.0e-4
RAY_OFFSET = 1.0e-3

# Dead lanes are re-aimed ("parked") at this far-outside origin pointing +x
# before intersection: a guaranteed miss with finite values.
_PARK_POS = 1.0e6


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def capturing(x) -> bool:
    """Whether the work on ``x``'s device is being captured into a CUDA
    graph: then nothing may wait for the card."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def _park_rays(o, d, live):
    dead = ~live[:, None]
    o = torch.where(dead, _PARK_POS, o)
    d = torch.where(dead, unit_axis(0, o), d)
    return o, d


def _nee(scene, settings, hit, mat, d, beta, u, active):
    """Next-event estimation; returns (contribution [B, 3], shadow_hit [B]).

    ``shadow_mode="fast"``: the light sample carries its own point, normal
    and Ke, so visibility is an occlusion test. ``"closest"``: a full closest
    hit on the shadow ray, whose hit attributes drive the contribution (the
    reference's exact semantics). Shading uses ``hit.normal_shade``; the NEE
    origin offset stays on the geometric normal.
    """
    n = hit.normal_shade
    offset_pt = hit.point + hit.normal * NEE_OFFSET

    contrib = torch.zeros_like(beta)
    shadow_any = torch.zeros(beta.shape[0], dtype=torch.bool, device=beta.device)
    for s in range(settings.num_direct_lighting_samples):
        # Extra light samples draw from purpose slots past STRIDE.
        i_choice = rng.LIGHT_CHOICE if s == 0 else rng.STRIDE + 3 * (s - 1)
        i_bary = rng.LIGHT_BARY if s == 0 else i_choice + 1
        uc, u1, u2 = u[:, i_choice], u[:, i_bary], u[:, i_bary + 1]

        if settings.shadow_mode == "fast":
            ldir, weight, l_pt, l_n, s_mat_ke, t_target = (
                sample_area_lights_detailed(
                    scene, offset_pt, uc, u1, u2,
                    settings.compat_count_light_pdf,
                )
            )
            s_o, s_d = _park_rays(offset_pt, ldir, active)
            occluded, s_hit_any = occluded_before(
                scene, s_o, s_d, torch.where(active, t_target, 0.0), settings
            )
            s_emissive = ~occluded & (torch.sum(s_mat_ke, dim=-1) > 0.0)
            diff = hit.point - l_pt
            d2 = _dot(diff, diff)
            cos_l = _dot(l_n, -ldir)
        elif settings.shadow_mode == "closest":
            ldir, weight = sample_area_lights(
                scene, offset_pt, uc, u1, u2, settings.compat_count_light_pdf
            )
            s_o, s_d = _park_rays(offset_pt, ldir, active)
            shadow, s_mat = closest_hit(scene, s_o, s_d, settings)
            s_mat_ke = s_mat["Ke"]
            s_emissive = shadow.hit & (torch.sum(s_mat_ke, dim=-1) > 0.0)
            s_hit_any = shadow.hit
            diff = hit.point - shadow.point
            d2 = _dot(diff, diff)
            cos_l = _dot(shadow.normal, -ldir)
        else:
            raise ValueError(f"unknown shadow_mode {settings.shadow_mode!r}")

        if settings.compat_count_light_pdf:
            # Reference quirk: Phong NEE brdf keyed on Ns == 40 exactly.
            phong_lane = mat["Ns"] == 40.0
        else:
            phong_lane = torch.sum(mat["Ks"], dim=-1) > 0.0
        if settings.glossy_brdf == "beckmann":
            brdf_gloss = eval_beckmann(
                mat["Ks"], mat["Ns"], d, ldir, n, settings.beckmann_alpha
            )
        else:
            brdf_gloss = eval_phong(mat["Ks"], mat["Ns"], d, ldir, n, mat["Kd"])
        brdf_diff = mat["Kd"] / PI
        brdf = torch.where(phong_lane[:, None], brdf_gloss, brdf_diff)

        cos_s = _dot(n, ldir)
        term = (
            beta
            * s_mat_ke
            * brdf
            * (cos_l * cos_s / torch.clamp(d2, min=1e-20) * weight)[:, None]
        )
        contrib = contrib + torch.where((active & s_emissive)[:, None], term, 0.0)
        shadow_any = shadow_any | s_hit_any
    scale = 1.0 / settings.num_direct_lighting_samples
    return contrib * scale, shadow_any


def bounce_core(scene, settings, o, d, beta, radiance, alive, spec,
                pixel_ids, sample_ids, depth):
    """One masked wavefront bounce over [B] lanes.

    ``depth`` is an int (fixed-depth waves) or a per-lane [B] int64 tensor
    (regenerative pool). Returns the updated lane state plus the number of
    rays traced, an int64 tensor.
    """
    with span("pt.bounce"):
        # Slots 0..6 are consumed below (BSDF_DIR + 2 = 7); extra NEE samples
        # index columns past STRIDE, so only then is the full stride needed.
        if settings.num_direct_lighting_samples == 1:
            n_uniforms = rng.BSDF_DIR + 2
        else:
            n_uniforms = rng.STRIDE + 3 * (settings.num_direct_lighting_samples - 1)
        u = rng.bounce_uniforms(settings, pixel_ids, sample_ids, depth, n_uniforms)

        # Live closest-hit rays this bounce (shadow rays counted below).
        n_rays = torch.sum(alive)

        q_o, q_d = _park_rays(o, d, alive)
        hit, mat = closest_hit(scene, q_o, q_d, settings)
        n = hit.normal_shade

        active = alive & hit.hit
        emissive = torch.sum(mat["Ke"], dim=-1) > 0.0

        # -- emissive termination
        add_mask = active & emissive & (spec | (depth == 0))
        radiance = radiance + torch.where(add_mask[:, None], beta * mat["Ke"], 0.0)
        alive = active & ~add_mask

        # -- NEE
        n_rays = n_rays + torch.sum(alive) * settings.num_direct_lighting_samples
        contrib, shadow_hit = _nee(scene, settings, hit, mat, d, beta, u, alive)
        radiance = radiance + contrib
        if settings.direct_lighting_only:
            alive = alive & ~shadow_hit

        # -- Russian roulette
        alive = alive & (u[:, rng.RR] <= settings.rr_prob)
        inv_rr = 1.0 / settings.rr_prob

        # -- BSDF select
        is_dielectric = mat["illum"] == 7.0
        r_theta, refr_dir, tir = dielectric_directions(
            d, n, mat["Ni"], settings.compat_fixed_eta
        )
        chose_reflect = u[:, rng.FRESNEL] < r_theta
        if not settings.compat_fixed_eta:
            # Corrected mode: total internal reflection reflects.
            chose_reflect = chose_reflect | tir
        refract_lane = is_dielectric & ~chose_reflect
        mirror_lane = (mat["Ns"] > 500.0) | (is_dielectric & chose_reflect)
        specular_lane = refract_lane | mirror_lane

        samp_dir, pdf = sample_cosine_hemisphere(
            n, u[:, rng.BSDF_DIR], u[:, rng.BSDF_DIR + 1]
        )
        glossy_lane = (torch.sum(mat["Ks"], dim=-1) > 0.0) & ~specular_lane
        if settings.glossy_brdf == "beckmann":
            brdf_gloss = eval_beckmann(
                mat["Ks"], mat["Ns"], d, samp_dir, n, settings.beckmann_alpha
            )
            q = _dot(reflect(d, n), samp_dir)
        else:
            brdf_gloss, q = eval_phong_bounce(mat["Ks"], mat["Ns"], d, samp_dir, n)
        brdf_diff = mat["Kd"] / PI
        brdf = torch.where(glossy_lane[:, None], brdf_gloss, brdf_diff)

        new_d = torch.where(
            specular_lane[:, None],
            torch.where(refract_lane[:, None], refr_dir, reflect(d, n)),
            samp_dir,
        )
        new_o = hit.point + RAY_OFFSET * new_d

        cos_t = _dot(samp_dir, n)
        diffuse_scale = brdf * (cos_t / torch.clamp(pdf, min=1e-20) * inv_rr)[:, None]
        new_beta = beta * torch.where(specular_lane[:, None], inv_rr, diffuse_scale)

        bounce_spec = specular_lane | (glossy_lane & (depth == 0) & (q >= 0.0))
        if settings.compat_sticky_specular:
            # Reference quirk: hit_specular is never reset within a path.
            new_spec = spec | (alive & bounce_spec)
        else:
            new_spec = alive & specular_lane

        live = alive[:, None]
        o = torch.where(live, new_o, o)
        d = torch.where(live, new_d, d)
        beta = torch.where(live, new_beta, beta)
        spec = torch.where(alive, new_spec, spec)
        return o, d, beta, radiance, alive, spec, n_rays


def radiance_batch_stats(scene, settings, o, d, pixel_ids, sample_ids):
    """Radiance [B, 3] plus the number of rays traced (int64 tensor).

    ``max_depth`` bounces as a Python loop; it stops early once every lane
    is dead, which changes neither result nor gradient: a dead lane adds
    exact zeros (its selects keep its state, its radiance adds 0.0, its rows
    of the gathers' backward are zero). The test waits for the card, so
    while the stream is being captured into a CUDA graph every bounce runs.
    With grad enabled and a scene tensor requiring grad, each bounce runs
    under ``torch.utils.checkpoint`` (path replay, see the module
    docstring), unless ``path_replay.covers`` the scene and settings: then
    the wave is ``path_replay.RadianceWave``, the bounce and its adjoint as
    CUDA kernels, every bounce run.
    """
    replay = torch.is_grad_enabled() and any(
        getattr(scene, f).requires_grad for f in TENSOR_FIELDS)
    if replay:
        from pathtracer_tpu_torch.ops import path_replay

        if path_replay.covers(scene, settings):
            return path_replay.radiance_wave(scene, settings, o, d, pixel_ids, sample_ids)
    beta = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    spec = torch.zeros_like(alive)
    n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for depth in range(settings.max_depth):
        args = (scene, settings, o, d, beta, radiance, alive, spec,
                pixel_ids, sample_ids, depth)
        if replay:
            # All randomness is counter-based: no torch generator is drawn,
            # so there is no RNG state to preserve for the replay.
            out = checkpoint(bounce_core, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = bounce_core(*args)
        o, d, beta, radiance, alive, spec, dn = out
        n_rays = n_rays + dn
        if capturing(alive):
            continue
        with span("pt.sync"):
            if not bool(torch.any(alive)):
                break
    return radiance, n_rays


def radiance_batch(scene, settings, o, d, pixel_ids, sample_ids):
    """Estimate radiance for a ray batch -> [B, 3]."""
    return radiance_batch_stats(scene, settings, o, d, pixel_ids, sample_ids)[0]
