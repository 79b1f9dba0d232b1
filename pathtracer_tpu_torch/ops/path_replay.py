"""Path replay of a fixed-depth wave by hand: ``RadianceWave``.

Inverse rendering differentiates a wave's radiance with respect to the
material tables (``inverse``). The plain path runs each bounce of
``integrator.bounce_core`` under ``torch.utils.checkpoint``: about a thousand
small torch kernels per bounce and wave, each a few microseconds of the
card's fixed cost. ``RadianceWave`` computes the same radiance and the same
gradients with the kernels of ``csrc/bounce.cu``:

- forward, four launches a bounce: the route's raw closest-hit entry,
  ``bounce_shade_kernel`` (the RNG's slots, the hit's material, the light
  sample, the shadow ray), the route's raw any-hit entry and
  ``bounce_finish_kernel`` (NEE, Russian roulette, the lobe, the state
  update) which writes a per-lane record of the bounce (``Record``);
- backward, one launch of ``bounce_adjoint_kernel`` a wave: each lane walks
  its records from the last bounce to the first, carrying dL/dbeta, and
  writes rows of the material gradients; the deterministic
  ``gather.segment_sum`` adds them into the tables, one call per fitted
  field (``mat_Ke``'s rows of the hit and of the light in one call).

Discrete path structure (hits, lobes, Russian roulette, the light's
triangle) gets no gradient, as in ``bounce_core``'s autograd; the gradients
reach the materials through the values the paths read: the emission added
on a hit, the light's emission and the surface's BSDF in the NEE term, and
the BSDF in each bounce's throughput.

``radiance_batch_stats`` takes this path exactly when ``covers`` holds: a
material table requires grad (and no other scene tensor), the scene is on
CUDA with triangles only and a route with raw kernel entries, and the
settings are those the kernels implement (fast shadows, one light sample,
the Phong lobe, geometric normals, no direct-lighting-only break, the hash
RNG; both values of each compat flag). Everything else, renders and the CPU
included, runs ``bounce_core``.

``record_plain`` and ``adjoint_plain`` are the kernels' torch twin: the same
formulas as tensor ops, on any device and route (``radiance_wave(...,
plain=True)``). On the CPU the twin's radiance has ``bounce_core``'s bits.
``launches`` counts the kernels' launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.models.scene import TENSOR_FIELDS
from pathtracer_tpu_torch.ops import (
    intersect_cluster,
    intersect_small,
    intersect_tiled,
    lights,
    rng,
)
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as shortlist_kernel
from pathtracer_tpu_torch.ops.bsdf import (
    _phong_spec,
    dielectric_directions,
    eval_phong_bounce,
    reflect,
    sample_cosine_hemisphere,
)
from pathtracer_tpu_torch.ops.gather import segment_sum
from pathtracer_tpu_torch.ops.integrator import (
    NEE_OFFSET,
    PI,
    RAY_OFFSET,
    _dot,
    _park_rays,
)
from pathtracer_tpu_torch.ops.intersect import closest_hit, occluded_before, resolve_intersector
from pathtracer_tpu_torch.utils.profiling import span

# The tables the kernels differentiate, in the order RadianceWave takes them.
MATERIAL_FIELDS = ("mat_Kd", "mat_Ks", "mat_Ke", "mat_Ns")

# Kernel launches by kernel; only the launches below add to it.
launches = {"shade": 0, "finish": 0, "adjoint": 0}

# Record bits (csrc/bounce.cu): the emission was added; the NEE term was
# added; NEE took the Phong lobe; the lane survived Russian roulette; the
# lobe was specular; the lobe was glossy (Phong).
ADD, NEE, PHONG_NEE, LIVE, SPECULAR, GLOSSY = 1, 2, 4, 8, 16, 32
# Columns of Record.f: beta (3), the NEE geometry term, the NEE lobe's q,
# the bounce lobe's q, the diffuse scale cos / pdf / rr.
REC_F = 7
# Slots of the hash RNG a bounce with one light sample draws.
N_UNIFORMS = rng.BSDF_DIR + 2


class Record(NamedTuple):
    """A wave's per-lane record of every bounce: ``ids`` [2, D, B] int32 (the
    hit's material, the light's material), ``bits`` [D, B] int32, ``f`` [D,
    REC_F, B] float32. Fields a lane did not reach are 0."""

    ids: torch.Tensor
    bits: torch.Tensor
    f: torch.Tensor


def _closest_small(scene, o, d):
    return intersect_small.closest_tri_small(scene, o, d)[:2]


# Raw entries by route: (t, tri_id) of the closest hit; occluded [B] bool.
_CLOSEST = {
    "small_pallas": _closest_small,
    "shortlist_pallas": shortlist_kernel.closest_tri_shortlist_kernel,
    "pallas": intersect_tiled.closest_tri_tiled,
    "cluster": intersect_cluster.closest_tri_cluster,
}
_OCCLUDED = {
    "small_pallas": lambda s, o, d, c: intersect_small.occluded_tri_small(s, o, d, c)[0],
    "shortlist_pallas": shortlist_kernel.occluded_tri_shortlist_kernel,
    "pallas": lambda s, o, d, c: intersect_tiled.occluded_tri_tiled(s, o, d, c)[0],
    "cluster": lambda s, o, d, c: intersect_cluster.occluded_tri_cluster(s, o, d, c)[0],
}


def covers(scene, settings) -> bool:
    """Whether ``integrator.radiance_batch_stats`` runs the wave as
    ``RadianceWave`` (module docstring) rather than ``bounce_core`` under
    checkpoint."""
    fitted = [getattr(scene, f).requires_grad for f in MATERIAL_FIELDS]
    return (
        torch.is_grad_enabled() and any(fitted)
        and not any(getattr(scene, f).requires_grad for f in TENSOR_FIELDS
                    if f not in MATERIAL_FIELDS)
        and scene.device.type == "cuda" and scene.num_analytic == 0 and scene.num_tris > 0
        and settings.shadow_mode == "fast" and settings.num_direct_lighting_samples == 1
        and settings.glossy_brdf == "phong" and not settings.use_vertex_normals
        and not settings.direct_lighting_only and settings.rng == "hash"
        and resolve_intersector(settings, scene) in _CLOSEST
    )


def radiance_wave(scene, settings, o, d, pixel_ids, sample_ids, plain: bool = False):
    """(radiance [B, 3], rays traced, an int64 tensor) of a wave of
    ``settings.max_depth`` bounces, differentiable in the scene's material
    tables: the kernels, or with ``plain`` their torch twin."""
    tables = [getattr(scene, f) for f in MATERIAL_FIELDS]
    return RadianceWave.apply(scene, settings, plain, o, d, pixel_ids, sample_ids, *tables)


class RadianceWave(torch.autograd.Function):
    """A wave's radiance whose backward replays its paths from their
    records (module docstring). Inputs after the scene, the settings and
    ``plain``: the rays, the pixel and sample ids, the ``MATERIAL_FIELDS``
    tables."""

    @staticmethod
    def forward(ctx, scene, settings, plain, o, d, pixel_ids, sample_ids, *tables):
        tables = {f: t.detach() for f, t in zip(MATERIAL_FIELDS, tables)}
        scene = dataclasses.replace(scene, **tables)
        record = record_plain if plain else record_kernels
        radiance, n_rays, rec = record(scene, settings, o.detach(), d.detach(), pixel_ids,
                                       sample_ids)
        ctx.scene, ctx.settings, ctx.plain = scene, settings, plain
        ctx.save_for_backward(*rec)
        ctx.mark_non_differentiable(n_rays)
        return radiance, n_rays

    @staticmethod
    def backward(ctx, g_rad, _):
        needs = ctx.needs_input_grad[7:]
        if g_rad is None or not any(needs):
            return (None,) * (7 + len(MATERIAL_FIELDS))
        rec = Record(*ctx.saved_tensors)
        adjoint = adjoint_plain if ctx.plain else adjoint_kernel
        with span("pt.bounce"):
            rows = adjoint(ctx.scene, ctx.settings, rec, g_rad.contiguous(), needs)
        with span("pt.gather_backward"):
            grads = material_grads(ctx.scene, rec, rows, needs)
        return (None,) * 7 + tuple(grads)


def material_grads(scene, rec, rows, needs) -> list:
    """Each fitted table's gradient: its rows ([D, B, ...]; ``mat_Ke``'s [2,
    D, B, 3]) summed by material id (``segment_sum``); None for the rest."""
    ids = rec.ids if rec.ids.is_cuda else rec.ids.long()
    out = []
    for field, r, need in zip(MATERIAL_FIELDS, rows, needs):
        if not need:
            out.append(None)
            continue
        shape = getattr(scene, field).shape
        by = ids if field == "mat_Ke" else ids[0]
        out.append(segment_sum(r.reshape(-1, *shape[1:]), by.reshape(-1), shape))
    return out


# --- the kernels ---

class _SceneArgs(ctypes.Structure):
    """csrc/bounce.cu's ``BounceScene``."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_mat", "mat_kd", "mat_ks", "mat_ke",
        "mat_ns", "mat_ni", "mat_illum", "emissive_tri", "light_cdf", "light_total")] + [
        ("e_pad", ctypes.c_int), ("n_emissive", ctypes.c_int), ("compat_count", ctypes.c_int),
        ("compat_sticky", ctypes.c_int), ("compat_eta", ctypes.c_int),
        ("rr_prob", ctypes.c_float), ("inv_rr", ctypes.c_float), ("seed_mix", ctypes.c_uint32)]


def _scene_args(scene, settings):
    """(the ``_SceneArgs`` of a launch, the tensors it points into)."""
    cdf = total = None
    if not settings.compat_count_light_pdf:
        cdf, total = lights.emissive_cdf(scene)
        cdf, total = cdf.contiguous(), total.reshape(1)
    floats = {"tri_v0": scene.tri_v0, "tri_e1": scene.tri_e1, "tri_e2": scene.tri_e2,
              "tri_n": scene.tri_n, "mat_kd": scene.mat_Kd, "mat_ks": scene.mat_Ks,
              "mat_ke": scene.mat_Ke, "mat_ns": scene.mat_Ns, "mat_ni": scene.mat_Ni,
              "mat_illum": scene.mat_illum, "light_cdf": cdf, "light_total": total}
    ints = {"tri_mat": scene.tri_mat, "emissive_tri": scene.emissive_tri}
    ptrs = {}
    for group, dtype in ((floats, torch.float32), (ints, torch.int64)):
        for name, t in group.items():
            if t is None:
                ptrs[name] = None
                continue
            if t.dtype != dtype or t.device != scene.device or not t.is_contiguous():
                raise TypeError(f"the bounce kernels take {name} as contiguous {dtype} on "
                                f"{scene.device}, not {t.dtype} on {t.device}")
            ptrs[name] = t.data_ptr()
    args = _SceneArgs(
        **ptrs, e_pad=scene.emissive_tri.shape[0], n_emissive=max(scene.num_emissive, 1),
        compat_count=int(settings.compat_count_light_pdf),
        compat_sticky=int(settings.compat_sticky_specular),
        compat_eta=int(settings.compat_fixed_eta), rr_prob=settings.rr_prob,
        inv_rr=1.0 / settings.rr_prob, seed_mix=rng._seed_mix(settings.seed))
    return args, (cdf, total)


class KernelWave:
    """A wave's lane state and record on the card, and the launches of its
    bounces: ``bounce(depth)`` is the route's closest hit, ``shade``, the
    route's any-hit and ``finish``."""

    def __init__(self, scene, settings, o, d, pixel_ids, sample_ids):
        from pathtracer_tpu_torch import kernels

        o, d = o.contiguous(), d.contiguous()
        intersect_small.check_rays(scene, o, d)
        self.lib, self.check = kernels.library(), kernels.check
        self.scene, self.settings = scene, settings
        method = resolve_intersector(settings, scene)
        self._closest, self._occluded = _CLOSEST[method], _OCCLUDED[method]
        self.args, self._held = _scene_args(scene, settings)
        b, depths, dev = o.shape[0], settings.max_depth, o.device
        self.b, self.device = b, dev
        self.o, self.d = o.clone(), d.clone()
        self.beta, self.rad = torch.ones_like(self.o), torch.zeros_like(self.o)
        self.flags = torch.ones(b, dtype=torch.uint8, device=dev)
        self.pix = pixel_ids.to(torch.int64).contiguous()
        self.smp = sample_ids.to(torch.int64).contiguous()
        self.s_o, self.s_d = torch.empty_like(self.o), torch.empty_like(self.o)
        self.t_cut = torch.empty(b, dtype=torch.float32, device=dev)
        # Every bounce writes every lane's record.
        self.rec = Record(torch.empty((2, depths, b), dtype=torch.int32, device=dev),
                          torch.empty((depths, b), dtype=torch.int32, device=dev),
                          torch.empty((depths, REC_F, b), dtype=torch.float32, device=dev))
        self.n_rays = torch.zeros(1, dtype=torch.int64, device=dev)

    def closest(self):
        """(t, tri_id) of the lanes' rays (dead lanes are parked)."""
        with span("pt.intersect"):
            return self._closest(self.scene, self.o, self.d)

    def shade(self, depth, t, tri):
        """The shadow rays ``s_o``, ``s_d``, ``t_cut`` of bounce ``depth``."""
        with torch.cuda.device(self.device):
            rc = self.lib.pt_bounce_shade(
                ctypes.addressof(self.args), self.o.data_ptr(), self.d.data_ptr(),
                self.flags.data_ptr(), t.data_ptr(), tri.data_ptr(), tri.element_size(),
                self.pix.data_ptr(), self.smp.data_ptr(), self.b, depth, self.s_o.data_ptr(),
                self.s_d.data_ptr(), self.t_cut.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        self.check(rc, "bounce shade kernel")
        launches["shade"] += 1

    def occluded(self):
        with span("pt.intersect"):
            return self._occluded(self.scene, self.s_o, self.s_d, self.t_cut)

    def finish(self, depth, t, tri, occ):
        """The rest of bounce ``depth``, in place, and its record."""
        with torch.cuda.device(self.device):
            rc = self.lib.pt_bounce_finish(
                ctypes.addressof(self.args), self.o.data_ptr(), self.d.data_ptr(),
                self.beta.data_ptr(), self.rad.data_ptr(), self.flags.data_ptr(), t.data_ptr(),
                tri.data_ptr(), tri.element_size(), occ.data_ptr(), self.pix.data_ptr(),
                self.smp.data_ptr(), self.b, depth, self.settings.max_depth,
                self.rec.ids.data_ptr(), self.rec.bits.data_ptr(), self.rec.f.data_ptr(),
                self.n_rays.data_ptr(), torch.cuda.current_stream().cuda_stream)
        self.check(rc, "bounce finish kernel")
        launches["finish"] += 1

    def bounce(self, depth):
        with span("pt.bounce"):
            t, tri = self.closest()
            self.shade(depth, t, tri)
            self.finish(depth, t, tri, self.occluded())


def record_kernels(scene, settings, o, d, pixel_ids, sample_ids):
    """The wave by the kernels -> (radiance [B, 3], rays traced, ``Record``).
    Every bounce runs: nothing waits for the card."""
    wave = KernelWave(scene, settings, o, d, pixel_ids, sample_ids)
    for depth in range(settings.max_depth):
        wave.bounce(depth)
    return wave.rad, wave.n_rays.reshape(()), wave.rec


def adjoint_kernel(scene, settings, rec, g_rad, needs):
    """The rows of each fitted table's gradient by ``bounce_adjoint_kernel``
    -> (Kd [D, B, 3], Ks [D, B, 3], Ke [2, D, B, 3], Ns [D, B]), None for a
    field that is not fitted."""
    from pathtracer_tpu_torch import kernels

    depths, b = rec.bits.shape
    dev = g_rad.device
    shapes = {"mat_Kd": (depths, b, 3), "mat_Ks": (depths, b, 3),
              "mat_Ke": (2, depths, b, 3), "mat_Ns": (depths, b)}
    rows = [torch.empty(shapes[f], dtype=torch.float32, device=dev) if need else None
            for f, need in zip(MATERIAL_FIELDS, needs)]
    args, _held = _scene_args(scene, settings)
    with torch.cuda.device(dev):
        rc = kernels.library().pt_bounce_adjoint(
            ctypes.addressof(args), g_rad.data_ptr(), rec.ids.data_ptr(),
            rec.bits.data_ptr(), rec.f.data_ptr(), b, depths,
            *(r.data_ptr() if r is not None else None for r in rows),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "bounce adjoint kernel")
    launches["adjoint"] += 1
    return rows


# --- the torch twin ---

def _bounce_plain(scene, settings, o, d, beta, radiance, alive, spec, pixel_ids, sample_ids,
                  depth):
    """One bounce of ``bounce_core`` under the settings ``covers`` admits,
    by its ops, and the bounce's record -> (o, d, beta, radiance, alive,
    spec, rays traced, (hit material, light material), bits, f)."""
    compat = settings.compat_count_light_pdf
    u = rng.bounce_uniforms_hash(pixel_ids, sample_ids, depth, N_UNIFORMS, seed=settings.seed)
    n_rays = torch.sum(alive)
    q_o, q_d = _park_rays(o, d, alive)
    hit, mat = closest_hit(scene, q_o, q_d, settings)
    n = hit.normal_shade
    active = alive & hit.hit
    add = active & (torch.sum(mat["Ke"], dim=-1) > 0.0) & (spec | (depth == 0))
    radiance = radiance + torch.where(add[:, None], beta * mat["Ke"], 0.0)
    alive = active & ~add
    n_rays = n_rays + torch.sum(alive)

    # -- NEE: one light sample, an occlusion test
    offset_pt = hit.point + hit.normal * NEE_OFFSET
    uc, u1, u2 = u[:, rng.LIGHT_CHOICE], u[:, rng.LIGHT_BARY], u[:, rng.LIGHT_BARY + 1]
    ldir, weight, l_pt, l_n, l_ke, t_target = lights.sample_area_lights_detailed(
        scene, offset_pt, uc, u1, u2, compat)
    j, _ = lights._choose_emissive(scene, offset_pt, uc, compat)
    light_mat = scene.tri_mat[scene.emissive_tri[j]]
    s_o, s_d = _park_rays(offset_pt, ldir, alive)
    occluded, _ = occluded_before(scene, s_o, s_d, torch.where(alive, t_target, 0.0), settings)
    nee = alive & ~occluded & (torch.sum(l_ke, dim=-1) > 0.0)
    diff = hit.point - l_pt
    d2 = _dot(diff, diff)
    cos_l = _dot(l_n, -ldir)
    phong = mat["Ns"] == 40.0 if compat else torch.sum(mat["Ks"], dim=-1) > 0.0
    q_nee = _dot(reflect(d, n), ldir)
    gloss = torch.where((q_nee < 0.0)[:, None], (-q_nee)[:, None] * mat["Kd"] / PI,
                        _phong_spec(mat["Ks"], mat["Ns"], q_nee))
    brdf = torch.where(phong[:, None], gloss, mat["Kd"] / PI)
    cos_s = _dot(n, ldir)
    geom = cos_l * cos_s / torch.clamp(d2, min=1e-20) * weight
    radiance = radiance + torch.where(nee[:, None], beta * l_ke * brdf * geom[:, None], 0.0)

    # -- Russian roulette, then the lobe
    mid = alive
    alive = alive & (u[:, rng.RR] <= settings.rr_prob)
    inv_rr = 1.0 / settings.rr_prob
    is_dielectric = mat["illum"] == 7.0
    r_theta, refr_dir, tir = dielectric_directions(d, n, mat["Ni"], settings.compat_fixed_eta)
    chose_reflect = u[:, rng.FRESNEL] < r_theta
    if not settings.compat_fixed_eta:
        chose_reflect = chose_reflect | tir
    refract = is_dielectric & ~chose_reflect
    specular = refract | (mat["Ns"] > 500.0) | (is_dielectric & chose_reflect)
    samp_dir, pdf = sample_cosine_hemisphere(n, u[:, rng.BSDF_DIR], u[:, rng.BSDF_DIR + 1])
    glossy = (torch.sum(mat["Ks"], dim=-1) > 0.0) & ~specular
    brdf_gloss, q_b = eval_phong_bounce(mat["Ks"], mat["Ns"], d, samp_dir, n)
    brdf = torch.where(glossy[:, None], brdf_gloss, mat["Kd"] / PI)
    new_d = torch.where(specular[:, None],
                        torch.where(refract[:, None], refr_dir, reflect(d, n)), samp_dir)
    new_o = hit.point + RAY_OFFSET * new_d
    scale = _dot(samp_dir, n) / torch.clamp(pdf, min=1e-20) * inv_rr
    new_beta = beta * torch.where(specular[:, None], inv_rr, brdf * scale[:, None])
    bounce_spec = specular | (glossy & (depth == 0) & (q_b >= 0.0))
    if settings.compat_sticky_specular:
        new_spec = spec | (alive & bounce_spec)
    else:
        new_spec = alive & specular

    # What a lane did not reach reads 0, as the kernel leaves it.
    bits = (add * ADD | nee * NEE | (phong & nee) * PHONG_NEE | alive * LIVE
            | (specular & alive) * SPECULAR | (glossy & alive) * GLOSSY).to(torch.int32)
    diffuse = alive & ~specular
    f = torch.stack([beta[:, 0], beta[:, 1], beta[:, 2], torch.where(mid, geom, 0.0),
                     torch.where(mid, q_nee, 0.0), torch.where(diffuse, q_b, 0.0),
                     torch.where(diffuse, scale, 0.0)])
    live = alive[:, None]
    return (torch.where(live, new_o, o), torch.where(live, new_d, d),
            torch.where(live, new_beta, beta), radiance, alive,
            torch.where(alive, new_spec, spec), n_rays,
            (hit.mat_id, torch.where(mid, light_mat, 0)), bits, f)


def record_plain(scene, settings, o, d, pixel_ids, sample_ids):
    """``record_kernels`` by torch ops -> (radiance, rays traced, ``Record``)."""
    beta, radiance = torch.ones_like(o), torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    spec = torch.zeros_like(alive)
    n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
    ids, bits, f = [], [], []
    for depth in range(settings.max_depth):
        o, d, beta, radiance, alive, spec, dn, ids_k, bits_k, f_k = _bounce_plain(
            scene, settings, o, d, beta, radiance, alive, spec, pixel_ids, sample_ids, depth)
        n_rays = n_rays + dn
        ids.append(torch.stack(ids_k).to(torch.int32))
        bits.append(bits_k)
        f.append(f_k)
    rec = Record(torch.stack(ids, dim=1), torch.stack(bits), torch.stack(f))
    return radiance, n_rays, rec


def _phong_c(ns, q):
    """``bsdf._phong_spec``'s scalar (ns + 2) / (2 pi) clamp(q)^ns and its
    derivative in ns."""
    x = torch.clamp(q, min=1e-20)
    p = torch.pow(x, ns)
    c = (ns + 2.0) / (2.0 * PI) * p
    return c, p / (2.0 * PI) + c * torch.log(x)


def adjoint_plain(scene, settings, rec, g_rad, needs=None):
    """``adjoint_kernel`` by torch ops: every field's rows."""
    depths, b = rec.bits.shape
    inv_rr = 1.0 / settings.rr_prob
    ids = rec.ids.long()
    d_kd = g_rad.new_zeros((depths, b, 3))
    d_ks = torch.zeros_like(d_kd)
    d_ke = g_rad.new_zeros((2, depths, b, 3))
    d_ns = g_rad.new_zeros((depths, b))
    gb = torch.zeros_like(g_rad)
    for k in reversed(range(depths)):
        m = ids[0, k]
        kd, ks, ns = scene.mat_Kd[m], scene.mat_Ks[m], scene.mat_Ns[m]
        add, nee, phong, live, specular, glossy = (
            ((rec.bits[k] & bit) != 0)[:, None]
            for bit in (ADD, NEE, PHONG_NEE, LIVE, SPECULAR, GLOSSY))
        beta = rec.f[k, 0:3].T
        geom, q_nee, q_b, scale = (rec.f[k, c][:, None] for c in range(3, REC_F))

        # beta' = beta * (specular ? 1 / rr : brdf * scale) on live lanes
        c_b, dc_b = _phong_c(ns[:, None], q_b)
        lobe = live & glossy & (q_b >= 0.0)
        gf = gb * beta * scale
        diffuse = live & ~specular & ~glossy
        d_kd[k] = torch.where(diffuse, gf / PI, 0.0)
        d_ks[k] = torch.where(lobe, gf * c_b, 0.0)
        d_ns[k] = torch.where(lobe, torch.sum(gf * ks, -1, keepdim=True) * dc_b, 0.0)[:, 0]
        brdf_b = torch.where(glossy, torch.where(q_b >= 0.0, ks * c_b, 0.0), kd / PI)
        g = torch.where(live, gb * torch.where(specular, inv_rr, brdf_b * scale), gb)

        # radiance += ((beta * ke_light) * brdf) * geom
        kel = scene.mat_Ke[ids[1, k]]
        c_n, dc_n = _phong_c(ns[:, None], q_nee)
        below = q_nee < 0.0
        brdf_n = torch.where(phong, torch.where(below, -q_nee * kd / PI, ks * c_n), kd / PI)
        gx = g_rad * geom
        gbk = gx * brdf_n
        d_ke[1, k] = torch.where(nee, gbk * beta, 0.0)
        g = g + torch.where(nee, gbk * kel, 0.0)
        gbr = gx * (beta * kel)
        d_kd[k] += torch.where(nee & ~phong, gbr / PI, 0.0)
        d_kd[k] += torch.where(nee & phong & below, gbr * -q_nee / PI, 0.0)
        d_ks[k] += torch.where(nee & phong & ~below, gbr * c_n, 0.0)
        d_ns[k] += torch.where(nee & phong & ~below,
                               torch.sum(gbr * ks, -1, keepdim=True) * dc_n, 0.0)[:, 0]

        # radiance += beta * ke
        d_ke[0, k] = torch.where(add, g_rad * beta, 0.0)
        gb = g + torch.where(add, g_rad * scene.mat_Ke[m], 0.0)
    return [d_kd, d_ks, d_ke, d_ns]
