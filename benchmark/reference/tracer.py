"""The plain path tracer that the render, preview and fit cells are held to.

A frozen copy of the port's plain path (``pathtracer_tpu_torch`` at the
commit that added this benchmark): the hash RNG (``ops/rng.py``), pinhole
camera rays (``ops/camera_rays.py``, ``models/camera.py``), Moller-Trumbore
by a brute sweep (``ops/intersect.py``), area-light NEE with the fast shadow
test (``ops/lights.py``), the Phong and dielectric BSDFs (``ops/bsdf.py``),
Russian roulette and one masked bounce (``ops/integrator.py``), traced as
fixed-depth sample waves over every pixel. It imports nothing of the port.

Paths are keyed on (pixel, sample, bounce), so a wave's radiance is each
path's own, whichever scheduler traced it: the port's regenerative pool and
this sweep trace the same rays, and their images differ only in the order of
summation. The bounce runs at the full width of a wave, as the port's scan
does; only the sweep is compacted to the live rays, which leaves every ray's
``t`` as it is (the sweep is elementwise per ray and triangle).

``dtype`` sets the precision of every float (the control of the cells:
bfloat16 for the configurations' float32). Only the Phong lobe and the fast
shadow test are here: the configurations use no other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
NEE_OFFSET = 1.0e-4
RAY_OFFSET = 1.0e-3
EPS_TRI = 1e-8
INF = float("inf")
PARK_POS = 1.0e6
SWEEP_TILE = 256  # triangles per step of the sweep
SWEEP_RAYS = 1 << 16  # rays per step of the sweep

# --- the hash RNG ---
STRIDE = 8
LIGHT_CHOICE, LIGHT_BARY, RR, FRESNEL, BSDF_DIR = 0, 1, 3, 4, 5
PIXEL_JITTER = 1 << 20
_MASK = 0xFFFFFFFF
_C1, _C2, _C3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_M1, _M2 = 0x85EBCA6B, 0xC2B2AE35
_XM = 0x7FEB352D


def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _seed_mix(seed: int) -> int:
    x = seed & _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 13
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def _u32(x, like):
    return torch.as_tensor(x, dtype=torch.int64, device=like.device) & _MASK


def hash_u32(pixel, sample, counter, seed):
    p = _u32(pixel, pixel)
    counter = _u32(counter, p)
    h = _mul32(p, _C1) ^ _seed_mix(seed)
    h = _fmix32(h ^ _mul32(_u32(sample, p), _C2))
    return _fmix32(h ^ _mul32(counter, _C3))


def _u01(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _xmx(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _XM)
    return x ^ (x >> 15)


def _slot_salt(i: int) -> int:
    x = ((i + 1) * 0x9E3779B9) & _MASK
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK
    return x ^ (x >> 13)


def bounce_uniforms(pixel, sample, bounce, n, seed, dtype):
    base = hash_u32(pixel, sample, bounce, seed)
    return torch.stack([_u01(_xmx(base ^ _slot_salt(i))) for i in range(n)],
                       dim=-1).to(dtype)


def pixel_jitter(pixel, sample, seed, dtype):
    base = hash_u32(pixel, sample, PIXEL_JITTER, seed)
    return torch.stack([_u01(base), _u01(_xmx(base ^ _slot_salt(1)))], dim=-1).to(dtype)


# --- camera ---
def _normalize_np(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


def ray_frame(camera, width: int, height: int, device, dtype) -> dict:
    look = _normalize_np(np.asarray(camera.focus) - np.asarray(camera.pos))
    right = _normalize_np(np.cross(look, np.asarray(camera.up, dtype=np.float64)))
    true_up = np.cross(right, look)
    span_y = 2.0 * np.tan(0.5 * np.deg2rad(camera.height_angle_deg))
    span_x = span_y * (width / height)
    f32 = {
        "origin": np.asarray(camera.pos, dtype=np.float32),
        "right": right.astype(np.float32),
        "up": true_up.astype(np.float32),
        "look": look.astype(np.float32),
        "span": np.array([span_x, span_y], dtype=np.float32),
    }
    return {k: torch.as_tensor(v, device=device).to(dtype) for k, v in f32.items()}


def camera_rays(frame, width: int, height: int, pixel, jitter):
    dtype = frame["origin"].dtype
    px = (pixel % width).to(dtype) + jitter[:, 0] - 0.5
    py = torch.div(pixel, width, rounding_mode="floor").to(dtype) + jitter[:, 1] - 0.5
    nx = (px + 0.5) / width - 0.5
    ny = (height - 1.0 - py + 0.5) / height - 0.5
    span = frame["span"]
    d = ((nx * span[0])[:, None] * frame["right"][None, :]
         + (ny * span[1])[:, None] * frame["up"][None, :] + frame["look"][None, :])
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return frame["origin"][None, :].expand_as(d).contiguous(), d


# --- intersection: the brute sweep over the live rays ---
def _mt(o, d, v0, e1, e2):
    """Rays [b, 3] x triangles [t, 3] -> (t [b, t] (inf where missed), ok)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > EPS_TRI
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS_TRI)
    return torch.where(ok, t, INF), ok


def _sweep(scene, o, d, t_cut=None):
    """Closest (t, id) of every ray, or with ``t_cut`` whether something
    lies before it; the smallest id wins a tie, as in the port's sweep."""
    n = scene["num_tris"]
    v0, e1, e2 = scene["tri_v0"], scene["tri_e1"], scene["tri_e2"]
    best_t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    best_id = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for r in range(0, o.shape[0], SWEEP_RAYS):
        ro, rd = o[r:r + SWEEP_RAYS], d[r:r + SWEEP_RAYS]
        for s in range(0, n, SWEEP_TILE):
            e = min(s + SWEEP_TILE, n)
            t, ok = _mt(ro, rd, v0[s:e], e1[s:e], e2[s:e])
            if t_cut is not None:
                occ[r:r + SWEEP_RAYS] |= torch.any(ok & (t < t_cut[r:r + SWEEP_RAYS, None]), dim=1)
                continue
            tile_t, tile_arg = torch.min(t, dim=1)
            better = tile_t < best_t[r:r + SWEEP_RAYS]
            best_t[r:r + SWEEP_RAYS] = torch.where(better, tile_t, best_t[r:r + SWEEP_RAYS])
            best_id[r:r + SWEEP_RAYS] = torch.where(better, tile_arg + s,
                                                    best_id[r:r + SWEEP_RAYS])
    return occ if t_cut is not None else (best_t, best_id)


def _park(o, d, live):
    dead = ~live[:, None]
    o = torch.where(dead, PARK_POS, o)
    d = torch.where(dead, torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype, device=o.device), d)
    return o, d


def _gather(table, idx):
    """``table[idx]`` whose gradient sums by ``index_add_``."""
    return torch.index_select(table, 0, idx)


def closest_hit(scene, o, d, live):
    """(hit, t, point, normal, material dict) of the parked rays; the sweep
    runs on the live lanes only (a parked lane misses)."""
    q_o, q_d = _park(o, d, live)
    lanes = torch.nonzero(live).squeeze(1)
    t_l, id_l = _sweep(scene, q_o[lanes].detach(), q_d[lanes].detach())
    t_tri = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    tri_id = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    t_tri = t_tri.index_put((lanes,), t_l)
    tri_id = tri_id.index_put((lanes,), id_l)
    tri_hit = tri_id >= 0
    win = torch.clamp(tri_id, min=0)
    n_geo = torch.where(tri_hit[:, None], _gather(scene["tri_n"], win), 0.0)
    mat_id = torch.where(tri_hit, _gather(scene["tri_mat"], win), 0)
    t_pt = torch.where(torch.isfinite(t_tri), t_tri, 0.0)
    point = q_o + t_pt[:, None] * q_d
    hit = torch.isfinite(t_tri)
    mat = {}
    for k in ("Kd", "Ks", "Ke", "Ns", "Ni", "illum"):
        v = _gather(scene[f"mat_{k}"], mat_id)
        mat[k] = torch.where(hit[:, None] if v.dim() == 2 else hit, v, 0.0)
    unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype, device=o.device)
    n_geo = torch.where(hit[:, None], n_geo, unit_z)
    mat["Ni"] = torch.where(hit, mat["Ni"], 1.0)
    return hit, point, n_geo, mat


def occluded(scene, o, d, t_max, active):
    """Whether something lies before ``t_max * (1 - 1e-3)`` on the active
    lanes' shadow rays."""
    t_cut = t_max * (1.0 - 1e-3)
    lanes = torch.nonzero(active).squeeze(1)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    return occ.index_put((lanes,), _sweep(scene, o[lanes].detach(), d[lanes].detach(),
                                          t_cut[lanes].detach()))


# --- lights and BSDFs ---
def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def sample_light(scene, x, u_choice, u1, u2, compat_count_pdf):
    n_emissive = max(scene["num_emissive"], 1)
    n_f = torch.tensor(n_emissive, dtype=x.dtype, device=x.device)
    if compat_count_pdf:
        j = torch.clamp((u_choice * n_f).to(torch.int64), max=n_emissive - 1)
        weight = torch.full((x.shape[0],), 1.0, dtype=x.dtype, device=x.device) / n_f
    else:
        areas = scene["emissive_area"]
        total = torch.clamp(torch.sum(areas), min=1e-20)
        cdf = torch.cumsum(areas, dim=0) / total
        j = torch.clamp(torch.searchsorted(cdf, u_choice.contiguous(), right=True),
                        max=n_emissive - 1)
        weight = torch.full((x.shape[0],), 1.0, dtype=x.dtype, device=x.device) * total
    tri = _gather(scene["emissive_tri"], j)
    v0 = _gather(scene["tri_v0"], tri)
    p1 = v0 + _gather(scene["tri_e1"], tri)
    p2 = v0 + _gather(scene["tri_e2"], tri)
    n_l = _gather(scene["tri_n"], tri)
    ke = _gather(scene["mat_Ke"], _gather(scene["tri_mat"], tri))
    su = torch.sqrt(u1)
    b0 = 1.0 - su
    b1 = u2 * su
    p = b0[:, None] * v0 + b1[:, None] * p1 + (1.0 - b0 - b1)[:, None] * p2
    to_p = p - x
    t_target = _norm(to_p)
    direction = to_p / torch.clamp(t_target, min=1e-20)[:, None]
    return direction, weight, p, n_l, ke, t_target


def reflect(d, n):
    return d - 2.0 * _dot(d, n)[:, None] * n


def _tangent_frame(n):
    s = torch.where(n[:, 2] < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1)
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def sample_cosine(n, u1, u2):
    phi = (2.0 * PI) * u1
    cos_t = torch.sqrt(u2)
    sin_t = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    t, bt = _tangent_frame(n)
    return local[:, 0:1] * t + local[:, 1:2] * bt + local[:, 2:3] * n, cos_t / PI


def _phong_spec(ks, ns, q):
    return ks * ((ns + 2.0) / (2.0 * PI) * torch.pow(torch.clamp(q, min=1e-20), ns))[:, None]


def eval_phong(ks, ns, w_in, w_out, n, kd):
    q = _dot(reflect(w_in, n), w_out)
    return torch.where((q < 0.0)[:, None], (-q)[:, None] * kd / PI, _phong_spec(ks, ns, q))


def eval_phong_bounce(ks, ns, w_in, w_out, n):
    q = _dot(reflect(w_in, n), w_out)
    return torch.where((q < 0.0)[:, None], 0.0, _phong_spec(ks, ns, q)), q


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-20)[:, None]


def dielectric_directions(d, n, eta_mat, compat_fixed_eta):
    eta = torch.full_like(eta_mat, 2.5) if compat_fixed_eta else eta_mat
    cos_raw = torch.clamp(_dot(d, n), -1.0, 1.0)
    entering = cos_raw < 0.0
    cos_i = torch.abs(cos_raw)
    eta_i = torch.where(entering, 1.0, eta)
    eta_t = torch.where(entering, eta, 1.0)
    n_ref = torch.where(entering[:, None], n, -n)
    r = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r * r
    r_theta = r0 + (1.0 - r0) * torch.pow(1.0 - cos_i, 5.0)
    ratio = eta_i / eta_t
    k = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    refr = ratio[:, None] * d + (ratio * cos_i - torch.sqrt(torch.clamp(k, 0.0, 1.0)))[:, None] * n_ref
    return r_theta, _normalize(refr), k < 0.0


# --- one bounce and a wave ---
def bounce(scene, st, o, d, beta, radiance, alive, spec, pixel, sample, depth):
    """One masked bounce over the wave's lanes; ``st`` the settings dict.
    Returns the lane state and the rays traced (closest plus shadow)."""
    dtype = o.dtype
    n_nee = st["num_direct_lighting_samples"]
    n_u = BSDF_DIR + 2 if n_nee == 1 else STRIDE + 3 * (n_nee - 1)
    u = bounce_uniforms(pixel, sample, depth, n_u, st["seed"], dtype)
    n_rays = torch.sum(alive)

    hit, point, n, mat = closest_hit(scene, o, d, alive)
    active = alive & hit
    emissive = torch.sum(mat["Ke"], dim=-1) > 0.0
    add_mask = active & emissive & (spec | (depth == 0))
    radiance = radiance + torch.where(add_mask[:, None], beta * mat["Ke"], 0.0)
    alive = active & ~add_mask

    # NEE, fast shadow mode.
    n_rays = n_rays + torch.sum(alive) * n_nee
    offset_pt = point + n * NEE_OFFSET
    contrib = torch.zeros_like(beta)
    shadow_any = torch.zeros_like(alive)
    for s in range(n_nee):
        i_choice = LIGHT_CHOICE if s == 0 else STRIDE + 3 * (s - 1)
        i_bary = LIGHT_BARY if s == 0 else i_choice + 1
        ldir, weight, l_pt, l_n, s_ke, t_target = sample_light(
            scene, offset_pt, u[:, i_choice], u[:, i_bary], u[:, i_bary + 1],
            st["compat_count_light_pdf"])
        s_o, s_d = _park(offset_pt, ldir, alive)
        occ = occluded(scene, s_o, s_d, torch.where(alive, t_target, 0.0), alive)
        s_emissive = ~occ & (torch.sum(s_ke, dim=-1) > 0.0)
        diff = point - l_pt
        d2 = _dot(diff, diff)
        cos_l = _dot(l_n, -ldir)
        if st["compat_count_light_pdf"]:
            phong_lane = mat["Ns"] == 40.0
        else:
            phong_lane = torch.sum(mat["Ks"], dim=-1) > 0.0
        brdf = torch.where(phong_lane[:, None],
                           eval_phong(mat["Ks"], mat["Ns"], d, ldir, n, mat["Kd"]),
                           mat["Kd"] / PI)
        cos_s = _dot(n, ldir)
        term = beta * s_ke * brdf * (cos_l * cos_s / torch.clamp(d2, min=1e-20) * weight)[:, None]
        contrib = contrib + torch.where((alive & s_emissive)[:, None], term, 0.0)
        shadow_any = shadow_any | occ
    radiance = radiance + contrib * (1.0 / n_nee)
    if st["direct_lighting_only"]:
        raise ValueError("direct lighting only is not in the reference")

    alive = alive & (u[:, RR] <= st["rr_prob"])
    inv_rr = 1.0 / st["rr_prob"]
    is_dielectric = mat["illum"] == 7.0
    r_theta, refr_dir, tir = dielectric_directions(d, n, mat["Ni"], st["compat_fixed_eta"])
    chose_reflect = u[:, FRESNEL] < r_theta
    if not st["compat_fixed_eta"]:
        chose_reflect = chose_reflect | tir
    refract_lane = is_dielectric & ~chose_reflect
    mirror_lane = (mat["Ns"] > 500.0) | (is_dielectric & chose_reflect)
    specular_lane = refract_lane | mirror_lane
    samp_dir, pdf = sample_cosine(n, u[:, BSDF_DIR], u[:, BSDF_DIR + 1])
    glossy_lane = (torch.sum(mat["Ks"], dim=-1) > 0.0) & ~specular_lane
    brdf_gloss, q = eval_phong_bounce(mat["Ks"], mat["Ns"], d, samp_dir, n)
    brdf = torch.where(glossy_lane[:, None], brdf_gloss, mat["Kd"] / PI)
    new_d = torch.where(specular_lane[:, None],
                        torch.where(refract_lane[:, None], refr_dir, reflect(d, n)), samp_dir)
    new_o = point + RAY_OFFSET * new_d
    cos_t = _dot(samp_dir, n)
    diffuse_scale = brdf * (cos_t / torch.clamp(pdf, min=1e-20) * inv_rr)[:, None]
    new_beta = beta * torch.where(specular_lane[:, None], inv_rr, diffuse_scale)
    bounce_spec = specular_lane | (glossy_lane & (depth == 0) & (q >= 0.0))
    if st["compat_sticky_specular"]:
        new_spec = spec | (alive & bounce_spec)
    else:
        new_spec = alive & specular_lane
    live = alive[:, None]
    return (torch.where(live, new_o, o), torch.where(live, new_d, d),
            torch.where(live, new_beta, beta), radiance, alive,
            torch.where(alive, new_spec, spec), n_rays)


def wave(scene, st, frame, pixel, sample):
    """Radiance [B, 3] (before the per-path clamp) of one sample per lane
    and the rays traced."""
    dtype = frame["origin"].dtype
    o, d = camera_rays(frame, st["width"], st["height"], pixel,
                       pixel_jitter(pixel, sample, st["seed"], dtype))
    beta = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    spec = torch.zeros_like(alive)
    n_rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for depth in range(st["max_depth"]):
        o, d, beta, radiance, alive, spec, dn = bounce(
            scene, st, o, d, beta, radiance, alive, spec, pixel, sample, depth)
        n_rays = n_rays + dn
        if not bool(torch.any(alive)):
            break
    return radiance, n_rays


def render(scene, st, frame, on_sample=None):
    """(mean radiance [H, W, 3] of ``st["samples_per_pixel"]`` waves, rays
    traced). ``on_sample(done, running_mean_hw3)`` after each wave."""
    n_pixels = st["width"] * st["height"]
    device = frame["origin"].device
    pixel = torch.arange(n_pixels, dtype=torch.int64, device=device)
    acc = torch.zeros((n_pixels, 3), dtype=frame["origin"].dtype, device=device)
    rays = 0
    spp = st["samples_per_pixel"]
    for s in range(spp):
        rad, n = wave(scene, st, frame, pixel, torch.full_like(pixel, s))
        acc = acc + torch.clamp(rad, min=0.0)
        rays += int(n)
        if on_sample is not None:
            on_sample(s + 1, (acc / (s + 1)).reshape(st["height"], st["width"], 3))
    return (acc / spp).reshape(st["height"], st["width"], 3), rays
