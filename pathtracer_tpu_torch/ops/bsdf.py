"""BSDF evaluation and sampling (masked, branch-free).

Port of ``pathtracer_tpu/ops/bsdf.py``. Every lobe is evaluated for every
lane and combined with ``torch.where`` masks. Lobe semantics (the reference's
in compat mode):

- dielectric (illum == 7): Schlick-Fresnel reflect-or-refract, eta from Ni
  (hardcoded 2.5 in compat);
- mirror (Ns > 500): perfect reflection;
- glossy (any Ks > 0): cosine-sampled direction scored by a Phong lobe
  (Ns exponent), zero below the reflection horizon;
- diffuse: Lambertian Kd / pi, cosine-weighted sampling.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-20)[:, None]


def reflect(d, n):
    """Mirror reflection of direction d about normal n (w - 2(w.n)n)."""
    return d - 2.0 * _dot(d, n)[:, None] * n


def tangent_frame(n):
    """Branchless orthonormal frame from normals [B, 3] (Duff et al.)."""
    s = torch.where(n[:, 2] < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], dim=-1
    )
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def sample_cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere sample about normals [B, 3].

    theta = acos(sqrt(xi2)), phi = 2 pi xi1; pdf = cos(theta) / pi.
    Returns (direction [B, 3], pdf [B]).
    """
    phi = (2.0 * PI) * u1
    cos_t = torch.sqrt(u2)
    sin_t = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    local = torch.stack(
        [torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1
    )
    t, bt = tangent_frame(n)
    d = local[:, 0:1] * t + local[:, 1:2] * bt + local[:, 2:3] * n
    pdf = cos_t / PI
    return d, pdf


def _phong_spec(ks, ns, q):
    return ks * ((ns + 2.0) / (2.0 * PI) * torch.pow(torch.clamp(q, min=1e-20), ns))[
        :, None
    ]


def eval_phong(ks, ns, w_in, w_out, n, kd):
    """Reference Phong lobe used for NEE: q = reflect(w_in).w_out;
    q < 0 -> -q * Kd / pi; else Ks (n+2)/(2 pi) q^n.

    w_in is the incoming ray direction (pointing into the surface).
    """
    q = _dot(reflect(w_in, n), w_out)
    diff = (-q)[:, None] * kd / PI
    return torch.where((q < 0.0)[:, None], diff, _phong_spec(ks, ns, q))


def eval_phong_bounce(ks, ns, w_in, w_out, n):
    """Phong lobe as used for the sampled bounce: zero below the horizon
    (q < 0) instead of the diffuse fallback. Returns (f [B, 3], q [B])."""
    q = _dot(reflect(w_in, n), w_out)
    return torch.where((q < 0.0)[:, None], 0.0, _phong_spec(ks, ns, q)), q


def eval_beckmann(ks, ns, w_in, w_out, n, alpha_override: float = 0.0):
    """Beckmann microfacet BRDF for glossy lanes (opt-in).

    h = normalize(-w_in + w_out), Beckmann NDF D(h), Smith G1*G1 shadowing,
    f = Ks * D * G / (4 cos_i cos_o). Roughness comes from the Phong
    exponent (alpha = sqrt(2 / (Ns + 2))) unless ``alpha_override`` > 0.

    w_in points into the surface; returns [B, 3] (zero below the horizon).
    """
    s = -w_in
    cos_i = _dot(s, n)
    cos_o = _dot(w_out, n)
    h = _normalize(s + w_out)
    cos_h = torch.clamp(_dot(h, n), 1e-6, 1.0)

    if alpha_override > 0.0:
        alpha = torch.full_like(cos_h, alpha_override)
    else:
        alpha = torch.sqrt(2.0 / (ns + 2.0))
    a2 = alpha * alpha

    cos2 = cos_h * cos_h
    tan2 = (1.0 - cos2) / cos2
    d_ndf = torch.exp(-tan2 / a2) / (PI * a2 * cos2 * cos2)

    def g1(cos_v):
        cv = torch.clamp(torch.abs(cos_v), 1e-6, 1.0)
        a = cv / (alpha * torch.sqrt(torch.clamp(1.0 - cv * cv, min=1e-12)))
        # Walter et al. rational approximation of the Beckmann G1.
        g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
        return torch.where(a < 1.6, g, 1.0)

    g = g1(cos_i) * g1(cos_o)
    denom = torch.clamp(4.0 * torch.abs(cos_i) * torch.abs(cos_o), min=1e-6)
    f = (d_ndf * g / denom)[:, None] * ks
    above = (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(above[:, None], f, 0.0)


def fresnel_schlick(cos_i, eta_i, eta_t):
    """Schlick's approximation."""
    r = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r * r
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos_i, 5.0)


def dielectric_directions(d, n, eta_mat, compat_fixed_eta: bool):
    """Refraction bookkeeping for illum==7 lanes.

    Returns (r_theta [B], refract_dir [B, 3], tir [B]): the Schlick
    reflection probability, the refracted direction and the lanes with
    total internal reflection (k < 0). d: incoming direction, n: normal,
    eta_mat: material Ni per lane.
    """
    eta = torch.full_like(eta_mat, 2.5) if compat_fixed_eta else eta_mat
    cos_raw = torch.clamp(_dot(d, n), -1.0, 1.0)
    entering = cos_raw < 0.0
    cos_i = torch.abs(cos_raw)
    eta_i = torch.where(entering, 1.0, eta)
    eta_t = torch.where(entering, eta, 1.0)
    # Refraction normal points against the ray (flipped when exiting).
    n_ref = torch.where(entering[:, None], n, -n)

    r_theta = fresnel_schlick(cos_i, eta_i, eta_t)
    ratio = eta_i / eta_t
    k = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    # The reference clamps k into [0, 1] instead of treating k < 0 as total
    # internal reflection; the clamped direction is kept for parity but
    # renormalized.
    refr = (
        ratio[:, None] * d
        + (ratio * cos_i - torch.sqrt(torch.clamp(k, 0.0, 1.0)))[:, None] * n_ref
    )
    refr = _normalize(refr)
    tir = k < 0.0
    return r_theta, refr, tir
