"""Emissive-area-light sampling for next-event estimation.

Port of ``pathtracer_tpu/ops/lights.py``. The emissive table is a flat index
list; two estimators:

- ``count`` (compat): weight = 1 / num_emissive_triangles, no area term —
  the reference estimator and hence its golden images;
- ``area``: area-weighted triangle selection via the emissive-area CDF,
  weight = total_area.

The sampled light's attributes are picked by indexing with the chosen
triangle id (the JAX package uses a one-hot matmul, cheap on the TPU).
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.gather import gather_rows


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def sample_triangle_barycentric(u1, u2):
    """Uniform barycentrics via (1 - sqrt(u), v sqrt(u))."""
    su = torch.sqrt(u1)
    b0 = 1.0 - su
    b1 = u2 * su
    return b0, b1


def emissive_cdf(scene):
    """(cdf [E], total area, 0-dim) of the area estimator's triangle
    choice; the padded entries add no area."""
    e_pad = scene.emissive_tri.shape[0]
    idx_valid = torch.arange(e_pad, device=scene.emissive_area.device) < scene.num_emissive
    areas = torch.where(idx_valid, scene.emissive_area, 0.0)
    total = torch.clamp(torch.sum(areas), min=1e-20)
    return torch.cumsum(areas, dim=0) / total, total


def _choose_emissive(scene, x, u_choice, compat_count_pdf: bool):
    """Pick an emissive-table index per lane -> (j [B] i64, weight [B])."""
    n_emissive = max(scene.num_emissive, 1)
    n_f = float(n_emissive)  # a scalar argument: exact in x's float type
    if compat_count_pdf:
        j = torch.clamp((u_choice * n_f).to(torch.int64), max=n_emissive - 1)
        weight = torch.full((x.shape[0],), 1.0, dtype=x.dtype, device=x.device) / n_f
    else:
        cdf, total = emissive_cdf(scene)
        j = torch.searchsorted(cdf, u_choice.contiguous(), right=True)
        j = torch.clamp(j, max=n_emissive - 1)
        weight = torch.full((x.shape[0],), 1.0, dtype=x.dtype, device=x.device) * total
    return j, weight


def _light_triangle(scene, j):
    """(v0, p1, p2) of emissive-table entries j."""
    tri = scene.emissive_tri[j]
    v0 = scene.tri_v0[tri]
    return tri, v0, v0 + scene.tri_e1[tri], v0 + scene.tri_e2[tri]


def sample_area_lights(scene, x, u_choice, u1, u2, compat_count_pdf: bool):
    """Sample a point on the emissive set for each shading point x [B, 3].

    Returns (direction [B, 3], weight [B]); the NEE contribution is
    ``beta * Ke_hit * brdf * cos_l * cos_s / d^2 * weight``.
    """
    j, weight = _choose_emissive(scene, x, u_choice, compat_count_pdf)
    _, v0, p1, p2 = _light_triangle(scene, j)

    b0, b1 = sample_triangle_barycentric(u1, u2)
    # (b0, b1) onto (p0, p1), remainder on p2.
    p = b0[:, None] * v0 + b1[:, None] * p1 + (1.0 - b0 - b1)[:, None] * p2

    direction = p - x
    direction = direction / torch.clamp(_norm(direction), min=1e-20)[:, None]
    return direction, weight


def sample_area_lights_detailed(scene, x, u_choice, u1, u2,
                                compat_count_pdf: bool):
    """Light sample carrying the sampled point's own attributes.

    Returns (direction [B, 3], weight [B], point [B, 3], normal [B, 3],
    Ke [B, 3], t_target [B]). The fast-shadow NEE path uses these known
    light attributes, so the shadow ray needs only an occlusion test.
    """
    j, weight = _choose_emissive(scene, x, u_choice, compat_count_pdf)
    tri, v0, p1, p2 = _light_triangle(scene, j)
    n_l = scene.tri_n[tri]
    ke = gather_rows(scene.mat_Ke, scene.tri_mat[tri])

    b0, b1 = sample_triangle_barycentric(u1, u2)
    p = b0[:, None] * v0 + b1[:, None] * p1 + (1.0 - b0 - b1)[:, None] * p2

    to_p = p - x
    t_target = _norm(to_p)
    direction = to_p / torch.clamp(t_target, min=1e-20)[:, None]
    return direction, weight, p, n_l, ke, t_target
