"""Closest-hit and occlusion queries against the scene.

Port of ``pathtracer_tpu/ops/intersect.py``:

- Moller-Trumbore ray/triangle tests (eps 1e-8, the JAX operation order);
- ``closest_tri_brute``, the plain torch sweep over every triangle, tiled
  over the triangle axis so the [B, tile] intermediates stay bounded;
- the CUDA small-scene kernel (``ops.intersect_small``) for scenes of at
  most 256 triangles on a CUDA device;
- the block shortlist for scenes of >= 2048 padded triangles: the CUDA
  kernel (``ops.intersect_shortlist_kernel``) on a CUDA device, its plain
  torch twin (``ops.intersect_shortlist``) on the CPU;
- the CUDA tiled kernel (``ops.intersect_tiled``, ``intersector="pallas"``)
  and the CUDA cluster cull (``ops.intersect_cluster``,
  ``intersector="cluster"``), closest hit and any-hit each, with their plain
  versions on the CPU;
- the BVH oracle (``ops.bvh_traverse``, ``intersector="bvh"``), a walk of
  the scene's BVH in torch ops, whose shadow rays take its closest core;
- analytic unit sphere/cube primitives;
- winner attributes and materials picked by indexing with the winning
  triangle and material ids.

The JAX package's TPU mechanisms (one-hot matmul extraction, the transposed
[T, B] sweep, tile-size rules, ``PT_*`` knobs) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.ops import bvh_traverse, intersect_cluster
from pathtracer_tpu_torch.ops import intersect_shortlist as shortlist
from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as shortlist_kernel
from pathtracer_tpu_torch.ops import intersect_small, intersect_tiled
from pathtracer_tpu_torch.ops.gather import gather_rows
from pathtracer_tpu_torch.utils.profiling import span

EPS_TRI = 1e-8  # the reference's ray-triangle epsilon
INF = float("inf")

# Triangles per tile of the plain sweep: [B, tile] f32 intermediates.
BRUTE_TILE = 256

# Padded triangle count at which ``auto`` switches to the block shortlist,
# as the JAX package's does.
SHORTLIST_MIN_T = 2048

# ``auto``'s route on a CUDA scene above the small kernel's limit and below
# SHORTLIST_MIN_T padded triangles: the tiled kernel, the fastest by median
# of ten paired renders of the 1,152-padded-triangle stand-in on the H100
# against the cluster and shortlist kernels and the brute sweep (PERF.md).
BAND_CUDA = "pallas"

# (t [B], tri_id [B] i64) of the closest triangle, by route.
_CLOSEST = {
    "shortlist": shortlist.closest_tri_shortlist,
    "shortlist_pallas": shortlist_kernel.closest_tri_shortlist_kernel,
    "pallas": intersect_tiled.closest_tri_tiled,
    "cluster": intersect_cluster.closest_tri_cluster,
    "bvh": bvh_traverse.closest_tri_bvh,
}
# Any-hit entry points that also answer hit_any when asked ->
# (occluded, hit_any or None).
_OCCLUDED_ANY = {
    "small_pallas": intersect_small.occluded_tri_small,
    "pallas": intersect_tiled.occluded_tri_tiled,
    "cluster": intersect_cluster.occluded_tri_cluster,
}
# Any-hit entry points without hit_any; under direct lighting these routes
# answer occlusion with their closest-hit core, as in the JAX package.
_SHORTLIST_OCCLUDED = {
    "shortlist": shortlist.occluded_tri_shortlist,
    "shortlist_pallas": shortlist_kernel.occluded_tri_shortlist_kernel,
}


@dataclasses.dataclass
class Hit:
    """SoA hit record for a ray batch."""

    hit: torch.Tensor  # [B] bool
    t: torch.Tensor  # [B] f32 (inf on miss)
    point: torch.Tensor  # [B, 3] f32
    normal: torch.Tensor  # [B, 3] f32 geometric normal
    normal_shade: torch.Tensor  # [B, 3] f32 shading normal
    mat_id: torch.Tensor  # [B] i64
    tri_id: torch.Tensor  # [B] i64 (-1 for miss / analytic prim)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


# [3] unit vectors by (axis, dtype, device), built on the device (a copy of
# host values would wait for the card) and kept.
_UNIT: dict = {}


def unit_axis(axis: int, like) -> torch.Tensor:
    """The [3] unit vector along ``axis`` in ``like``'s dtype and device.
    While the device's stream is being captured into a CUDA graph a new one
    is built in the graph (its values exist only once the graph runs) and is
    not kept."""
    key = (axis, like.dtype, like.device)
    u = _UNIT.get(key)
    if u is None:
        u = torch.eye(3, dtype=like.dtype, device=like.device)[axis]
        if not (like.is_cuda and torch.cuda.is_current_stream_capturing()):
            _UNIT[key] = u
    return u


def mt_components(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                  e2x, e2y, e2z, valid):
    """Moller-Trumbore on broadcastable ray and triangle components ->
    (t, ok), t = inf where not accepted.

    Componentwise, in the operation order of the JAX package's sweeps, so
    that ``t`` agrees bit for bit wherever no FMA is contracted. The brute
    sweep and the shortlist twin (``ops.intersect_shortlist``) both call it,
    so their ``t`` are bit-equal.
    """
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = torch.abs(det) > EPS_TRI
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    # s = o - v0
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    # qvec = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS_TRI)
        & valid
    )
    return torch.where(ok, t, INF), ok


def moller_trumbore(o, d, v0, e1, e2, valid):
    """Rays [B, 3] x triangles [T, 3] -> (t [B, T], ok [B, T])."""
    return mt_components(
        o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3],
        v0[None, :, 0], v0[None, :, 1], v0[None, :, 2],
        e1[None, :, 0], e1[None, :, 1], e1[None, :, 2],
        e2[None, :, 0], e2[None, :, 1], e2[None, :, 2],
        valid[None, :],
    )


def _tiles(scene):
    """(v0, e1, e2, valid, first id) per triangle tile of the sweep."""
    n = (scene.num_tris + 7) // 8 * 8
    for s in range(0, n, BRUTE_TILE):
        e = min(s + BRUTE_TILE, n)
        yield (scene.tri_v0[s:e], scene.tri_e1[s:e], scene.tri_e2[s:e],
               scene.tri_valid[s:e], s)


def closest_tri_brute(scene, o, d):
    """Closest triangle hit by the plain sweep -> (t [B], tri_id [B] i64).

    A strict ``<`` across tiles and ``torch.min``'s first index within one
    keep the smallest id among equal ``t``, as the JAX sweep does.
    """
    best_t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    best_id = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for v0, e1, e2, valid, first in _tiles(scene):
        t, _ = moller_trumbore(o, d, v0, e1, e2, valid)
        tile_t, tile_arg = torch.min(t, dim=1)
        better = tile_t < best_t
        best_t = torch.where(better, tile_t, best_t)
        best_id = torch.where(better, tile_arg + first, best_id)
    return best_t, best_id


def _occluded_tri_brute(scene, o, d, t_cut):
    """(occluded [B], hit_any [B]) by the plain sweep."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    hit_any = torch.zeros_like(occ)
    for v0, e1, e2, valid, _ in _tiles(scene):
        t, ok = moller_trumbore(o, d, v0, e1, e2, valid)
        occ = occ | torch.any(ok & (t < t_cut[:, None]), dim=1)
        hit_any = hit_any | torch.any(ok, dim=1)
    return occ, hit_any


def resolve_intersector(settings, scene) -> str:
    """Concrete intersector for ``settings.intersector`` (resolving "auto").

    ``auto`` (the JAX names kept for settings parity): at
    ``SHORTLIST_MIN_T`` padded triangles and above, the CUDA shortlist
    kernel ("shortlist_pallas") on a CUDA scene and its plain torch twin
    ("shortlist") on the CPU, as JAX takes its kernel on the accelerator and
    its XLA twin elsewhere. Below, on a CUDA scene, the small-scene kernel
    ("small_pallas") for at most ``SMALL_MAX_T8`` 8-rounded triangles and
    ``BAND_CUDA`` above that; on the CPU the plain "brute" sweep, as JAX.
    "pallas" (the tiled kernel) and "cluster" resolve on any scene: on the
    CPU their wrappers run the plain versions, as "small_pallas"'s does;
    "bvh" (torch ops) resolves on any scene too. An explicit "shortlist_pallas" needs a CUDA scene: on the CPU it raises
    rather than run the twin.
    """
    method = settings.intersector
    cuda = scene.device.type == "cuda"
    if method == "auto":
        if scene.padded_tris >= SHORTLIST_MIN_T:
            return "shortlist_pallas" if cuda else "shortlist"
        if not cuda:
            return "brute"
        t8 = (scene.num_tris + 7) // 8 * 8
        return "small_pallas" if t8 <= intersect_small.SMALL_MAX_T8 else BAND_CUDA
    if method not in ("brute", "small_pallas", *_CLOSEST):
        raise ValueError(f"unknown intersector {method!r}")
    if method == "shortlist_pallas" and not cuda:
        raise ValueError(
            "intersector='shortlist_pallas' is the CUDA kernel and needs a CUDA "
            f"scene, not {scene.device}; 'shortlist' is its plain torch twin"
        )
    return method


def occluded_before(scene, o, d, t_max, settings, rel_eps: float = 1e-3):
    """Shadow visibility -> (occluded [B] bool, hit_any [B] bool).

    ``occluded``: some surface lies strictly before ``t_max * (1 - rel_eps)``
    along the ray; ``hit_any``: the ray hits anything at all (the
    reference's ``directLightingOnly`` break keys on this).
    """
    with span("pt.intersect"):
        t_cut = t_max * (1.0 - rel_eps)
        method = resolve_intersector(settings, scene)
        if scene.num_tris == 0:
            occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
            hit_any = occ
        elif method in _OCCLUDED_ANY:
            occ, hit_any = _OCCLUDED_ANY[method](
                scene, o, d, t_cut, want_any=settings.direct_lighting_only
            )
            if not settings.direct_lighting_only:
                hit_any = occ  # not computed; consumed only by direct lighting
        elif method in _SHORTLIST_OCCLUDED and not settings.direct_lighting_only:
            occ = _SHORTLIST_OCCLUDED[method](scene, o, d, t_cut)
            hit_any = occ  # consumed only by direct lighting, handled below
        elif method in _CLOSEST:
            # Direct lighting consumes "the shadow ray hit anything", which the
            # shortlist's cutoff-bounded any-hit loop does not compute: the
            # closest-hit core answers both, as in the JAX package. The BVH
            # oracle has no any-hit walk and always takes this branch.
            t_tri, _ = _CLOSEST[method](scene, o, d)
            occ, hit_any = t_tri < t_cut, torch.isfinite(t_tri)
        else:
            occ, hit_any = _occluded_tri_brute(scene, o, d, t_cut)

        if scene.num_analytic > 0:
            t_a, _, _, _ = intersect_analytic(scene, o, d)
            occ = occ | (t_a < t_cut)
            hit_any = hit_any | torch.isfinite(t_a)
        return occ, hit_any


def _xform(m, x, w: bool):
    """Row i of ``m[:3, :3] @ x`` (+ ``m[:3, 3]`` when ``w``), elementwise."""
    cols = []
    for i in range(3):
        c = x[:, 0] * m[i, 0] + x[:, 1] * m[i, 1] + x[:, 2] * m[i, 2]
        cols.append(c + m[i, 3] if w else c)
    return torch.stack(cols, dim=-1)


def intersect_analytic(scene, o, d):
    """Closest analytic sphere/cube hit -> (t [B], point, normal, mat [B]).

    Rays go to object space by the primitive's inverse CTM; normals come
    back by its inverse transpose. Object space: sphere radius 0.5, cube
    +-0.5. The 3x3 transforms are written elementwise, so no matmul (and no
    TF32) is involved.
    """
    b = o.shape[0]
    best_t = torch.full((b,), INF, dtype=o.dtype, device=o.device)
    best_p = torch.zeros_like(o)
    best_n = torch.zeros_like(o)
    best_m = torch.zeros(b, dtype=torch.int64, device=o.device)
    eps = 1e-6
    for idx in range(scene.num_analytic):
        inv = scene.prim_ctm_inv[idx]
        oo = _xform(inv, o, True)
        od = _xform(inv, d, False)  # unnormalized: object t == world t

        # Unit sphere (radius 0.5).
        a = _dot(od, od)
        bq = 2.0 * _dot(od, oo)
        c = _dot(oo, oo) - 0.25
        discr = bq * bq - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(discr, min=0.0))
        t1 = (-bq - sq) / (2.0 * a)
        t2 = (-bq + sq) / (2.0 * a)
        t_sph = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, INF))
        t_sph = torch.where(discr >= 0.0, t_sph, INF)
        p_sph = oo + torch.where(torch.isfinite(t_sph), t_sph, 0.0)[:, None] * od
        n_sph = p_sph  # gradient of x^2+y^2+z^2, normalized later

        # Unit cube (slabs, face normals).
        safe_od = torch.where(torch.abs(od) > 1e-12, od, 1e-12)
        t_lo = (-0.5 - oo) / safe_od
        t_hi = (0.5 - oo) / safe_od
        t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
        t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
        hit_cube = (t_far >= t_near) & (t_far > eps)
        t_cube = torch.where(
            hit_cube, torch.where(t_near > eps, t_near, t_far), INF
        )
        p_cube = oo + torch.where(torch.isfinite(t_cube), t_cube, 0.0)[:, None] * od
        # Face normal: axis of the largest |coordinate|.
        ax = torch.argmax(torch.abs(p_cube), dim=-1)
        n_cube = torch.sign(torch.gather(p_cube, 1, ax[:, None])) * (
            torch.nn.functional.one_hot(ax, 3).to(o.dtype)
        )

        is_sphere = scene.prim_kind[idx] == 0
        t_obj = torch.where(is_sphere, t_sph, t_cube)
        n_obj = torch.where(is_sphere, n_sph, n_cube)

        # Back to world space (miss lanes: finite placeholder).
        t_w = torch.where(torch.isfinite(t_obj), t_obj, 0.0)
        p_w = o + t_w[:, None] * d
        n_w = _xform(inv.T, n_obj, False)  # (ctm^-1)^T n
        n_w = n_w / torch.clamp(torch.sqrt(_dot(n_w, n_w)), min=1e-20)[:, None]

        better = t_obj < best_t
        best_t = torch.where(better, t_obj, best_t)
        best_p = torch.where(better[:, None], p_w, best_p)
        best_n = torch.where(better[:, None], n_w, best_n)
        best_m = torch.where(better, scene.prim_mat[idx], best_m)
    return best_t, best_p, best_n, best_m


def material_lookup(scene, mat_id):
    """Material record dict for [B] material ids, by indexing (the fields
    inverse rendering fits through ``gather_rows``)."""
    return {
        "Kd": gather_rows(scene.mat_Kd, mat_id),
        "Ks": gather_rows(scene.mat_Ks, mat_id),
        "Ke": gather_rows(scene.mat_Ke, mat_id),
        "Ns": gather_rows(scene.mat_Ns, mat_id),
        "Ni": scene.mat_Ni[mat_id],
        "illum": scene.mat_illum[mat_id],
    }


def _cross(a, b):
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=-1,
    )


def _vn_shading_normal(o, d, v0, e1, e2, vn, n_geo):
    """Barycentric-interpolated shading normal from the winners' triangle
    data; ``vn`` is [B, 9] (three vertex normals)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) > EPS_TRI, det, 1.0)
    s = o - v0
    u = _dot(s, pvec) * inv_det
    qvec = _cross(s, e1)
    v = _dot(d, qvec) * inv_det
    n = (
        (1.0 - u - v)[:, None] * vn[:, 0:3]
        + u[:, None] * vn[:, 3:6]
        + v[:, None] * vn[:, 6:9]
    )
    norm = torch.sqrt(_dot(n, n))[:, None]
    n = n / torch.clamp(norm, min=1e-20)
    return torch.where(norm > 1e-12, n, n_geo)


def closest_hit(scene, o, d, settings):
    """Scene closest hit -> (Hit, material dict).

    Miss lanes are sanitized (unit-z normal, Ni = 1, zero material) so the
    masked BSDF math downstream stays finite.
    """
    with span("pt.intersect"):
        method = resolve_intersector(settings, scene)
        b = o.shape[0]
        if scene.num_tris == 0:
            t_tri = torch.full((b,), INF, dtype=o.dtype, device=o.device)
            tri_id = torch.full((b,), -1, dtype=torch.int64, device=o.device)
            n_geo = torch.zeros_like(o)
            mat_id = torch.zeros(b, dtype=torch.int64, device=o.device)
        elif method == "small_pallas":
            t_tri, tri_id, n_geo, mat_id = intersect_small.closest_tri_small(
                scene, o, d
            )
            tri_id, mat_id = tri_id.to(torch.int64), mat_id.to(torch.int64)
        else:
            closest = _CLOSEST.get(method, closest_tri_brute)
            t_tri, tri_id = closest(scene, o, d)
            tri_hit = tri_id >= 0
            win = torch.clamp(tri_id, min=0)
            n_geo = torch.where(tri_hit[:, None], scene.tri_n[win], 0.0)
            mat_id = torch.where(tri_hit, scene.tri_mat[win], 0)
        if settings.use_vertex_normals:
            win = torch.clamp(tri_id, min=0)
            n_shade = _vn_shading_normal(
                o, d, scene.tri_v0[win], scene.tri_e1[win], scene.tri_e2[win],
                scene.tri_vn[win].reshape(b, 9), n_geo,
            )
        else:
            n_shade = n_geo

        # Miss lanes keep t = inf but get finite coordinates.
        t_pt = torch.where(torch.isfinite(t_tri), t_tri, 0.0)
        point = o + t_pt[:, None] * d

        if scene.num_analytic > 0:
            t_a, p_a, n_a, m_a = intersect_analytic(scene, o, d)
            use_a = t_a < t_tri
            t_tri = torch.where(use_a, t_a, t_tri)
            point = torch.where(use_a[:, None], p_a, point)
            n_geo = torch.where(use_a[:, None], n_a, n_geo)
            n_shade = torch.where(use_a[:, None], n_a, n_shade)
            mat_id = torch.where(use_a, m_a, mat_id)
            tri_id = torch.where(use_a, -1, tri_id)

        hit = torch.isfinite(t_tri)
        mat = {
            k: torch.where(hit[:, None] if v.dim() == 2 else hit, v, 0.0)
            for k, v in material_lookup(scene, mat_id).items()
        }
        # Sanitize miss lanes.
        unit_z = unit_axis(2, o)
        n_geo = torch.where(hit[:, None], n_geo, unit_z)
        n_shade = torch.where(hit[:, None], n_shade, unit_z)
        mat["Ni"] = torch.where(hit, mat["Ni"], 1.0)

        return (
            Hit(
                hit=hit,
                t=t_tri,
                point=point,
                normal=n_geo,
                normal_shade=n_shade,
                mat_id=mat_id,
                tri_id=tri_id,
            ),
            mat,
        )


def intersect(scene, o, d, settings) -> Hit:
    """Scene closest hit: triangles and analytic primitives, merged by t."""
    return closest_hit(scene, o, d, settings)[0]
