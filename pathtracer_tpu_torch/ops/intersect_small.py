"""Small-scene closest-hit and any-hit: the CUDA kernel and its plain version.

Port of ``pathtracer_tpu/ops/intersect_small_pallas.py``. The kernel
(``csrc/intersect_small.cu``) tests each ray against every valid triangle of a
scene of at most ``SMALL_MAX_T8`` (8-rounded) triangles, keeps the nearest
with the smallest id among equal ``t``, and returns the winner's geometric
normal and material id; the any-hit variant answers "some triangle before the
per-ray cutoff" and, when asked, "some triangle at all". It skips the lanes
that cannot hit (``lanes_to_sweep``) and sweeps the rest of each block's rays
together (see the source).

The wrappers take the plain torch version of the same function for tensors on
the CPU, and launch the kernel for tensors on a CUDA device: a CUDA tensor
never reaches the plain version. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.intersect_shortlist import _BIG_F, EPS_TRI, _inv

SMALL_MAX_T8 = 256  # largest 8-rounded triangle count the kernel serves
# The kernel's widening of its root-box test (kSlack in csrc/intersect_small.cu).
SLACK = 1.0 / 4096

# Kernel launches by entry point; only the wrappers below add to it.
launches = {"closest": 0, "occluded": 0}

# None on every path. A measurement sets it to {} to have each launch add, by
# entry point, [rays launched, rays the kernel swept (a [1] int64 tensor on
# the card)]; the rest it skipped (``lanes_to_sweep``).
lane_counts: dict | None = None


def triangle_rows(scene, rows: int) -> torch.Tensor:
    """[rows, 16] f32 triangle table: v0.xyz e1.xyz e2.xyz valid id n.xyz
    mat_id pad, row i for triangle i; rows past the scene's arrays are zero
    (valid = 0) but for their id. The kernels read this layout."""
    n = min(rows, scene.padded_tris)
    dev = scene.tri_v0.device
    tab = torch.zeros((rows, 16), dtype=torch.float32, device=dev)
    tab[:n, 0:3] = scene.tri_v0[:n]
    tab[:n, 3:6] = scene.tri_e1[:n]
    tab[:n, 6:9] = scene.tri_e2[:n]
    tab[:n, 9] = scene.tri_valid[:n].to(torch.float32)
    tab[:, 10] = torch.arange(rows, dtype=torch.float32, device=dev)
    tab[:n, 11:14] = scene.tri_n[:n]
    tab[:n, 14] = scene.tri_mat[:n].to(torch.float32)
    return tab


def small_table(scene) -> torch.Tensor:
    """[T8, 16] f32 ``triangle_rows`` table, T8 the 8-rounded triangle count:
    the plain versions' table.

    Built once per scene and kept in ``scene.cache``.
    """
    tab = scene.cache.get("small_table")
    if tab is None:
        t8 = max(8, (scene.num_tris + 7) // 8 * 8)
        if t8 > SMALL_MAX_T8:
            raise ValueError(
                f"the small-scene kernel takes at most {SMALL_MAX_T8} "
                f"triangles (8-rounded); this scene has {t8}"
            )
        tab = triangle_rows(scene, t8)
        scene.cache["small_table"] = tab
    return tab


def small_rows(scene):
    """The kernel's rows -> (rows [R, 16] f32 on the scene's device, the same
    on the host, root box [6] f32 on the host), kept in ``scene.cache``.

    The rows are ``small_table``'s valid ones, in increasing id (column 10
    keeps each one's id), so R <= SMALL_MAX_T8; the root box is lo.xyz hi.xyz
    over their vertices v0, v0 + e1, v0 + e2 (lo = 3e38 > hi = -3e38 when
    R = 0).
    """
    cached = scene.cache.get("small_rows")
    if cached is None:
        tab = small_table(scene)
        rows = tab[tab[:, 9] > 0.5].contiguous()
        v0 = rows[:, 0:3]
        pts = torch.cat([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]])
        box = torch.tensor([_BIG_F] * 3 + [-_BIG_F] * 3, dtype=torch.float32)
        if rows.shape[0]:
            box = torch.cat([pts.amin(dim=0), pts.amax(dim=0)]).cpu()
        cached = scene.cache["small_rows"] = (rows, rows.cpu(), box)
    return cached


def lanes_to_sweep(scene, o, d, t_cut=None, want_any: bool = False):
    """The lanes the kernel tests at all -> [B] bool, by its rule in torch.

    A lane is tested when its ray enters the root box (``small_rows``) before
    its bound, by the widened slab test of the tiled kernel
    (``box_enter_widened`` and ``improvable`` of csrc/ray_triangle.cuh with
    ``SLACK``): closest hit (``t_cut`` None), or any-hit with ``want_any``,
    +inf; any-hit without, the cutoff, which must also exceed ``EPS_TRI``. The
    other lanes cannot hit: they get a miss without a test.
    """
    box = small_rows(scene)[2].to(o.device)
    t_near = torch.full((o.shape[0],), -_BIG_F, device=o.device)
    t_far = torch.full((o.shape[0],), _BIG_F, device=o.device)
    for ax in range(3):
        i = _inv(d[:, ax])
        t0 = (box[ax] - o[:, ax]) * i
        t1 = (box[3 + ax] - o[:, ax]) * i
        t_near = torch.maximum(t_near, torch.minimum(t0, t1))
        t_far = torch.minimum(t_far, torch.maximum(t0, t1))
    e = torch.clamp(t_near, min=0.0)
    entered = (t_far >= e * (1.0 - SLACK)) & (t_far > 0.0) & (box[0] <= box[3])
    if t_cut is None or want_any:
        return entered & (e < float("inf"))
    return entered & (e * (1.0 - SLACK) < t_cut) & (t_cut > EPS_TRI)


def _sweep_plain(tab, o, d):
    from pathtracer_tpu_torch.ops.intersect import moller_trumbore

    return moller_trumbore(o, d, tab[:, 0:3], tab[:, 3:6], tab[:, 6:9],
                           tab[:, 9] > 0.5)


def closest_tri_small_plain(scene, o, d):
    """Plain torch version of the closest-hit kernel -> (t [B] f32,
    tri_id [B] i32, n_geo [B, 3] f32, mat_id [B] i32)."""
    tab = small_table(scene)
    t, _ = _sweep_plain(tab, o, d)
    best_t, best = torch.min(t, dim=1)
    hit = torch.isfinite(best_t)
    row = tab[best]
    tri_id = torch.where(hit, best, -1).to(torch.int32)
    n_geo = torch.where(hit[:, None], row[:, 11:14], 0.0)
    mat_id = torch.where(hit, row[:, 14], 0.0).to(torch.int32)
    return best_t, tri_id, n_geo, mat_id


def occluded_tri_small_plain(scene, o, d, t_cut, want_any: bool = False):
    """Plain torch version of the any-hit kernel -> (occluded [B] bool,
    hit_any [B] bool, or None unless ``want_any``)."""
    t, ok = _sweep_plain(small_table(scene), o, d)
    occ = torch.any(ok & (t < t_cut[:, None]), dim=1)
    return occ, (torch.any(ok, dim=1) if want_any else None)


def check_rays(scene, o, d, *per_ray):
    """Refuse what a kernel cannot take: rays ``o``, ``d`` [B, 3] and
    ``per_ray`` [B] tensors must be contiguous float32 on the scene's CUDA
    device, and none may require grad: a kernel reads raw pointers and has no
    backward, so it would cut the graph without a word (as in the JAX
    package, where ``pallas_call`` has no VJP). Material gradients never pass
    through a kernel: they reach the materials through gathers by id."""
    if any(x.requires_grad for x in (o, d, *per_ray)):
        raise ValueError(
            "the kernel has no backward: rays or cutoffs that require grad would "
            "lose their gradient here; pass them detached"
        )
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {dev}")
    b = o.shape[0]
    for x in (o, d, *per_ray):
        if x.device != dev or scene.tri_v0.device != dev:
            raise ValueError("rays and scene must lie on one CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, not {x.dtype}")
        if x.shape[0] != b or not x.is_contiguous():
            raise ValueError("rays must be contiguous with one batch size")
    if o.shape != (b, 3) or d.shape != (b, 3) or any(x.dim() != 1 for x in per_ray):
        raise ValueError(f"rays must be [B, 3] and per-ray values [B], got "
                         f"{[tuple(x.shape) for x in (o, d, *per_ray)]}")
    check_batch(b)


def check_batch(b: int) -> None:
    """The C entry points take the ray count as an int32."""
    if b >= 2**31:
        raise ValueError(f"batch of {b} rays exceeds the kernel's int32 count")


def _ptr(x) -> int:
    return x.data_ptr()


def _swept(entry: str, o) -> int | None:
    """The counter the launch adds its swept lanes to, when ``lane_counts``
    is on."""
    if lane_counts is None:
        return None
    counts = lane_counts.setdefault(
        entry, [0, torch.zeros(1, dtype=torch.int64, device=o.device)])
    counts[0] += o.shape[0]
    return _ptr(counts[1])


def closest_tri_small(scene, o, d):
    """Closest hit with winner attributes -> (t [B], tri_id [B] i32,
    n_geo [B, 3], mat_id [B] i32); a miss gives inf, -1, 0, 0."""
    if o.device.type == "cpu":
        return closest_tri_small_plain(scene, o, d)
    check_rays(scene, o, d)
    from pathtracer_tpu_torch import kernels

    rows, rows_host, box = small_rows(scene)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    tri_id = torch.empty(b, dtype=torch.int32, device=o.device)
    n_geo = torch.empty((b, 3), dtype=torch.float32, device=o.device)
    mat_id = torch.empty(b, dtype=torch.int32, device=o.device)
    if b == 0:
        return t, tri_id, n_geo, mat_id
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_small_closest(
            _ptr(o), _ptr(d), _ptr(rows), _ptr(rows_host), _ptr(box), rows.shape[0], b,
            _ptr(t), _ptr(tri_id), _ptr(n_geo), _ptr(mat_id), _swept("closest", o),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "small closest-hit kernel")
    launches["closest"] += 1
    return t, tri_id, n_geo, mat_id


def occluded_tri_small(scene, o, d, t_cut, want_any: bool = False):
    """Shadow occlusion -> (occluded [B] bool: some triangle strictly before
    ``t_cut``; hit_any [B] bool when ``want_any``, else None)."""
    if o.device.type == "cpu":
        return occluded_tri_small_plain(scene, o, d, t_cut, want_any)
    check_rays(scene, o, d, t_cut)
    from pathtracer_tpu_torch import kernels

    rows, rows_host, box = small_rows(scene)
    b = o.shape[0]
    occ = torch.empty(b, dtype=torch.uint8, device=o.device)
    hit_any = torch.empty(b, dtype=torch.uint8, device=o.device) if want_any else None
    if b == 0:
        return occ.bool(), (hit_any.bool() if want_any else None)
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_small_occluded(
            _ptr(o), _ptr(d), _ptr(t_cut), _ptr(rows), _ptr(rows_host), _ptr(box),
            rows.shape[0], b, _ptr(occ), _ptr(hit_any) if want_any else None,
            _swept("occluded", o), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "small any-hit kernel")
    launches["occluded"] += 1
    return occ.bool(), (hit_any.bool() if want_any else None)
