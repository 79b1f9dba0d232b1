"""Regenerative wavefront renderer.

Port of ``pathtracer_tpu/ops/wavefront.py``. A pool of B lanes stays busy:
when a lane's path ends, it folds the path's radiance into its chunk
accumulator and either re-aims in place (same pixel, next sample of its
chunk) or, once the chunk is done, flushes the chunk's sum into the image
and takes the next chunk of (pixel, K samples) from a global id counter.

The id space, the spawn chunk K, the Morton spawn order, the per-path
clamp and the ray sort are the JAX package's, so the set of traced paths,
and with the counter-based RNG each path's radiance, are the same. What
differs: every lane whose chunk finished flushes in the same iteration with
one ``index_add_`` (the JAX package holds finished lanes and flushes at most
one per 4-lane group per iteration, a TPU scatter-cost workaround), ids and
counts are int64, and the sort carries ``depth`` as its own tensor (JAX packs
it into 8 bits of a flags word, which ``max_depth >= 256`` overflows). Only
the iteration count and the order of float summation into the image differ.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import bounce_core
from pathtracer_tpu_torch.ops.intersect import resolve_intersector
from pathtracer_tpu_torch.utils.profiling import span

# Ray-sort grid cells per axis (16 -> a 12-bit Morton cell), the JAX
# package's default.
_SORT_GRID = 16.0


def _spread3(x, bits: int = 3):
    """Spread the low ``bits`` bits of ``x`` with 2-bit gaps (3D Morton)."""
    r = x & 1
    for i in range(1, bits):
        r = r | (((x >> i) & 1) << (3 * i))
    return r


def _sort_key(o, d, alive, lo, inv_extent):
    """[B] int64 coherence key, equal to the JAX package's u32 key in its
    default cell-major order: the dead bit | the Morton cell of the ray
    origin on a _SORT_GRID^3 grid over the scene box | the 3-bit direction
    octant.

    Lanes sorted by it fill the shortlist's ray blocks with rays that share
    a cell and an octant; dead lanes gather at the end, where their blocks
    pass the kernel's root pre-test in one step.
    """
    g = _SORT_GRID
    bits = max(1, int(g - 1).bit_length())
    cell = torch.clamp((o - lo) * inv_extent * g, 0.0, g - 1.0).to(torch.int64)
    morton = (
        (_spread3(cell[:, 0], bits) << 2)
        | (_spread3(cell[:, 1], bits) << 1)
        | _spread3(cell[:, 2], bits)
    )
    octant = ((d[:, 0] < 0.0).to(torch.int64) * 4
              + (d[:, 1] < 0.0).to(torch.int64) * 2
              + (d[:, 2] < 0.0).to(torch.int64))
    dead = (~alive).to(torch.int64)
    return (dead << (3 * bits + 3)) | (morton << 3) | octant


def _sort_bounds(scene):
    """(lo [3], 1 / extent [3]) of the scene's valid triangles: the sort
    grid's box."""
    pts = torch.cat([scene.tri_v0, scene.tri_v0 + scene.tri_e1,
                     scene.tri_v0 + scene.tri_e2])
    valid3 = scene.tri_valid.repeat(3)[:, None]
    lo = torch.where(valid3, pts, torch.inf).amin(dim=0)
    hi = torch.where(valid3, pts, -torch.inf).amax(dim=0)
    return lo, 1.0 / torch.clamp(hi - lo, min=1e-12)


def sort_rays_on(settings, scene) -> bool:
    """Whether the pool sorts its lanes: ``ray_sort="on"``, or ``"auto"``
    with a shortlist or the cluster intersector, as in the JAX package (their
    ray blocks gain from coherence; the brute sweeps cost the same in any
    lane order)."""
    if settings.ray_sort not in ("auto", "on", "off"):
        raise ValueError(f"unknown ray_sort {settings.ray_sort!r}")
    method = resolve_intersector(settings, scene)
    return settings.ray_sort == "on" or (
        settings.ray_sort == "auto"
        and method in ("shortlist", "shortlist_pallas", "cluster"))


def _compact_bits(x):
    """Drop the odd bits of a u32 (inverse of 2D Morton interleave)."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _morton_pixel(p, width: int):
    """Morton (Z-order) pixel for linear spawn index ``p`` (square 2^k dims):
    consecutive spawn ids cover square pixel tiles."""
    x = _compact_bits(p)
    y = _compact_bits(p >> 1)
    return y * width + x


def resolve_spawn_chunk(settings, n_pixels: int, rays_per_pixel: int) -> int:
    """Concrete samples-per-spawn K for this workload (resolving auto = 0).

    The JAX package's rule, kept exactly because sharding slices this id
    space: K = 4 for short-path regimes (directLightingOnly, or rr <= 0.5)
    or with >= 64 chunks of slack per lane, K = 2 with >= 32, else 1.
    """
    if settings.spawn_chunk != 0:
        return max(1, settings.spawn_chunk)
    total = n_pixels * rays_per_pixel
    batch = min(settings.batch_size, total)
    short_paths = settings.direct_lighting_only or settings.rr_prob <= 0.5
    if short_paths or total >= 16 * 4 * batch:
        return 4
    if total >= 16 * 2 * batch:
        return 2
    return 1


def pool_ids_total(settings, n_pixels: int, rays_per_pixel: int) -> int:
    """Size of the pool's padded pixel-major global ray-id space."""
    k = resolve_spawn_chunk(settings, n_pixels, rays_per_pixel)
    return n_pixels * (-(-rays_per_pixel // k) * k)


def _spawn_order_morton(settings, n_pixels: int) -> bool:
    return (
        settings.width == settings.height
        and settings.width & (settings.width - 1) == 0
        and settings.width > 1
    )


def render_pool(
    scene,
    frame,
    settings,
    n_pixels: int,
    batch: int,
    rays_per_pixel: int,
    sample_offset: int = 0,
    id_offset: int | None = None,
    id_limit: int | None = None,
    n_ids: int | None = None,
):
    """Trace ``n_pixels * rays_per_pixel`` paths -> (image [P, 3] radiance
    sum, rays_traced (int64 tensor), iterations (int)).

    Ray-id space: pixel-major, chunk-padded. With K the spawn chunk and
    spp_pad = ceil(rays_per_pixel / K) * K, id = pixel * spp_pad +
    sample_local; ids with sample_local >= rays_per_pixel are holes, never
    traced. ``sample_offset`` shifts the sample indices so chunked renders
    reproduce the straight-through result.

    Slicing hooks: the pool can own a slice of the global id space.
    ``n_ids`` is the slice length, ``id_offset`` shifts local ids to global
    ones and must be a multiple of K, and ``id_limit`` caps the local id
    count for a ragged final slice.

    With the ray sort on (``sort_rays_on``) the lanes are reordered by
    ``_sort_key`` at the top of every iteration. The pool is lane-anonymous
    (randomness is keyed on each lane's (pixel, sample), chunks come from a
    global counter, flushes go by pixel), so the sort changes neither the
    traced rays nor the iteration count, only the image's summation order.
    """
    sort_rays = sort_rays_on(settings, scene)
    device = scene.device
    k_chunk = resolve_spawn_chunk(settings, n_pixels, rays_per_pixel)
    spp_pad = -(-rays_per_pixel // k_chunk) * k_chunk
    total = n_ids if n_ids is not None else n_pixels * spp_pad
    limit = total if id_limit is None else int(id_limit)
    offset = 0 if id_offset is None else int(id_offset)
    num_chunks = -(-total // k_chunk)
    b = max(1, min(batch, num_chunks))
    morton = _spawn_order_morton(settings, n_pixels)

    def chunk_info(start_ids):
        """(pixel, first sample, valid path count) for [B] chunk-start ids
        (local, multiples of K)."""
        gids = start_ids + offset
        pixel = torch.div(gids, spp_pad, rounding_mode="floor")
        s_local = gids % spp_pad
        if morton:
            pixel = _morton_pixel(pixel, settings.width)
        sample = s_local + sample_offset
        count = torch.clamp(
            torch.minimum(rays_per_pixel - s_local, limit - start_ids),
            0, k_chunk,
        )
        return pixel, sample, count

    def cam(pixel, sample):
        jitter = rng.pixel_jitter(settings, pixel, sample)
        return generate_rays(frame, settings.width, settings.height, pixel, jitter)

    # Initial fill: lanes take chunks 0..b-1.
    ids0 = torch.arange(b, dtype=torch.int64, device=device) * k_chunk
    pixel, sample, chunk_left = chunk_info(ids0)
    o, d = cam(pixel, sample)
    beta = torch.ones_like(o)
    radiance = torch.zeros_like(o)
    acc = torch.zeros_like(o)
    alive = chunk_left > 0
    spec = torch.zeros_like(alive)
    depth = torch.zeros(b, dtype=torch.int64, device=device)
    image = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
    next_id = b * k_chunk
    n_rays = torch.zeros((), dtype=torch.int64, device=device)
    iters = 0
    if sort_rays:
        sort_lo, sort_inv = _sort_bounds(scene)

    while True:
        with span("pt.sync"):
            if not bool(torch.any(alive)):
                break
        with span("pt.pool_iter"):
            if sort_rays:
                perm = torch.sort(_sort_key(o, d, alive, sort_lo, sort_inv),
                                  stable=True).indices
                (o, d, beta, radiance, acc, alive, spec, pixel, sample, depth,
                 chunk_left) = (x[perm] for x in (o, d, beta, radiance, acc, alive,
                                                  spec, pixel, sample, depth,
                                                  chunk_left))
            was_alive = alive
            o, d, beta, radiance, alive, spec, n = bounce_core(
                scene, settings, o, d, beta, radiance, alive, spec,
                pixel, sample, depth,
            )
            n_rays = n_rays + n
            iters += 1
            depth = depth + 1
            # Depth cap (reference: while depth <= 16 -> max_depth bounces).
            alive = alive & (depth < settings.max_depth)

            # A lane whose path ended folds the path's radiance, clamped per
            # channel per path as the reference accumulator does, into its
            # chunk sum; with samples left in its chunk it re-aims in place.
            died = was_alive & ~alive
            cont = died & (chunk_left > 1)
            finished = died & ~cont
            acc = acc + torch.where(died[:, None], torch.clamp(radiance, min=0.0), 0.0)
            radiance = torch.where(died[:, None], 0.0, radiance)

            # Every finished chunk flushes now, in one scatter-add.
            with span("pt.sync"):
                done = torch.nonzero(finished).squeeze(1)
            image.index_add_(0, pixel[done], acc[done])
            acc = torch.where(finished[:, None], 0.0, acc)

            # Finished lanes take fresh chunk-start ids from the global counter.
            rank = torch.cumsum(finished.to(torch.int64), dim=0) - 1
            new_ids = next_id + rank * k_chunk
            take = finished & (new_ids < limit)
            next_id = min(next_id + done.shape[0] * k_chunk, limit)

            n_pixel, n_sample, n_count = chunk_info(new_ids)
            # One camera-ray generation serves fresh chunks and continuations.
            r_pixel = torch.where(take, n_pixel, pixel)
            r_sample = torch.where(take, n_sample, sample + 1)
            r_o, r_d = cam(r_pixel, r_sample)

            resp = take | cont
            sel = resp[:, None]
            o = torch.where(sel, r_o, o)
            d = torch.where(sel, r_d, d)
            beta = torch.where(sel, 1.0, beta)
            alive = alive | resp
            spec = spec & ~resp
            pixel = r_pixel
            sample = torch.where(resp, r_sample, sample)
            depth = torch.where(resp, 0, depth)
            chunk_left = torch.where(
                take, n_count, torch.where(cont, chunk_left - 1, chunk_left)
            )
    return image, n_rays, iters


def render_regenerative_stats(scene, camera, settings):
    """Full render via the regenerative pool -> (mean radiance [H, W, 3],
    rays traced, pool iterations)."""
    frame = ray_frame_tensors(camera, settings.width, settings.height, scene.device)
    n_pixels = settings.width * settings.height
    image, n_rays, iters = render_pool(
        scene,
        frame,
        settings,
        n_pixels=n_pixels,
        batch=min(settings.batch_size, n_pixels * settings.samples_per_pixel),
        rays_per_pixel=settings.samples_per_pixel,
    )
    mean = image / settings.samples_per_pixel
    return mean.reshape(settings.height, settings.width, 3), n_rays, iters


def render_regenerative(scene, camera, settings):
    """Full render via the regenerative pool -> mean radiance [H, W, 3]."""
    return render_regenerative_stats(scene, camera, settings)[0]
