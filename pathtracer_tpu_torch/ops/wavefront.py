"""Regenerative wavefront renderer.

Port of ``pathtracer_tpu/ops/wavefront.py``. A pool of B lanes stays busy:
when a lane's path ends, it folds the path's radiance into its chunk
accumulator and either re-aims in place (same pixel, next sample of its
chunk) or, once the chunk is done, flushes the chunk's sum into the image
and takes the next chunk of (pixel, K samples) from a global id counter.

The id space, the spawn chunk K, the Morton spawn order and the per-path
clamp are the JAX package's, so the set of traced paths, and with the
counter-based RNG each path's radiance, are the same. What differs: every
lane whose chunk finished flushes in the same iteration with one
``index_add_`` (the JAX package holds finished lanes and flushes at most
one per 4-lane group per iteration, a TPU scatter-cost workaround), and ids
and counts are int64. Only the iteration count and the order of float
summation into the image differ.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import bounce_core
from pathtracer_tpu_torch.ops.intersect import resolve_intersector


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


def _check_pool_settings(settings, scene) -> None:
    resolve_intersector(settings, scene)  # raises for unported routes
    if settings.ray_sort == "on":
        raise NotImplementedError(
            "ray_sort='on' is not ported yet (ROADMAP queue item 6, the pool "
            "ray sort); 'auto' resolves to off for the ported intersectors"
        )
    if settings.ray_sort not in ("auto", "off"):
        raise ValueError(f"unknown ray_sort {settings.ray_sort!r}")


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
    """
    _check_pool_settings(settings, scene)
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

    while bool(torch.any(alive)):
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
