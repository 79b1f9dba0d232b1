"""Sharded rendering over a device mesh.

Port of ``pathtracer_tpu/parallel/render.py``: the flat ray-id space shards
across the mesh's ``rays`` axis, the scene replicates (one copy per distinct
device, ``mesh.replicas``), and each shard traces its slice. Because the RNG
is counter-based on (pixel, sample), a path's radiance does not depend on
its shard: the sharded scan is bit-equal to the unsharded scan, and the
sharded pool differs from the unsharded pool only in the order of float
summation into the image.

The shards of one process run one after another: the pool syncs with the
host every iteration, so an in-process mesh of several devices (or of one
device repeated) gives parity with JAX's single-process mesh, as the tests
use it, not speed. The CLI's and ``bench_torch.py``'s ``--sharded`` run
several devices as several processes, one per device
(``parallel.launch.run_workers``), each with a mesh of its one device that
spans the group, and those run at the same time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import radiance_batch
from pathtracer_tpu_torch.ops.wavefront import (
    pool_ids_total,
    render_pool,
    resolve_spawn_chunk,
)
from pathtracer_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce,
    make_mesh,
    replicas,
)


def _wave(shards, settings, sample_idx: int, mesh):
    """One sample for every pixel over the mesh's shards -> [HW, 3] on the
    first shard's device.

    The pixel ids are padded to a multiple of ``mesh.size`` with clamped
    duplicates (traced redundantly and sliced off); each shard traces its
    contiguous slice.
    """
    n_pixels = settings.width * settings.height
    per = -(-n_pixels // mesh.size)
    out_dev = mesh.devices[0]
    local = []
    for i, (scene, frame) in enumerate(shards):
        start = mesh.shard_index(i) * per
        pixel_ids = torch.clamp(
            torch.arange(start, start + per, dtype=torch.int64, device=scene.device),
            max=n_pixels - 1,
        )
        sample_ids = torch.full_like(pixel_ids, sample_idx)
        jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
        o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
        rad = radiance_batch(scene, settings, o, d, pixel_ids, sample_ids)
        local.append(torch.clamp(rad, min=0.0).to(out_dev))
    return all_gather_rows(torch.cat(local), mesh)[:n_pixels]


def sample_wave_sharded(scene, frame, settings, sample_idx: int, mesh):
    """One sample for every pixel, pixels sharded over the mesh -> [HW, 3]
    on the mesh's first device; equal to ``render.sample_wave``."""
    return _wave(replicas(scene, frame, mesh), settings, sample_idx, mesh)


def render_pool_sharded_stats(scene, camera, settings, mesh=None):
    """Regenerative pool sharded over the mesh -> (mean radiance [H, W, 3],
    rays traced over every shard (int64 tensor), the most pool iterations
    of any shard), on the mesh's first device.

    Each shard runs its own pool over a K-aligned slice of the pool's padded
    pixel-major id space (``ops.wavefront.render_pool``'s ``id_offset`` /
    ``id_limit`` / ``n_ids``), so no spawn chunk spans two shards; a shard
    past the end of the id space traces nothing. Images and ray counts sum
    over the shards and then over the processes.
    """
    mesh = mesh if mesh is not None else make_mesh()
    n_pixels = settings.width * settings.height
    spp = settings.samples_per_pixel
    k = resolve_spawn_chunk(settings, n_pixels, spp)
    total = pool_ids_total(settings, n_pixels, spp)
    per_dev = -(-total // mesh.size)  # ceil; the ragged tail is cut by id_limit
    per_dev = -(-per_dev // k) * k

    frame = ray_frame_tensors(camera, settings.width, settings.height, scene.device)
    out_dev = mesh.devices[0]
    image = torch.zeros((n_pixels, 3), dtype=torch.float32, device=out_dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=out_dev)
    iters = 0
    for i, (sc, fr) in enumerate(replicas(scene, frame, mesh)):
        offset = mesh.shard_index(i) * per_dev
        limit = min(total - min(offset, total), per_dev)
        img, n, it = render_pool(
            sc,
            fr,
            settings,
            n_pixels=n_pixels,
            batch=min(settings.batch_size, per_dev),
            rays_per_pixel=spp,
            id_offset=offset,
            id_limit=limit,
            n_ids=per_dev,
        )
        image += img.to(out_dev)
        n_rays += n.to(out_dev)
        iters = max(iters, it)
    image = all_reduce(image, mesh)
    n_rays = all_reduce(n_rays, mesh)
    iters = int(all_reduce(torch.tensor(iters, device=out_dev), mesh, dist.ReduceOp.MAX))
    mean = image / spp
    return mean.reshape(settings.height, settings.width, 3), n_rays, iters


def render_pool_sharded(scene, camera, settings, mesh=None):
    """Regenerative pool sharded over the mesh -> mean radiance [H, W, 3]."""
    return render_pool_sharded_stats(scene, camera, settings, mesh)[0]


def render_sharded(scene, camera, settings, mesh=None, progress_callback=None):
    """Progressive scan sharded over the mesh -> mean radiance [H, W, 3]
    (pre-tonemap), bit-equal to ``render.render`` with ``scheduler="scan"``."""
    mesh = mesh if mesh is not None else make_mesh()
    n_pixels = settings.width * settings.height
    frame = ray_frame_tensors(camera, settings.width, settings.height, scene.device)
    shards = replicas(scene, frame, mesh)
    acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=mesh.devices[0])
    for s in range(settings.samples_per_pixel):
        acc = acc + _wave(shards, settings, s, mesh)
        if progress_callback is not None:
            progress_callback(s + 1, settings.samples_per_pixel)
    mean = acc / settings.samples_per_pixel
    return mean.reshape(settings.height, settings.width, 3)
