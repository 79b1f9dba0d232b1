"""High-level rendering API.

Port of ``pathtracer_tpu/render.py``: ``render`` runs either scheduler —
"regen" traces every sample in the regenerative pool (ops.wavefront), "scan"
traces one progressive sample wave at a time like the reference's frame
loop — ``render_checkpointed`` runs the pool in chunks and saves its state
after each, so a killed render resumes, and ``render_image`` tonemaps the
result into a numpy image.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import radiance_batch_stats
from pathtracer_tpu_torch.ops.tonemap import TONEMAPS


def sample_wave_stats(scene, frame, settings, sample_idx: int):
    """Trace one sample for every pixel -> ([H*W, 3] radiance, rays traced).

    Each sample's channels are clamped at zero, as the reference
    accumulator does."""
    n_pixels = settings.width * settings.height
    pixel_ids = torch.arange(n_pixels, dtype=torch.int64, device=scene.device)
    sample_ids = torch.full_like(pixel_ids, sample_idx)

    jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    radiance, n_rays = radiance_batch_stats(
        scene, settings, o, d, pixel_ids, sample_ids
    )
    return torch.clamp(radiance, min=0.0), n_rays


def sample_wave(scene, frame, settings, sample_idx: int):
    """Trace one sample for every pixel -> [H*W, 3] radiance."""
    return sample_wave_stats(scene, frame, settings, sample_idx)[0]


def render_stats(scene, camera, settings, progress_callback=None,
                 preview_every: int = 0, preview_fn=None):
    """``render`` plus the rays traced (int64 tensor)."""
    preview_every = preview_every if preview_fn is not None else 0
    frame = ray_frame_tensors(camera, settings.width, settings.height, scene.device)
    n_pixels = settings.width * settings.height
    spp = settings.samples_per_pixel
    acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=scene.device)
    n_rays = torch.zeros((), dtype=torch.int64, device=scene.device)

    if settings.scheduler == "regen":
        from pathtracer_tpu_torch.ops.wavefront import render_pool

        step = preview_every or spp
        done = 0
        while done < spp:
            n = min(step, spp - done)
            img, dn, _ = render_pool(
                scene,
                frame,
                settings,
                n_pixels=n_pixels,
                batch=min(settings.batch_size, n_pixels * n),
                rays_per_pixel=n,
                sample_offset=done,
            )
            acc = acc + img
            n_rays = n_rays + dn
            done += n
            if preview_every and done < spp:
                preview_fn(
                    done, (acc / done).reshape(settings.height, settings.width, 3)
                )
            if progress_callback is not None:
                progress_callback(done, spp)
    elif settings.scheduler == "scan":
        for s in range(spp):
            img, dn = sample_wave_stats(scene, frame, settings, s)
            acc = acc + img
            n_rays = n_rays + dn
            done = s + 1
            if preview_every and done % preview_every == 0 and done < spp:
                preview_fn(
                    done, (acc / done).reshape(settings.height, settings.width, 3)
                )
            if progress_callback is not None:
                progress_callback(done, spp)
    else:
        raise ValueError(f"unknown scheduler {settings.scheduler!r}")
    return (acc / spp).reshape(settings.height, settings.width, 3), n_rays


def render(scene, camera, settings, progress_callback=None,
           preview_every: int = 0, preview_fn=None) -> torch.Tensor:
    """Full render -> mean radiance [H, W, 3] (pre-tonemap).

    ``settings.scheduler`` picks the engine: "regen" traces all samples in
    one regenerative-pool call; "scan" accumulates one sample wave at a
    time. ``preview_fn(done_spp, mean_hw3)`` is called with the running mean
    every ``preview_every`` samples (the pool is then run in chunks through
    ``sample_offset``; the counter RNG keeps the final image equal to an
    unchunked render up to summation order).
    """
    return render_stats(scene, camera, settings, progress_callback,
                        preview_every, preview_fn)[0]


def render_checkpointed(scene, camera, settings, checkpoint_path: str,
                        chunk_samples: int = 8, progress_callback=None) -> torch.Tensor:
    """Resumable render -> mean radiance [H, W, 3]: the pool runs in chunks of
    ``chunk_samples`` samples through ``sample_offset``, and after each the
    radiance sum and the samples done are saved to ``checkpoint_path``
    (``utils.checkpoint``) before ``progress_callback(done, spp)``. Kill it
    at any point and rerun with the same arguments to continue: the counter
    RNG makes the result equal a straight render up to summation order, with
    the same rays traced. A state whose fingerprint differs starts over.
    """
    from pathtracer_tpu_torch.ops.wavefront import render_pool
    from pathtracer_tpu_torch.utils.checkpoint import (
        load_render_state,
        render_fingerprint,
        save_render_state,
    )

    fp = render_fingerprint(scene, settings)
    n_pixels = settings.width * settings.height
    state = load_render_state(checkpoint_path, fp)
    if state is not None:
        acc = torch.as_tensor(state[0], dtype=torch.float32, device=scene.device)
        done = state[1]
    else:
        acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=scene.device)
        done = 0

    frame = ray_frame_tensors(camera, settings.width, settings.height, scene.device)
    spp = settings.samples_per_pixel
    while done < spp:
        n = min(chunk_samples, spp - done)
        img, _, _ = render_pool(
            scene,
            frame,
            settings,
            n_pixels=n_pixels,
            batch=min(settings.batch_size, n_pixels * n),
            rays_per_pixel=n,
            sample_offset=done,
        )
        acc = acc + img
        done += n
        save_render_state(checkpoint_path, acc.cpu().numpy(), done, fp)
        if progress_callback is not None:
            progress_callback(done, spp)
    return (acc / spp).reshape(settings.height, settings.width, 3)


def render_image(scene, camera, settings, tonemap: str = "reference",
                 progress_callback=None, preview_every: int = 0,
                 preview_fn=None) -> np.ndarray:
    """Render + tonemap -> numpy [H, W, 3] float in [0, 1]."""
    mean = render(scene, camera, settings, progress_callback,
                  preview_every=preview_every, preview_fn=preview_fn)
    return TONEMAPS[tonemap](mean).cpu().numpy()
