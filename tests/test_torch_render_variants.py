"""Regenerative-pool renders of the port vs JAX under settings that change
the pool's id space: direct lighting only and rr 0.5 (spawn chunk K = 4),
and a non-square image (no Morton spawn order). Bounds as in
test_torch_integrator.torch_parity."""

import numpy as np
import torch

from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.ops.wavefront import render_pool, resolve_spawn_chunk
from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors
from pathtracer_tpu_torch.render import render, render_stats
from test_torch_integrator import SIZE, torch_parity


def test_regen_direct_lighting_only():
    st = RenderSettings(direct_lighting_only=True, **SIZE)
    assert resolve_spawn_chunk(st, 256, 2) == 4
    torch_parity("regen", direct_lighting_only=True)


def test_regen_rr_half():
    assert resolve_spawn_chunk(RenderSettings(rr_prob=0.5, **SIZE), 256, 2) == 4
    torch_parity("regen", rr_prob=0.5)


def test_regen_non_square():
    torch_parity("regen", width=24)


def test_preview_chunks_equal_straight_render():
    """Preview chunks (sample_offset) trace the same paths as one pool."""
    scene, camera = cornell_box_scene()
    st = RenderSettings(**dict(SIZE, samples_per_pixel=3))
    seen = []
    img, n = render_stats(scene, camera, st)
    chunked = render(scene, camera, st, preview_every=1,
                     preview_fn=lambda done, mean: seen.append(done))
    assert seen == [1, 2]
    np.testing.assert_allclose(chunked.numpy(), img.numpy(), rtol=0, atol=1e-5)


def test_pool_id_slices_cover_the_whole_render():
    """Two K-aligned slices of the id space (id_offset / n_ids / id_limit)
    sum to the unsliced pool's image and ray count."""
    scene, camera = cornell_box_scene()
    st = RenderSettings(**dict(SIZE, samples_per_pixel=3, spawn_chunk=2))
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    kw = dict(n_pixels=256, batch=64, rays_per_pixel=3)
    whole, n_whole, _ = render_pool(scene, frame, st, **kw)
    total = 256 * 4  # spp 3 padded to a multiple of K = 2
    a, n_a, _ = render_pool(scene, frame, st, id_offset=0, n_ids=600, **kw)
    b, n_b, _ = render_pool(scene, frame, st, id_offset=600, n_ids=total - 600,
                            id_limit=total - 600, **kw)
    assert int(n_a + n_b) == int(n_whole)
    torch.testing.assert_close(a + b, whole, rtol=0, atol=1e-5)
