"""The port's integrator and regenerative pool vs the JAX package on the CPU.

One bounce on shared inputs, the spawn-chunk id-space rule, and whole
renders of the procedural Cornell box at 16x16, spp 2, depth 17. Renders
must trace the same rays (``n_rays`` equal) and agree by the bounds of the
smoke run's card-vs-CPU phase: 99% of pixels within 1e-4 in linear radiance
and tonemapped MSE <= 1e-4 (only float rounding and summation order differ).
Bounce outputs agree within rtol 1e-5 / atol 5e-6: libm and XLA's fused
rounding differ in the last bits, and a light sample at a grazing angle
loses digits in its cosine (2.6e-6 measured on one lane of 3072 with two
light samples).

Renders of further settings are in test_torch_render_*.py; torch_parity()
below is shared with them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.models.scene import _to_device
from pathtracer_tpu.ops import integrator as jint
from pathtracer_tpu.ops import rng as jrng
from pathtracer_tpu.ops import wavefront as jwave
from pathtracer_tpu.ops.camera_rays import generate_rays as jax_rays
from pathtracer_tpu.ops.tonemap import tonemap_reference as jax_tonemap
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import integrator as tint
from pathtracer_tpu_torch.ops import intersect_small
from pathtracer_tpu_torch.ops import wavefront as twave
from pathtracer_tpu_torch.render import render_stats

SIZE = dict(width=16, height=16, samples_per_pixel=2, max_depth=17)


def scenes(glossy: bool = False, mesh=None):
    """(JAX Scene, port Scene, camera) of one packed mesh, by default the
    Cornell box."""
    packed = pack_scene(mesh or procedural.cornell_box_mesh(glossy_tall_box=glossy))
    return _to_device(packed), scene_from_packed(packed), procedural.cornell_box_camera()


def jax_scan_render(jscene, camera, st):
    """The JAX scan scheduler (render.sample_wave), with its ray count."""
    stats = jax.jit(jint.radiance_batch_stats, static_argnums=1)
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(st.width, st.height).items()}
    n_pix = st.width * st.height
    pix = jnp.arange(n_pix, dtype=jnp.uint32)
    acc, n = 0.0, 0.0
    for s in range(st.samples_per_pixel):
        smp = jnp.full((n_pix,), s, jnp.uint32)
        o, d = jax_rays(frame, st.width, st.height, pix, jrng.pixel_jitter(st, pix, smp))
        rad, dn = stats(jscene, st, o, d, pix, smp)
        acc, n = acc + jnp.maximum(rad, 0.0), n + dn
    return np.asarray(acc / st.samples_per_pixel).reshape(st.height, st.width, 3), n


def torch_parity(scheduler: str, glossy: bool = False, mesh=None, jax_kw=None, **kw):
    """Render ``mesh`` (default: the Cornell box) with both packages; assert
    equal rays traced and images within the stated bounds. ``jax_kw``
    overrides settings of the JAX render only (e.g. an intersector that JAX
    runs on the CPU only in interpret mode). Returns the port's (image, rays
    traced)."""
    jscene, scene, camera = scenes(glossy, mesh)
    settings = dict(SIZE, scheduler=scheduler, **kw)
    jst, st = JaxSettings(**{**settings, **(jax_kw or {})}), RenderSettings(**settings)
    if scheduler == "regen":
        ref, n_ref, _ = jwave.render_regenerative_stats(jscene, camera, jst)
        ref = np.asarray(ref)
    else:
        ref, n_ref = jax_scan_render(jscene, camera, jst)
    img, n = render_stats(scene, camera, st)
    assert int(n) == int(n_ref), (int(n), float(n_ref))
    img = img.numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    close = (np.abs(img - ref).max(-1) <= 1e-4).mean()
    assert close >= 0.99, close
    mse = float(np.mean((np.asarray(jax_tonemap(jnp.asarray(img)))
                         - np.asarray(jax_tonemap(jnp.asarray(ref)))) ** 2))
    assert mse <= 1e-4, mse
    assert intersect_small.launches == {"closest": 0, "occluded": 0}
    return img, int(n)


def test_regen_defaults():
    torch_parity("regen")


def test_scan_defaults():
    torch_parity("scan")


def test_regen_seed7():
    torch_parity("regen", seed=7)


BOUNCE_CASES = {
    "defaults": ({}, False),
    "direct_lighting_only": ({"direct_lighting_only": True}, False),
    "shadow_closest": ({"shadow_mode": "closest"}, False),
    "beckmann_glossy": ({"glossy_brdf": "beckmann"}, True),
    "phong_glossy": ({}, True),
    "two_light_samples": ({"num_direct_lighting_samples": 2}, False),
    "corrected": ({"compat_count_light_pdf": False, "compat_sticky_specular": False,
                   "compat_fixed_eta": False}, True),
}


@pytest.mark.parametrize("case", sorted(BOUNCE_CASES))
def test_bounce_core_matches_jax(case):
    kw, glossy = BOUNCE_CASES[case]
    jscene, scene, camera = scenes(glossy)
    g = np.random.default_rng(4)
    b = 1024
    half = b // 2
    frame = camera.ray_frame(16, 16)
    # Camera rays for half the lanes, random rays from inside the box for
    # the rest (bounce rays).
    pix_cam = g.integers(0, 256, half)
    o, d = jax_rays({k: jnp.asarray(v) for k, v in frame.items()}, 16, 16,
                    jnp.asarray(pix_cam, jnp.uint32),
                    jnp.asarray(g.random((half, 2), dtype=np.float32)))
    o_in = g.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (half, 3))
    d_in = g.normal(size=(half, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    inputs = dict(
        o=np.concatenate([np.asarray(o), o_in]).astype(np.float32),
        d=np.concatenate([np.asarray(d), d_in]).astype(np.float32),
        beta=g.uniform(0.2, 1.0, (b, 3)).astype(np.float32),
        radiance=g.uniform(0.0, 0.5, (b, 3)).astype(np.float32),
        alive=g.random(b) < 0.85,
        spec=g.random(b) < 0.2,
        pixel=g.integers(0, 1 << 32, b, dtype=np.uint64).astype(np.uint32),
        sample=g.integers(0, 64, b).astype(np.uint32),
        depth=g.integers(0, 5, b).astype(np.int32),
    )
    jst, st = JaxSettings(**kw), RenderSettings(**kw)
    step = jax.jit(jint.bounce_core, static_argnums=1)
    ref = step(jscene, jst, *(jnp.asarray(v) for v in inputs.values()))
    got = tint.bounce_core(scene, st, *(torch.as_tensor(v.astype(np.int64))
                                        if v.dtype.kind in "ui" else torch.as_tensor(v)
                                        for v in inputs.values()))
    for name, r, t in zip(("o", "d", "beta", "radiance", "alive", "spec"), ref, got):
        r, t = np.asarray(r), t.numpy()
        if r.dtype == bool:
            np.testing.assert_array_equal(t, r, err_msg=name)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-5, atol=5e-6, err_msg=name)
    assert int(got[6]) == int(ref[6])


def test_spawn_chunk_and_id_space_match_jax():
    for spp in (1, 2, 3, 4, 5, 16, 50, 1024):
        for n_pixels in (1, 7, 256, 512 * 512):
            for kw in ({}, {"direct_lighting_only": True}, {"rr_prob": 0.5},
                       {"spawn_chunk": 3}, {"batch_size": 1000}):
                jst, st = JaxSettings(**kw), RenderSettings(**kw)
                assert twave.resolve_spawn_chunk(st, n_pixels, spp) == (
                    jwave.resolve_spawn_chunk(jst, n_pixels, spp))
                assert twave.pool_ids_total(st, n_pixels, spp) == (
                    jwave.pool_ids_total(jst, n_pixels, spp))


def test_morton_pixel_matches_jax():
    p = np.arange(1 << 16, dtype=np.uint32)
    ref = np.asarray(jwave._morton_pixel(jnp.asarray(p), 256))
    got = twave._morton_pixel(torch.as_tensor(p.astype(np.int64)), 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    for w, h in ((16, 16), (16, 8), (12, 12), (1, 1)):
        assert twave._spawn_order_morton(RenderSettings(width=w, height=h), w * h) == (
            jwave._spawn_order_morton(JaxSettings(width=w, height=h), w * h))
