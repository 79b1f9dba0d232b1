"""Checkpoint/resume of the port (render.render_checkpointed over
utils.checkpoint): an interrupted render equals a straight-through one, a
fingerprint mismatch starts over, and state files are interchangeable with
the JAX package's (same npz layout, same fingerprint recipe).

Images: the port's checkpointed render against its own straight render of
the procedural Cornell box, within rtol 1e-5 / atol 1e-6 (the JAX package's
bound for the same check; only the order of summation differs).
"""

import numpy as np
import pytest

from pathtracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
from pathtracer_tpu.utils import checkpoint as jckpt
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.render import render, render_checkpointed
from pathtracer_tpu_torch.utils.checkpoint import (
    load_render_state,
    render_fingerprint,
    save_render_state,
)
# The JAX side packs its scenes with its native BVH builder: load it first.
from test_torch_frontend import jax_native_library  # noqa: F401 (autouse)

SETTINGS = dict(width=16, height=16, max_depth=4)


@pytest.fixture(scope="module")
def cornell():
    return cornell_box_scene(device="cpu")


def test_checkpointed_render_matches_direct(cornell, tmp_path):
    scene, camera = cornell
    settings = RenderSettings(samples_per_pixel=6, **SETTINGS)
    direct = render(scene, camera, settings).numpy()
    done = []
    resumed = render_checkpointed(scene, camera, settings, str(tmp_path / "render.npz"),
                                  chunk_samples=4, progress_callback=lambda d, t: done.append(d))
    assert done == [4, 6]
    np.testing.assert_allclose(resumed.numpy(), direct, rtol=1e-5, atol=1e-6)


def test_resume_after_partial(cornell, tmp_path):
    """A kill after the first chunk leaves its state on disk; the rerun
    starts from it and completes to the straight render."""
    scene, camera = cornell
    settings = RenderSettings(samples_per_pixel=4, **SETTINGS)
    ckpt = str(tmp_path / "render.npz")

    def stop_after_first(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        render_checkpointed(scene, camera, settings, ckpt, chunk_samples=2,
                            progress_callback=stop_after_first)
    state = load_render_state(ckpt, render_fingerprint(scene, settings))
    assert state is not None and state[1] == 2
    assert state[0].shape == (256, 3) and state[0].dtype == np.float32

    chunks = []
    resumed = render_checkpointed(scene, camera, settings, ckpt, chunk_samples=2,
                                  progress_callback=lambda d, t: chunks.append(d))
    assert chunks == [4]  # only the second chunk was traced
    direct = render(scene, camera, settings).numpy()
    np.testing.assert_allclose(resumed.numpy(), direct, rtol=1e-5, atol=1e-6)


def test_fingerprint_invalidates(cornell, tmp_path):
    """A state of other settings is ignored, and the render starts over."""
    scene, camera = cornell
    s1 = RenderSettings(samples_per_pixel=2, **SETTINGS)
    s2 = RenderSettings(samples_per_pixel=2, rr_prob=0.5, **SETTINGS)
    path = str(tmp_path / "r.npz")
    save_render_state(path, np.full((256, 3), 1e3, np.float32), 1, render_fingerprint(scene, s1))
    assert load_render_state(path, render_fingerprint(scene, s1)) is not None
    assert load_render_state(path, render_fingerprint(scene, s2)) is None
    img = render_checkpointed(scene, camera, s2, path, chunk_samples=1).numpy()
    np.testing.assert_allclose(img, render(scene, camera, s2).numpy(), rtol=1e-5, atol=1e-6)
    assert load_render_state(path, render_fingerprint(scene, s2))[1] == 2


@pytest.mark.parametrize("kw", [{}, {"rr_prob": 0.5, "seed": 7, "rng": "threefry"}])
def test_fingerprint_matches_jax(cornell, kw):
    jscene, _ = jax_cornell()
    want = jckpt.render_fingerprint(jscene, JaxSettings(**SETTINGS, **kw))
    assert render_fingerprint(cornell[0], RenderSettings(**SETTINGS, **kw)) == want


def test_state_files_interchange_with_jax(cornell, tmp_path):
    """A state written by the JAX package's save_render_state loads in the
    port, and one written by the port loads in the JAX package."""
    scene, camera = cornell
    settings = RenderSettings(samples_per_pixel=4, **SETTINGS)
    fp = render_fingerprint(scene, settings)
    acc = np.random.default_rng(0).random((256, 3)).astype(np.float32)
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_render_state(jax_file, acc, 3, fp)
    got = load_render_state(jax_file, fp)
    assert got is not None and got[1] == 3
    np.testing.assert_array_equal(got[0], acc)
    save_render_state(port_file, acc, 3, fp)
    got = jckpt.load_render_state(port_file, fp)
    assert got is not None and got[1] == 3
    np.testing.assert_array_equal(got[0], acc)
    # The port resumes the JAX package's state: 3 samples done, 1 to trace.
    chunks = []
    render_checkpointed(scene, camera, settings, jax_file, chunk_samples=2,
                        progress_callback=lambda d, t: chunks.append(d))
    assert chunks == [4]
