"""The port's profiling helpers (utils.profiling) on the CPU: RenderStats as
the JAX package's, timed around a render, and trace writing a Chrome trace."""

import json

from pathtracer_tpu.utils.profiling import RenderStats as JaxStats
from pathtracer_tpu_torch.models.procedural import cornell_box_scene
from pathtracer_tpu_torch.models.scene import RenderSettings
from pathtracer_tpu_torch.render import render_stats
from pathtracer_tpu_torch.utils.profiling import RenderStats, timed, trace

SETTINGS = RenderSettings(width=8, height=8, samples_per_pixel=1, max_depth=3)


def test_render_stats_as_jax():
    for args in ((2.0, 3e6, 1e6, 7), (0.0, 1.0, 1.0)):
        got, want = RenderStats(*args), JaxStats(*args)
        assert (got.rays_per_sec, got.paths_per_sec, str(got)) == (
            want.rays_per_sec, want.paths_per_sec, str(want))


def test_timed_and_trace(tmp_path):
    scene, camera = cornell_box_scene(device="cpu")
    result = {}
    with trace(str(tmp_path / "prof")):
        with timed(result):
            img, n = render_stats(scene, camera, SETTINGS)
            result["block_on"] = img
    assert "block_on" not in result and result["wall_s"] > 0.0
    stats = RenderStats(result["wall_s"], float(n), 64.0)
    assert stats.rays_per_sec > 0.0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
