"""bench_torch.py, the port's bench, on the CPU at a tiny size.

Its result line against the port's own render counts and against the JAX
package's (``render_pool`` and ``radiance_batch_stats`` on the same
settings), its imports, the reference branches, its ``_render_config_mse``
against ``bench.py``'s on a reference root the test writes, and ``--sharded``
over two gloo workers.

Bounds: ray counts equal (the integrators count the same live lanes); the
MSE against a ground-truth PNG within 1e-6 of JAX's (renders agree to ~1e-4
per value, and ``bench.py`` rounds its MSE to 6 decimals); ``spp`` equal.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from pathtracer_tpu_torch.models import procedural
from pathtracer_tpu_torch.models.pack import pack_scene
from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
from pathtracer_tpu_torch.ops import rng
from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
from pathtracer_tpu_torch.ops.integrator import radiance_batch_stats
from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--size", "16", "--spp", "1", "--device", "cpu", "--repeat", "1", "--warmup", "1"]
KEYS = {"metric", "value", "unit", "workload", "paths_per_sec", "wall_s", "walls_s",
        "wall_median_s", "rays", "iterations", "launches", "device", "intersector",
        "scheduler"}
MESHES = {"cornell": lambda: procedural.cornell_box_mesh(),
          "torus": lambda: procedural.torus_cornell_mesh(),
          "band": lambda: procedural.torus_cornell_mesh(30, 18)}


def _bench(capsys, *argv) -> dict:
    assert bench_torch.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_rays(scene_name: str, st: RenderSettings) -> int:
    """The port's count on ``st``: the regenerative render's, or the sum of
    the scan's waves' (hash jitter, as bench.py seeds them)."""
    scene = scene_from_packed(pack_scene(MESHES[scene_name]()), "cpu")
    camera = procedural.cornell_box_camera()
    if st.scheduler == "regen":
        return int(render_regenerative_stats(scene, camera, st)[1])
    frame = ray_frame_tensors(camera, st.width, st.height, "cpu")
    pix = torch.arange(st.width * st.height)
    total = 0
    for s in range(st.samples_per_pixel):
        ids = torch.full_like(pix, s)
        o, d = generate_rays(frame, st.width, st.height, pix, rng.pixel_jitter_hash(pix, ids))
        total += int(radiance_batch_stats(scene, st, o, d, pix, ids)[1])
    return total


def _jax_rays(st: RenderSettings) -> int:
    """JAX's count on the Cornell box, as bench.py computes it."""
    from pathtracer_tpu.models.procedural import cornell_box_scene
    from pathtracer_tpu.models.scene import RenderSettings as JaxSettings
    from pathtracer_tpu.ops import rng as jrng
    from pathtracer_tpu.ops.camera_rays import generate_rays as jax_rays
    from pathtracer_tpu.ops.integrator import radiance_batch_stats as jax_stats
    from pathtracer_tpu.ops.wavefront import render_pool

    scene, camera = cornell_box_scene()
    jst = JaxSettings(**dataclasses.asdict(st))
    n_pixels, spp = st.width * st.height, st.samples_per_pixel
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(st.width, st.height).items()}
    if st.scheduler == "regen":
        _, n, _ = render_pool(scene, frame, jst, n_pixels=n_pixels,
                              batch=min(jst.batch_size, n_pixels * spp), rays_per_pixel=spp)
        return int(n)
    pix = jnp.arange(n_pixels, dtype=jnp.uint32)
    total = 0
    for s in range(spp):
        ids = jnp.full((n_pixels,), s, dtype=jnp.uint32)
        o, d = jax_rays(frame, st.width, st.height, pix, jrng.pixel_jitter_hash(pix, ids))
        total += int(jax_stats(scene, jst, o, d, pix, ids)[1])
    return total


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
@pytest.mark.parametrize("scene", ["cornell", "torus", "band"])
def test_bench_line_counts_the_ports_rays(capsys, scene, scheduler):
    out = _bench(capsys, *TINY, "--no-sharded", "--scene", scene, "--scheduler", scheduler)
    assert KEYS <= set(out) and "vs_baseline" not in out and "baseline_note" not in out
    assert out["metric"] == "rays_per_sec_per_chip" and out["unit"] == "rays/s"
    assert out["workload"] == f"{scene}_16x16_spp1" and out["device"] == "cpu"
    assert out["scheduler"] == scheduler and out["intersector"] == "auto"
    assert len(out["walls_s"]) == 1 and out["wall_s"] == min(out["walls_s"]) > 0
    assert out["value"] == pytest.approx(out["rays"] / out["wall_s"])
    assert out["paths_per_sec"] == pytest.approx(256 / out["wall_s"])
    st = RenderSettings(width=16, height=16, samples_per_pixel=1, scheduler=scheduler)
    assert out["rays"] == _port_rays(scene, st) > 256
    assert out["iterations"] > 0
    assert out["launches"] == {}  # the CPU runs the kernels' plain versions


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_bench_rays_equal_jax(capsys, scheduler):
    out = _bench(capsys, *TINY, "--no-sharded", "--scheduler", scheduler)
    st = RenderSettings(width=16, height=16, samples_per_pixel=1, scheduler=scheduler)
    assert out["rays"] == _jax_rays(st)


def test_bench_repeats_and_traces(capsys, tmp_path):
    out = _bench(capsys, *TINY[:6], "--repeat", "2", "--no-sharded",
                 "--trace", str(tmp_path / "trace"))
    assert len(out["walls_s"]) == 2 and out["wall_median_s"] == pytest.approx(
        sum(out["walls_s"]) / 2)
    assert out["trace_dir"] == str(tmp_path / "trace")
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_bench_imports_no_jax():
    code = ("import sys, bench_torch\n"
            "assert bench_torch.main(sys.argv[1:]) == 0\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
            "             or m == 'pathtracer_tpu' or m.startswith('pathtracer_tpu.'))\n"
            "print('IMPORTED', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code, *TINY, "--no-sharded"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "IMPORTED []", lines[-1]
    assert json.loads(lines[-2])["rays"] > 0


@pytest.mark.parametrize("flags", [["--mse"], ["--boat"], ["--scene", "boat"]])
def test_reference_branches_need_the_reference(capsys, monkeypatch, tmp_path, flags):
    monkeypatch.setenv("PT_TPU_REFERENCE_ROOT", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        bench_torch.main([*TINY, "--no-sharded", *flags])
    msg = str(e.value.code)
    assert msg.startswith(f"reference asset '{tmp_path}") and "not found" in msg
    assert "set PT_TPU_REFERENCE_ROOT to the reference checkout" in msg


def test_render_config_mse_matches_bench_py(monkeypatch, tmp_path):
    """The port's ``_render_config_mse`` against ``bench.py``'s on a reference
    root holding one Cornell INI (16^2, spp 2) and its two reference PNGs."""
    import bench

    from pathtracer_tpu_torch.utils.image import write_png

    final = tmp_path / "scene_files" / "final"
    final.mkdir(parents=True)
    procedural.write_cornell_box_files(str(final), width=16, height=16, samples_per_pixel=2)
    g = np.random.default_rng(11)
    for sub in ("scene_assets/ground_truth/final", "student_outputs/final"):
        (tmp_path / sub).mkdir(parents=True)
        write_png(str(tmp_path / sub / "cornell.png"),
                  g.uniform(0.0, 0.6, (16, 16, 3)).astype(np.float32))
    monkeypatch.setenv("PT_TPU_REFERENCE_ROOT", str(tmp_path))
    monkeypatch.setattr(bench, "REFERENCE_ROOT", str(tmp_path))
    got = bench_torch._render_config_mse("cornell", device="cpu")
    ref = bench._render_config_mse("cornell")
    assert got["spp"] == ref["spp"] == 2
    for key in ("mse_ground_truth", "mse_student_output"):
        assert got[key] > 0.0
        assert abs(got[key] - ref[key]) <= 1e-6, (key, got[key], ref[key])
    assert got["wall_s"] > 0 and got["rays_per_sec"] > 0
    got = bench_torch._render_config_mse("cornell", spp_override=1, device="cpu")
    assert got["spp"] == 1


def test_bench_sharded_over_two_gloo_workers(capsys):
    out = _bench(capsys, "--size", "16", "--spp", "2", "--device", "cpu", "--device", "cpu",
                 "--repeat", "1", "--sharded")
    sh = out["sharded"]
    assert sh["n_devices"] == 2 and sh["devices"] == ["cpu", "cpu"]
    assert sh["rays"] == out["rays"]
    assert sh["rays_per_sec"] == pytest.approx(sh["rays"] / min(sh["walls_s"]))
    assert sh["rays_per_sec_per_device"] == pytest.approx(sh["rays_per_sec"] / 2)
    assert sh["efficiency"] > 0 and sh["efficiency"] == pytest.approx(
        sh["rays_per_sec_per_device"] / sh["single_device_same_work_rays_per_sec"])


def test_bench_sharded_one_device(capsys):
    out = _bench(capsys, *TINY, "--sharded")
    sh = out["sharded"]
    assert sh["n_devices"] == 1 and sh["efficiency"] == 1.0 and sh["rays"] == out["rays"]


def test_bench_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_torch.main(["--size", "16", "--spp", "1", "--no-sharded"])
    with pytest.raises(SystemExit, match="more than once only with --sharded"):
        bench_torch.main([*TINY, "--device", "cpu", "--no-sharded"])
