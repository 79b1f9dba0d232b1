"""Benchmark of the PyTorch/CUDA port: rays/s of a render, and MSE against
the reference's ground truth.

Port of ``bench.py`` (which benches the JAX package); it imports ``torch``
and ``pathtracer_tpu_torch`` only. Prints ONE JSON line last:

    {"metric": "rays_per_sec_per_chip", "value": N, "unit": "rays/s", ...}

    python bench_torch.py                         # Cornell 512^2 spp 16, regen, on the card
    python bench_torch.py --scene torus --spp 4   # the 12,580-triangle stand-in
    python bench_torch.py --size 16 --spp 1 --device cpu --no-sharded

Workloads (``--scene``), each rendered with the Cornell camera:

- ``cornell``: the procedural 36-triangle CornellBox twin, whose 512^2 spp 16
  regen render is the headline (as ``bench.py``'s).
- ``torus``: the Cornell box plus a 12,580-triangle torus
  (``torus_cornell_mesh()``, 12,800 padded as MedievalBoat's 12,573), the
  stand-in for MedievalBoat, whose asset is absent; ``auto`` takes the
  shortlist kernel on the card.
- ``band``: the Cornell box plus ``torus_cornell_mesh(30, 18)`` (1,116
  triangles, 1,152 padded as the glossy final's), the stand-in for glossy;
  ``auto`` takes the tiled kernel on the card.
- ``boat``: MedievalBoat.xml from the reference checkout.

The regen headline renders once untimed (the kernels' nvcc build and the
native library's g++ build happen there), then ``--repeat`` times, each
ending in ``torch.cuda.synchronize()``; ``wall_s`` is the best wall,
``walls_s`` every one and ``wall_median_s`` their median. The scan headline
runs ``--warmup`` waves, then ``--repeat`` rounds of ``spp`` waves into one
accumulator with one sync at the end. Ray counts (the integrator's live-lane
counters) are read after the timed window, and ``launches`` holds the
kernels' launches over the timed renders by family (none on the CPU, where
the wrappers run their plain versions). Rays/s is the rays over the best
wall; there is no baseline ratio (``bench.py``'s is a TPU figure).

``--sharded`` (on by default for ``cornell`` with ``regen``) also times the
regenerative pool sharded over the ``--device`` entries (default: every
visible card). Over one device it runs in this process, and its efficiency
is 1.0 by construction. Over several it runs one worker process per device
(``parallel.launch.run_workers``): each worker times its shard of the pool
between two barriers, and this process then times a one-device run of
``ceil(spp / n)`` samples through the same code for the efficiency.
``--device cuda:0 --device cuda:0`` runs two workers on one card.

``--boat`` (the MedievalBoat render at 512^2 spp 4) and ``--mse`` (the six
final configs at their INI sizes and spp, and the Cornell one at 1024 spp,
against ``scene_assets/ground_truth/final`` and ``student_outputs/final``)
need the reference checkout named by ``PT_TPU_REFERENCE_ROOT``; both are off
unless asked for, and without the checkout they exit with a message.
``--trace DIR`` writes a Chrome trace of the timed region
(``utils.profiling.trace``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REFERENCE_VAR = "PT_TPU_REFERENCE_ROOT"

FINAL_CONFIGS = (
    "cornell_box_full_lighting",
    "cornell_box_direct_lighting_only",
    "cornell_box_full_lighting_low_probability",
    "mirror",
    "glossy",
    "refraction",
)


def _reference_path(*parts: str) -> str:
    """``parts`` under the reference checkout (a relative path when
    ``PT_TPU_REFERENCE_ROOT`` is unset)."""
    return os.path.join(os.environ.get(REFERENCE_VAR, ""), *parts)


def _require_reference(path: str) -> None:
    if not os.environ.get(REFERENCE_VAR) or not os.path.exists(path):
        raise SystemExit(
            f"reference asset {path!r} not found; set {REFERENCE_VAR} "
            "to the reference checkout (or pass --no-mse / --scene cornell)"
        )


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(render, repeat: int, barrier=None):
    """``render()`` (which ends in a sync) ``repeat`` times, each timed (and
    between two ``barrier`` calls when given) -> (walls, results)."""
    walls, outs = [], []
    for _ in range(max(1, repeat)):
        if barrier:
            barrier()
        t0 = time.perf_counter()
        outs.append(render())
        if barrier:
            barrier()
        walls.append(time.perf_counter() - t0)
    return walls, outs


def _one_count(counts) -> int:
    """The ray count of every timed render (read after the timed window);
    they must agree (the counters are deterministic)."""
    counts = {int(n) for n in counts}
    if len(counts) != 1:
        raise RuntimeError(f"the timed renders traced different ray counts {sorted(counts)}")
    return counts.pop()


@contextlib.contextmanager
def _counting_launches(out: dict):
    """Zero the kernels' launch counts; on exit put the families that
    launched into ``out``."""
    from pathtracer_tpu_torch.kernels import launch_counts, reset_launches

    reset_launches()
    yield
    out.update({fam: dict(c) for fam, c in launch_counts().items() if any(c.values())})


def _render_config_mse(name: str, spp_override: int | None = None, device="cuda"):
    """Render one final config at its INI size and spp -> {rays_per_sec,
    wall_s, spp, mse_ground_truth, mse_student_output} (the MSEs where the
    images exist)."""
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.ops.tonemap import tonemap_reference
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats
    from pathtracer_tpu_torch.utils.image import mse, read_png

    ini = _reference_path("scene_files/final", name + ".ini")
    _require_reference(ini)
    overrides = {}
    if spp_override is not None:
        overrides["samples_per_pixel"] = spp_override
    scene, camera, settings, _ = load_scene(ini, device=device, **overrides)

    def render():
        mean, n_rays, _ = render_regenerative_stats(scene, camera, settings)
        _sync(device)
        return mean, n_rays

    render()  # the builds and first calls' set-up
    (wall,), ((mean, n_rays),) = _timed(render, 1)
    img = tonemap_reference(mean).cpu().numpy()
    out = {"rays_per_sec": int(n_rays) / wall, "wall_s": wall,
           "spp": settings.samples_per_pixel}
    gt = _reference_path("scene_assets/ground_truth/final", name + ".png")
    st = _reference_path("student_outputs/final", name + ".png")
    if os.path.exists(gt):
        out["mse_ground_truth"] = mse(img, read_png(gt))
    if os.path.exists(st):
        out["mse_student_output"] = mse(img, read_png(st))
    return out


def _scene(args, device):
    """(Scene, Camera) of ``--scene`` on ``device``."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import (
        cornell_box_camera,
        cornell_box_scene,
        torus_cornell_mesh,
    )
    from pathtracer_tpu_torch.models.scene import scene_from_graph, scene_from_packed
    from pathtracer_tpu_torch.models.scenegraph import load_scenegraph

    if args.scene == "cornell":
        return cornell_box_scene(device=device)
    if args.scene == "boat":
        xml = _reference_path("scene_assets/MedievalBoat.xml")
        _require_reference(xml)
        return scene_from_graph(load_scenegraph(xml), _reference_path("scene_assets"),
                                device=device)
    mesh = torus_cornell_mesh() if args.scene == "torus" else torus_cornell_mesh(30, 18)
    return scene_from_packed(pack_scene(mesh), device), cornell_box_camera()


def _settings(args):
    from pathtracer_tpu_torch.models.scene import RenderSettings

    extra = {} if args.spawn_chunk is None else {"spawn_chunk": args.spawn_chunk}
    return RenderSettings(width=args.size, height=args.size, samples_per_pixel=args.spp,
                          intersector=args.intersector, scheduler=args.scheduler, **extra)


def _device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _nvidia_smi() -> str | None:
    """nvidia-smi's ``name, power.limit`` of each card, where it exists."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def headline(args, scene, camera, settings, device) -> dict:
    """The timed render of ``--scheduler`` -> the result line's fields."""
    from pathtracer_tpu_torch.ops import rng
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
    from pathtracer_tpu_torch.ops.integrator import radiance_batch_stats
    from pathtracer_tpu_torch.ops.wavefront import render_pool
    from pathtracer_tpu_torch.utils.profiling import trace

    size, spp = args.size, args.spp
    n_pixels = size * size
    frame = ray_frame_tensors(camera, size, size, device)
    traced = trace(args.trace) if args.trace else contextlib.nullcontext()
    launches = {}

    if args.scheduler == "regen":
        def render():
            _, n_rays, iters = render_pool(
                scene, frame, settings, n_pixels=n_pixels,
                batch=min(settings.batch_size, n_pixels * spp), rays_per_pixel=spp)
            _sync(device)
            return n_rays, iters

        render()  # the builds and first calls' set-up
        with traced, _counting_launches(launches):
            walls, outs = _timed(render, args.repeat)
        rays = _one_count(n for n, _ in outs)
        iterations = outs[0][1]
    else:
        pixel_ids = torch.arange(n_pixels, dtype=torch.int64, device=device)

        def wave(s: int):
            sample_ids = torch.full_like(pixel_ids, s)
            jitter = rng.pixel_jitter_hash(pixel_ids, sample_ids)
            o, d = generate_rays(frame, size, size, pixel_ids, jitter)
            rad, n_rays = radiance_batch_stats(scene, settings, o, d, pixel_ids, sample_ids)
            return torch.clamp(rad, min=0.0), n_rays

        for s in range(args.warmup):
            wave(s)
        _sync(device)
        walls, counts = [], []
        with traced, _counting_launches(launches):
            for _ in range(max(1, args.repeat)):
                acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
                waves = []
                t0 = time.perf_counter()
                for s in range(spp):
                    r, n_rays = wave(s)
                    acc = acc + r
                    waves.append(n_rays)
                _sync(device)
                walls.append(time.perf_counter() - t0)
                counts.append(waves)
        rays = _one_count(int(torch.stack(waves).sum()) for waves in counts)
        iterations = spp  # waves

    best = min(walls)
    result = {
        "metric": "rays_per_sec_per_chip",
        "value": rays / best,
        "unit": "rays/s",
        "workload": f"{args.scene}_{size}x{size}_spp{spp}",
        "paths_per_sec": n_pixels * spp / best,
        "wall_s": best,
        "walls_s": walls,
        "wall_median_s": statistics.median(walls),
        "rays": rays,
        "iterations": iterations,
        "launches": launches,
        "device": _device_name(device),
        "intersector": args.intersector,
        "scheduler": args.scheduler,
    }
    if torch.device(device).type == "cuda":
        result["nvidia_smi"] = _nvidia_smi()
    if args.trace:
        result["trace_dir"] = args.trace
    return result


def _time_sharded(args, scene, camera, settings, mesh, barrier=None):
    """The pool sharded over ``mesh``: once untimed, then ``--repeat`` times
    timed -> (walls, rays, pool iterations)."""
    from pathtracer_tpu_torch.parallel.render import render_pool_sharded_stats

    def render():
        mean, n_rays, iters = render_pool_sharded_stats(scene, camera, settings, mesh)
        _sync(mean.device)
        return n_rays, iters

    render()
    walls, outs = _timed(render, args.repeat, barrier)
    return walls, _one_count(n for n, _ in outs), outs[0][1]


def sharded_worker(args, out_path: str) -> int:
    """One worker of ``--sharded`` over several devices: join the group
    (``PT_TPU_*``, set by ``run_workers``), time this device's shard of the
    pool between barriers; process 0 writes the walls and rays to
    ``out_path``."""
    import torch.distributed as dist

    from pathtracer_tpu_torch.parallel import distributed, launch
    from pathtracer_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize()
    try:
        device = torch.device(launch.worker_device())
        scene, camera = _scene(args, device)
        mesh = make_mesh([device])
        walls, rays, iters = _time_sharded(args, scene, camera, _settings(args), mesh,
                                           barrier=distributed.sync_global_devices)
        if distributed.process_index() == 0:
            with open(out_path, "w") as f:
                json.dump({"n_devices": mesh.size, "walls_s": walls, "rays": rays,
                           "iterations": iters}, f)
    finally:
        dist.destroy_process_group()
    return 0


def sharded(args, argv, devices, scene, camera, settings) -> dict:
    """The ``sharded`` field: the pool over ``devices`` (one process each
    when there are several) against one device doing 1/n of the work."""
    from pathtracer_tpu_torch.parallel.launch import run_workers
    from pathtracer_tpu_torch.parallel.mesh import make_mesh

    n = len(devices)
    if n == 1:
        walls, rays, _ = _time_sharded(args, scene, camera, settings, make_mesh(devices))
        rps = rays / min(walls)
        return {"n_devices": 1, "rays": rays, "walls_s": walls, "rays_per_sec": rps,
                "rays_per_sec_per_device": rps, "single_device_same_work_rays_per_sec": rps,
                "efficiency": 1.0}
    with tempfile.TemporaryDirectory(prefix="bench_sharded_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        rc = run_workers([os.path.abspath(__file__), *argv, "--worker-out", out], devices)
        if rc != 0:
            raise SystemExit(f"--sharded: a worker exited {rc}")
        with open(out) as f:
            workers = json.load(f)
    rps = workers["rays"] / min(workers["walls_s"])
    # Weak scaling through the same code: one device, ceil(spp / n) samples.
    d_settings = dataclasses.replace(settings, samples_per_pixel=-(-args.spp // n))
    d_walls, d_rays, _ = _time_sharded(args, scene, camera, d_settings,
                                       make_mesh(devices[:1]))
    denom = d_rays / min(d_walls)
    return {"n_devices": workers["n_devices"], "devices": list(devices),
            "rays": workers["rays"], "walls_s": workers["walls_s"],
            "iterations": workers["iterations"], "rays_per_sec": rps,
            "rays_per_sec_per_device": rps / n,
            "single_device_same_work_rays_per_sec": denom,
            "single_device_walls_s": d_walls, "efficiency": rps / n / denom}


def large_scene(args, device) -> dict:
    """The MedievalBoat render at 512^2 spp 4 (BASELINE config 4)."""
    from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_graph
    from pathtracer_tpu_torch.models.scenegraph import load_scenegraph
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    xml = _reference_path("scene_assets/MedievalBoat.xml")
    _require_reference(xml)
    scene, camera = scene_from_graph(load_scenegraph(xml), _reference_path("scene_assets"),
                                     device=device)
    st = RenderSettings(width=512, height=512, samples_per_pixel=4,
                        intersector=args.intersector)

    def render():
        _, n_rays, _ = render_regenerative_stats(scene, camera, st)
        _sync(device)
        return n_rays

    render()
    walls, counts = _timed(render, args.repeat)
    return {"workload": "medieval_boat_512x512_spp4", "tris": scene.num_tris,
            "rays_per_sec": _one_count(counts) / min(walls), "wall_s": min(walls),
            "walls_s": walls, "intersector": args.intersector}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument(
        "--scene", default="cornell", choices=("cornell", "boat", "torus", "band"),
        help="cornell: procedural CornellBox twin (36 tris); torus: + a 12,580-triangle "
        "torus (12,800 padded, MedievalBoat's stand-in); band: + a 1,116-triangle torus "
        "(1,152 padded, glossy's stand-in); boat: MedievalBoat.xml (reference checkout)",
    )
    p.add_argument("--warmup", type=int, default=2, help="untimed waves of the scan")
    p.add_argument("--repeat", type=int, default=3,
                   help="timed renders; the best is the value, all are in walls_s")
    p.add_argument("--intersector", default="auto")
    p.add_argument("--scheduler", default="regen", choices=("regen", "scan"))
    p.add_argument("--spawn-chunk", type=int, default=None,
                   help="override RenderSettings.spawn_chunk (samples per lane spawn)")
    p.add_argument(
        "--device", action="append", default=None,
        help="torch device (default cuda); with --sharded, once per shard (default: every "
        "visible card); the headline runs on the first",
    )
    for name, default_help in (
        ("sharded", "also time the pool sharded over the devices, one process each when "
                    "there are several (default: on for cornell with regen)"),
        ("boat", "also render MedievalBoat at 512^2 spp 4 (reference checkout)"),
        ("mse", "also render the six final configs and report MSE (reference checkout)"),
    ):
        group = p.add_mutually_exclusive_group()
        group.add_argument(f"--{name}", dest=name, action="store_true", default=None,
                           help=default_help)
        group.add_argument(f"--no-{name}", dest=name, action="store_false")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed region")
    p.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.worker_out:
        return sharded_worker(args, args.worker_out)
    do_sharded = args.sharded
    if do_sharded is None:
        do_sharded = args.scene == "cornell" and args.scheduler == "regen"
    if args.device:
        devices = args.device
    else:
        from pathtracer_tpu_torch.parallel.launch import visible_cards

        devices = visible_cards() if do_sharded else ["cuda"]
    if len(devices) > 1 and not do_sharded:
        raise SystemExit("--device is given more than once only with --sharded")
    device = torch.device(devices[0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (pass --device cpu to run on the CPU)")

    scene, camera = _scene(args, device)
    settings = _settings(args)
    result = headline(args, scene, camera, settings, device)
    if do_sharded:
        result["sharded"] = sharded(args, argv, devices, scene, camera, settings)
    if args.boat:
        result["large_scene"] = large_scene(args, device)
    if args.mse:
        mse_out = {name: _render_config_mse(name, device=device) for name in FINAL_CONFIGS}
        # BASELINE.json north-star point: CornellBox 512^2 @ 1024 spp.
        mse_out["cornell_box_full_lighting_spp1024"] = _render_config_mse(
            "cornell_box_full_lighting", spp_override=1024, device=device)
        result["mse"] = mse_out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
