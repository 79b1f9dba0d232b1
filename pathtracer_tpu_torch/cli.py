"""Command-line renderer.

Port of ``pathtracer_tpu/cli.py``:

    python -m pathtracer_tpu_torch.cli scene_files/final/cornell_box_full_lighting.ini \
        --scene-root /path/to/reference --out out.png

The INI's ``output`` path is written when ``--out`` is not given. ``--device``
picks the torch device (default ``cuda``). ``--checkpoint PATH`` renders in
resumable chunks (``render.render_checkpointed``), ``--preview-png N`` writes
``<out>.preview_NNNN.png`` every N samples, and ``--serve PORT`` serves the
accumulating image over localhost HTTP (``utils.preview_server``).
``--sharded`` shards the render's rays over every visible card, or over the
devices ``--device`` names (it may then be given more than once): the regen
scheduler through ``parallel.render.render_pool_sharded``, the scan through
``render_sharded``. Over one device it renders in this process. Over several
it starts one worker process per device (``parallel.launch.run_workers``),
joined by ``torch.distributed`` (NCCL between cards, gloo where two workers
share a card or on the CPU), so the devices work at the same time; each
worker renders its slice of the rays, process 0 writes the PNG, and a worker
that fails makes the CLI exit non-zero. A process started with the
``PT_TPU_*`` variables of ``parallel.distributed`` set is one such worker.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PyTorch/CUDA path tracer")
    p.add_argument("ini", help="render config (.ini)")
    p.add_argument("--scene-root", default=None, help="root for /scene_assets refs")
    p.add_argument("--out", default=None, help="output PNG (default: INI output)")
    p.add_argument("--spp", type=int, default=None, help="override samplesPerPixel")
    p.add_argument("--size", type=int, default=None, help="override square resolution")
    p.add_argument(
        "--intersector",
        default="auto",
        choices=(
            "auto", "brute", "small_pallas", "shortlist",
            "shortlist_pallas", "bvh", "pallas", "cluster",
        ),
        help="auto = on a CUDA device the small-scene kernel for <= 256 "
        "triangles, the tiled kernel (pallas) up to 2047 and the shortlist "
        "kernel (shortlist_pallas) for >= 2048 padded triangles; on the CPU "
        "the shortlist's torch twin (shortlist) for >= 2048, else the plain "
        "brute sweep. pallas = the CUDA tiled "
        "sweep (csrc/intersect_tiled.cu), cluster = the CUDA cluster cull "
        "(csrc/intersect_cluster.cu); on the CPU both run their plain torch "
        "versions. bvh = the BVH walk in torch ops (an oracle, on any device)",
    )
    p.add_argument(
        "--seed", type=int, default=0,
        help="RNG stream seed (0 = the goldens' stream)",
    )
    p.add_argument("--tonemap", default="reference")
    p.add_argument(
        "--scheduler", default="regen", choices=("regen", "scan"),
        help="regen = regenerative wavefront pool; scan = fixed-depth wave "
        "per sample",
    )
    p.add_argument(
        "--checkpoint", default=None,
        help="path for resumable accumulation state (.npz)",
    )
    p.add_argument(
        "--preview-png", type=int, default=0, metavar="N",
        help="write the tonemapped partial image every N samples "
        "(<out>.preview_NNNN.png)",
    )
    p.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="serve a live auto-refreshing preview of the accumulating "
        "render at http://127.0.0.1:PORT/ while rendering (0: a free port, "
        "printed)",
    )
    p.add_argument(
        "--sharded", action="store_true",
        help="shard the rays over every visible card, or over the --device "
        "entries given; several devices render at the same time, one worker "
        "process each (two workers may share a card: --device cuda:0 "
        "--device cuda:0)",
    )
    p.add_argument(
        "--light-sampling",
        default="compat",
        choices=("compat", "area"),
        help="compat = reference's count-based light pdf; area = corrected",
    )
    p.add_argument(
        "--shadow-mode",
        default="fast",
        choices=("fast", "closest"),
        help="fast = occlusion test; closest = reference semantics",
    )
    p.add_argument(
        "--glossy-brdf",
        default="phong",
        choices=("phong", "beckmann"),
        help="glossy lobe: reference Phong, or corrected Beckmann microfacet",
    )
    p.add_argument(
        "--device", action="append", default=None,
        help="torch device to render on (cuda, cuda:N or cpu; default cuda); "
        "with --sharded it may be given once per shard",
    )
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    group = False
    if args.sharded:
        from pathtracer_tpu_torch.parallel import distributed, launch

        distributed.initialize()  # a worker of run_workers joins its group here
        group = distributed.is_initialized()
        devices = [launch.worker_device()] if group else args.device or launch.visible_cards()
        if (group or len(devices) > 1) and (args.checkpoint or args.preview_png
                                            or args.serve is not None):
            p.error("--checkpoint, --preview-png and --serve render on one device")
        if len(devices) > 1:
            return launch.run_workers(["-m", "pathtracer_tpu_torch.cli", *argv], devices)
        device = devices[0]
    elif args.device and len(args.device) > 1:
        p.error("--device is given more than once only with --sharded")
    else:
        device = args.device[0] if args.device else "cuda"
    try:
        return _render(args, device, group)
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _render(args, device: str, group: bool) -> int:
    """Render ``args``' scene on ``device`` and write the PNG (in a group of
    workers: this worker's shard, and process 0 writes)."""
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.ops.tonemap import TONEMAPS
    from pathtracer_tpu_torch.render import render_checkpointed, render_image
    from pathtracer_tpu_torch.utils.image import to_uint8, write_png

    overrides = dict(
        intersector=args.intersector,
        scheduler=args.scheduler,
        shadow_mode=args.shadow_mode,
        glossy_brdf=args.glossy_brdf,
        seed=args.seed,
    )
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.size is not None:
        overrides["width"] = args.size
        overrides["height"] = args.size
    if args.light_sampling == "area":
        overrides["compat_count_light_pdf"] = False

    scene, camera, settings, ini = load_scene(
        args.ini, scene_root=args.scene_root, device=device, **overrides
    )
    print(
        f"scene: {ini.scene} | {scene.num_tris} tris "
        f"({scene.padded_tris} padded), {scene.num_analytic} analytic prims, "
        f"BVH depth {scene.bvh_depth}"
    )
    print(
        f"render: {settings.width}x{settings.height} @ "
        f"{settings.samples_per_pixel} spp, rr={settings.rr_prob}, "
        f"direct_only={settings.direct_lighting_only}"
    )

    def progress(done, total):
        if done % max(1, total // 10) == 0 or done == total:
            print(f"  sample {done}/{total}", file=sys.stderr)

    out = args.out or ini.output or "render.png"
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    server = None
    if args.serve is not None:
        from pathtracer_tpu_torch.utils.preview_server import PreviewServer

        server = PreviewServer(port=args.serve)
        print(f"live preview: http://127.0.0.1:{server.port}/", file=sys.stderr)

    def preview(done_spp, mean):
        img = TONEMAPS[args.tonemap](mean).cpu().numpy()
        if args.preview_png:
            stem, ext = os.path.splitext(out)
            path = f"{stem}.preview_{done_spp:04d}{ext or '.png'}"
            write_png(path, img)
            print(f"  preview {done_spp} spp -> {path}", file=sys.stderr)
        if server is not None:
            server.update(to_uint8(img), done_spp, settings.samples_per_pixel)

    if group:
        from pathtracer_tpu_torch.parallel.distributed import process_index, sync_global_devices

        sync_global_devices("start")
    t0 = time.perf_counter()
    if args.checkpoint:
        mean = render_checkpointed(
            scene, camera, settings, args.checkpoint, progress_callback=progress
        )
        img = TONEMAPS[args.tonemap](mean).cpu().numpy()
    elif args.sharded:
        from pathtracer_tpu_torch.parallel.mesh import make_mesh
        from pathtracer_tpu_torch.parallel.render import render_pool_sharded, render_sharded

        mesh = make_mesh([device])  # in a group of workers: spans the group
        if settings.scheduler == "regen":
            mean = render_pool_sharded(scene, camera, settings, mesh)
        else:
            mean = render_sharded(scene, camera, settings, mesh, progress_callback=progress)
        img = TONEMAPS[args.tonemap](mean).cpu().numpy()
    else:
        preview_every = args.preview_png or (1 if server is not None else 0)
        img = render_image(
            scene, camera, settings, tonemap=args.tonemap,
            progress_callback=progress,
            preview_every=preview_every,
            preview_fn=preview if preview_every else None,
        )
    if group:
        sync_global_devices("rendered")
    dt = time.perf_counter() - t0
    if group and process_index() != 0:
        return 0

    n_rays = settings.width * settings.height * settings.samples_per_pixel
    print(f"rendered in {dt:.2f}s ({n_rays / dt / 1e6:.2f} Mpaths/s)")

    write_png(out, img)
    print(f"wrote {out}")
    if server is not None:
        server.update(
            to_uint8(img), settings.samples_per_pixel,
            settings.samples_per_pixel, done=True,
        )
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
