#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathtracer_tpu_torch``) on one GPU.

    python chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

1. device   -- a CUDA device is present; prints nvidia-smi's name and power limit.
2. build    -- nvcc builds the kernels from ``pathtracer_tpu_torch/csrc``.
3. kernel   -- each kernel against its plain torch version on the card, on
               262,144 rays (Cornell camera rays + random rays inside the box)
               and three scenes (36, 37 and 250 triangles): t bit-equal, ids,
               normals, materials and occlusion flags equal; both timed.
4. cli      -- ``pathtracer_tpu_torch.cli`` renders Cornell-box files written
               to a temporary directory at 128^2, spp 8 through the kernel.
5. cpu      -- the card's render equals the CPU port's at 32^2, spp 4: equal
               rays traced, 99% of pixels within 1e-4, tonemapped MSE <= 1e-4.
6. headline -- Cornell box at 512^2, spp 16, depth 17, regen, 2^18 lanes,
               with the kernel ("auto") and the plain sweep ("brute"): equal
               rays traced, image MSE <= 1e-6; wall time and rays/s of each.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_RAYS = 1 << 18
TIMED_LAUNCHES = 20


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean device milliseconds per call of ``fn`` over ``n`` calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def smoke_scenes(dev):
    """The three scenes of phase 3: (name, Scene)."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import (
        cornell_box_mesh,
        cornell_box_plus_one_mesh,
        triangle_soup_mesh,
    )
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    meshes = [("cornell36", cornell_box_mesh()),
              ("cornell37", cornell_box_plus_one_mesh()),
              ("soup250", triangle_soup_mesh(250, seed=7))]
    return [(name, scene_from_packed(pack_scene(m), dev)) for name, m in meshes]


def smoke_rays(dev):
    """262,144 rays: Cornell camera rays (off the quad-diagonal seams) and
    random rays from points inside the box."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

    half = N_RAYS // 2
    frame = ray_frame_tensors(cornell_box_camera(), 512, 512, dev)
    pix = torch.arange(half, device=dev) * 2
    jitter = torch.tensor([[0.371, 0.613]], device=dev).expand(half, 2)
    o_cam, d_cam = generate_rays(frame, 512, 512, pix, jitter)
    rng = np.random.default_rng(11)
    o_in = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (half, 3))
    d_in = rng.normal(size=(half, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.as_tensor(o_in, dtype=torch.float32, device=dev)])
    d = torch.cat([d_cam, torch.as_tensor(d_in, dtype=torch.float32, device=dev)])
    cut_scale = torch.as_tensor(rng.uniform(0.5, 1.5, N_RAYS), dtype=torch.float32,
                                device=dev)
    return o.contiguous(), d.contiguous(), cut_scale


def ulp_distance(a, b) -> int:
    """Largest ULP distance between two f32 tensors over lanes where both are
    finite (a non-finite mismatch counts as infinitely far)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return 1 << 31
    ia = a[fa].view(torch.int32).to(torch.int64)
    ib = b[fb].view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def phase_kernels(dev):
    from pathtracer_tpu_torch.ops import intersect_small as small

    o, d, cut_scale = smoke_rays(dev)
    records = {}
    for name, scene in smoke_scenes(dev):
        t, tri, n, m = small.closest_tri_small(scene, o, d)
        tp, trip, np_, mp = small.closest_tri_small_plain(scene, o, d)
        torch.cuda.synchronize()
        ulp = ulp_distance(t, tp)
        assert ulp == 0, f"{name}: t differs from the plain version by {ulp} ULP"
        assert torch.equal(tri, trip), f"{name}: tri_id differs"
        assert torch.equal(n, np_), f"{name}: n_geo differs"
        assert torch.equal(m, mp), f"{name}: mat_id differs"
        t_cut = torch.where(torch.isfinite(tp), tp, 1.0) * cut_scale
        for want_any in (False, True):
            occ, hit_any = small.occluded_tri_small(scene, o, d, t_cut, want_any)
            occ_p, any_p = small.occluded_tri_small_plain(scene, o, d, t_cut, want_any)
            assert torch.equal(occ, occ_p), f"{name}: occluded differs"
            if want_any:
                assert torch.equal(hit_any, any_p), f"{name}: hit_any differs"
        hits, n_occ = int(torch.isfinite(t).sum()), int(occ.sum())
        fin = torch.isfinite(tp)
        err = {
            "closest": (t[fin] - tp[fin]).abs().max().item() if hits else 0.0,
            "occluded": (occ.float() - occ_p.float()).abs().max().item(),
        }

        ms = {
            "closest": event_ms(lambda: small.closest_tri_small(scene, o, d)),
            "closest_plain": event_ms(lambda: small.closest_tri_small_plain(scene, o, d)),
            "occluded": event_ms(lambda: small.occluded_tri_small(scene, o, d, t_cut)),
            "occluded_plain": event_ms(
                lambda: small.occluded_tri_small_plain(scene, o, d, t_cut)),
        }
        records[name] = (ms, err)
        log("kernel", f"{name} T={scene.num_tris} rays={N_RAYS} hits={hits} "
            f"occluded={n_occ}: t 0 ULP (bit-equal), ids/normals/materials/occ/"
            f"hit_any equal; closest {ms['closest']:.4f} ms vs plain "
            f"{ms['closest_plain']:.4f} ms; occluded {ms['occluded']:.4f} ms vs "
            f"plain {ms['occluded_plain']:.4f} ms")
    return records


def phase_cli(dev):
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        ini = write_cornell_box_files(tmp)
        png = os.path.join(tmp, "cli.png")
        before = dict(small.launches)
        rc = cli.main([ini, "--size", "128", "--spp", "8", "--out", png,
                       "--device", str(dev)])
        img = read_png(png)
    assert rc == 0, f"cli returned {rc}"
    assert img.shape == (128, 128, 3), img.shape
    assert np.isfinite(img).all() and img.mean() > 0.01, img.mean()
    rose = {k: small.launches[k] - before[k] for k in before}
    assert all(v > 0 for v in rose.values()), f"kernel not launched by the CLI: {rose}"
    log("cli", f"128x128 spp 8 PNG ok (mean {img.mean():.4f}); kernel launches {rose}")


def phase_cpu(dev):
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops.tonemap import tonemap_reference
    from pathtracer_tpu_torch.render import render_stats

    settings = RenderSettings(width=32, height=32, samples_per_pixel=4, max_depth=17)
    out = {}
    for device in (dev, torch.device("cpu")):
        scene, camera = cornell_box_scene(device=device)
        img, n = render_stats(scene, camera, settings)
        out[device.type] = (img.cpu(), int(n))
    (ig, ng), (ic, nc) = out["cuda"], out["cpu"]
    assert ng == nc, f"rays traced: card {ng} vs cpu {nc}"
    close = ((ig - ic).abs().amax(-1) <= 1e-4).float().mean().item()
    assert close >= 0.99, f"only {close:.4f} of pixels within 1e-4"
    err = torch.mean((tonemap_reference(ig) - tonemap_reference(ic)) ** 2).item()
    assert err <= 1e-4, f"tonemapped MSE {err}"
    log("cpu", f"32x32 spp 4: rays traced {ng} on both; {close:.4f} of pixels "
        f"within 1e-4; tonemapped MSE {err:.3e}")


def phase_headline(dev):
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    scene, camera = cornell_box_scene(device=dev)
    base = dict(width=512, height=512, samples_per_pixel=16, max_depth=17,
                rr_prob=0.9, scheduler="regen", batch_size=1 << 18)
    paths = 512 * 512 * 16

    def run(intersector):
        st = RenderSettings(intersector=intersector, **base)
        (img, n, iters), wall = sync_time(
            lambda: render_regenerative_stats(scene, camera, st))
        return img, int(n), iters, wall

    run("auto")  # warm-up
    results, launches = {}, None
    for intersector in ("brute", "auto", "auto", "brute"):
        for k in small.launches:
            small.launches[k] = 0
        img, n, iters, wall = run(intersector)
        counted = dict(small.launches)
        if intersector == "auto" and launches is None:
            launches = counted  # the main path's run
        expect_kernel = intersector == "auto"
        assert all((v > 0) == expect_kernel for v in counted.values()), counted
        assert torch.isfinite(img).all(), f"{intersector}: non-finite image"
        results.setdefault(intersector, []).append((img, n, iters, wall))
        log("headline", f"{intersector}: 512x512 spp 16: {wall:.4f} s, "
            f"{n / wall / 1e6:.2f} Mray/s, {paths / wall / 1e6:.2f} Mpaths/s, "
            f"rays traced {n}, pool iterations {iters}, kernel launches {counted}")
    img_k, n_k = results["auto"][0][:2]
    img_b, n_b = results["brute"][0][:2]
    assert n_k == n_b, f"rays traced: kernel {n_k} vs brute {n_b}"
    err = torch.mean((img_k - img_b) ** 2).item()
    assert err <= 1e-6, f"image MSE kernel vs brute {err}"
    walls = {k: [r[3] for r in v] for k, v in results.items()}
    log("headline", f"equal rays traced ({n_k}); image MSE kernel vs brute {err:.3e}; "
        f"wall auto {walls['auto']} s, brute {walls['brute']} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from pathtracer_tpu_torch import kernels

    kernels.library()
    ptxas = [ln.split("info    : ")[-1] for ln in kernels.build_log.splitlines()
             if "registers" in ln]
    log("build", f"nvcc built {os.path.basename(kernels.library_path())} in "
        f"{kernels.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")

    ms = phase_kernels(dev)
    phase_cli(dev)
    phase_cpu(dev)
    launches = phase_headline(dev)

    src = "pathtracer_tpu_torch/csrc/intersect_small.cu"
    replaces = "pathtracer_tpu/ops/intersect_small_pallas.py:176"
    main_ms, main_err = ms["cornell36"]
    print(json.dumps({"kernels": [
        {"name": "intersect_small_closest", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["closest"],
         "max_abs_err": main_err["closest"],
         "ms": main_ms["closest"], "plain_ms": main_ms["closest_plain"]},
        {"name": "intersect_small_occluded", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["occluded"],
         "max_abs_err": main_err["occluded"],
         "ms": main_ms["occluded"], "plain_ms": main_ms["occluded_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
