#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pathtracer_tpu_torch``) on one GPU.

    python chip_smoke.py

Phases, one line of output each or more (any failure raises and exits
non-zero):

1. device    -- a CUDA device is present; prints nvidia-smi's name and power
                limit.
2. build     -- nvcc builds the kernels from ``pathtracer_tpu_torch/csrc``, one
                process per source, all started together.
3. kernel    -- the small-scene kernel against its plain torch version on the
                card, on 262,144 rays (Cornell camera rays + random rays inside
                the box) and three scenes (36, 37 and 250 triangles): t
                bit-equal, ids, normals, materials and occlusion flags equal;
                both timed.
4. cli       -- ``pathtracer_tpu_torch.cli`` renders Cornell-box files written
                to a temporary directory at 128^2, spp 8 through the kernel.
5. cpu       -- the card's render equals the CPU port's at 32^2, spp 4: equal
                rays traced, 99% of pixels within 1e-4, tonemapped MSE <= 1e-4.
6. headline  -- Cornell box at 512^2, spp 16, depth 17, regen, 2^18 lanes,
                with the kernel ("auto") and the plain sweep ("brute"): equal
                rays traced, image MSE <= 1e-6; wall time and rays/s of each.
7. shortlist -- the shortlist kernel against its plain torch twin and the brute
                sweep on the torus stand-ins (12,580 and 2,276 triangles), on
                the 262,144 rays of phase 3 and on a batch of 262,143: t 0 ULP
                from both, ids equal on hit lanes, occlusion equal; all timed.
                Then against brute on a 65,572-triangle stand-in (516
                clusters, above the earlier 415-cluster cap) on 65,535 of those
                rays, timed beside its bound; ptxas's registers, shared memory
                and spills of the kernel and its resident warps per SM; the
                kernel takes the wrapper's MAX_CLUSTERS and refuses one more.
8. cli-large -- the CLI renders the 12,580-triangle stand-in's files at 128^2,
                spp 4 through the shortlist kernel.
9. large     -- the 12,580-triangle stand-in at 512^2, spp 4, depth 17, regen,
                2^18 lanes: "auto" (the kernel, rays sorted) against
                "shortlist" (the plain twin, rays sorted): equal rays traced,
                image MSE <= 1e-6; "auto" with ray_sort "off": equal rays
                traced in equal pool iterations; wall time and rays/s of each.
                One more "auto" render under torch.profiler: shortlist kernel
                ms per render, device busy (the union of the device's kernel
                and copy intervals) and its share of the unprofiled walls.
10. oracles  -- the tiled kernel ("pallas"), both entries, against its plain
                versions (the brute sweeps), the tiled kernel's earlier
                design (the brute tiled sweep of
                csrc/baseline/intersect_tiled_sweep.cu, built alone) against
                brute, and the cluster kernel ("cluster") against its plain
                twin and brute, on the 262,144 rays of phase 3 and on
                262,143, on the Cornell box, the band stand-in (1,116
                triangles, 1,152 padded) and both torus stand-ins: t 0 ULP,
                ids equal on hit lanes; the any-hit entry's occlusion and
                hit_any equal brute's, with cutoffs around the nearest hit
                and with every seventh cutoff 0; all timed, the any-hit entry
                and the shortlist kernel on the band stand-in too. Then the
                tiled kernel against brute on phase 7's 516-cluster
                stand-in at 65,535 rays (no cap), timed; ptxas's registers
                and spills of the tiled kernel and its resident warps per SM.
11. band     -- the band stand-in at 512^2, spp 4, depth 17, regen, 2^18
                lanes through "auto", "pallas", "cluster", "shortlist_pallas"
                and "brute", each once after a warm-up: equal rays traced,
                image MSE <= 1e-6 against brute; "auto" launched the kernel it
                resolves to; wall time and rays/s of each. One more "auto"
                render, then one under torch.profiler: tiled kernel ms per
                render (closest and occluded), device busy and its share of
                the unprofiled walls, device intervals per pool iteration.
12. cli-oracles -- the CLI renders the band stand-in's files at 128^2, spp 4
                with --intersector pallas and with --intersector cluster; each
                launches its kernel.

``--band-pairs N`` adds N rounds of phase 11's renders with "pallas",
"pallas" with the pool's ray sort on, "cluster", "shortlist_pallas" and
"brute", in turn forward and backward order, and prints each route's median
and quartile walls and how many rounds it beat brute in: the measurement
behind ``auto``'s route in the band and its ray-sort rule.

The build phase also builds the port's native host library (the BVH builder
and OBJ parser, ``pathtracer_tpu_torch/native``) and prints its path, and,
beside the kernel library, the tiled kernel's earlier design.

The line before the last is the kernels' JSON record: per kernel entry point
its launches in one render of its cell, its error against its plain version,
its time and its plain version's at 262,144 rays, and the bound of
``pathtracer_tpu_torch/roofline.py`` for the same inputs with its share of
the time (no PyTorch call computes closest hit, so ``library_ms`` is null). The last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_RAYS = 1 << 18
TIMED_LAUNCHES = 20
TIMED_PLAIN = 3  # the shortlist phase's plain twin and brute sweep are slow
# Image sides of phase 8's CLI render and phase 9's renders.
CLI_LARGE_SIZE = 128
LARGE_SIZE = 512
# Phase 11's routes, and the kernel family each launches.
BAND_ROUTES = ("auto", "pallas", "cluster", "shortlist_pallas", "brute")
FAMILY = {"small_pallas": "small", "shortlist_pallas": "shortlist", "pallas": "tiled",
          "cluster": "cluster", "brute": None}
# --band-pairs candidates beyond BAND_ROUTES, by their settings.
SORTED_PALLAS = "pallas, rays sorted"
ROUTE_SETTINGS = {SORTED_PALLAS: {"intersector": "pallas", "ray_sort": "on"}}
# The tiled kernel's earlier design, built alone under another entry name.
BASELINE_SOURCE = "baseline/intersect_tiled_sweep.cu"
BASELINE_ENTRY = "pt_tiled_sweep_closest"
# Phase 7's scene above the earlier 415-cluster cap, and its batch.
LARGEST_MESH = (256, 128)  # torus_cornell_mesh: 65,572 triangles, 516 clusters
LARGEST_RAYS = (1 << 16) - 1


def launch_counts() -> dict:
    """Every kernel's launch counts by family."""
    from pathtracer_tpu_torch.ops import (
        intersect_cluster,
        intersect_shortlist_kernel,
        intersect_small,
        intersect_tiled,
    )

    return {"small": intersect_small.launches, "shortlist": intersect_shortlist_kernel.launches,
            "tiled": intersect_tiled.launches, "cluster": intersect_cluster.launches}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for counts in launch_counts().values():
        for k in counts:
            counts[k] = 0


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


def kernel_bound(scene, o, d, t_stop, occluded=None):
    """(bound ms, "operations" or "bytes") of a closest-hit call (``occluded``
    None, ``t_stop`` the brute t) or an any-hit call (``t_stop`` the cutoff)
    on these rays, by ``roofline``'s one definition."""
    from pathtracer_tpu_torch import roofline

    tests = roofline.tests_needed(scene, o, d, t_stop, occluded)
    rows = -(-scene.padded_tris // roofline.CLUSTER) * roofline.CLUSTER
    return roofline.bound_ms(tests, o.shape[0], rows, occluded is not None)


def ptxas_report() -> dict:
    """ptxas's register, shared-memory and spill lines by kernel entry."""
    from pathtracer_tpu_torch import kernels

    report, entry = {}, "?"
    for ln in kernels.build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "registers" in ln or "spill" in ln:
            report.setdefault(entry, []).append(ln.split("info    : ")[-1].strip())
    return report


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
        bound = {"closest": kernel_bound(scene, o, d, tp),
                 "occluded": kernel_bound(scene, o, d, t_cut, occ_p)}
        records[name] = (ms, err, bound)
        log("kernel", f"{name} T={scene.num_tris} rays={N_RAYS} hits={hits} "
            f"occluded={n_occ}: t 0 ULP (bit-equal), ids/normals/materials/occ/"
            f"hit_any equal; closest {ms['closest']:.4f} ms vs plain "
            f"{ms['closest_plain']:.4f} ms; occluded {ms['occluded']:.4f} ms vs "
            f"plain {ms['occluded_plain']:.4f} ms; {bound_text(ms, bound)}")
    return records


def bound_text(ms, bound) -> str:
    """Each entry's bound, what bounds it, and the share of it reached."""
    return "; ".join(f"{k} bound {b:.6f} ms ({by}), share {b / ms[k]:.4f}"
                     for k, (b, by) in bound.items())


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
        reset_launches()
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


def stand_in_scenes(dev):
    """Phase 7's scenes: (name, Scene), padded to 12,800 and 2,560 triangles."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    out = []
    for name, mesh, padded in (("torus12580", torus_cornell_mesh(), 12800),
                               ("torus2276", torus_cornell_mesh(40, 28), 2560)):
        scene = scene_from_packed(pack_scene(mesh), dev)
        assert scene.padded_tris == padded, (name, scene.padded_tris)
        out.append((name, scene))
    return out


def tie_report(scene, o, d, got, ref, lanes) -> str:
    """For lanes whose ids differ: how many of the two triangles' t tie."""
    from pathtracer_tpu_torch.ops.intersect import moller_trumbore

    def t_of(ids):
        ts = []
        for lane, tri in zip(lanes.tolist(), ids[lanes].tolist()):
            s = slice(tri, tri + 1)
            t, _ = moller_trumbore(o[lane : lane + 1], d[lane : lane + 1], scene.tri_v0[s],
                                   scene.tri_e1[s], scene.tri_e2[s], scene.tri_valid[s])
            ts.append(t.item())
        return ts

    ties = sum(a == b for a, b in zip(t_of(got), t_of(ref)))
    return f"{lanes.numel()} lanes differ, {ties} of them at tied t"


def assert_same_hits(label, scene, o, d, t, tri, ref_name, ref) -> None:
    """``t`` 0 ULP from ``ref``'s, ids equal on its hit lanes and -1 on the
    others."""
    t_r, id_r = ref
    ulp = ulp_distance(t, t_r)
    assert ulp == 0, f"{label}: t differs from {ref_name} by {ulp} ULP"
    hit = torch.isfinite(t_r)
    lanes = torch.nonzero((tri != id_r) & hit).squeeze(1)
    assert lanes.numel() == 0, (
        f"{label}: tri_id differs from {ref_name}: " + tie_report(scene, o, d, tri, id_r, lanes))
    assert bool((tri[~hit] == -1).all()), f"{label}: a miss lane's id is not -1"


def phase_shortlist(dev):
    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_shortlist as twin
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk

    o, d, cut_scale = smoke_rays(dev)
    records = {}
    scenes = stand_in_scenes(dev)
    for name, scene in scenes:
        for n in (N_RAYS, N_RAYS - 1):
            oo, dd = o[:n], d[:n]
            t, tri = sk.closest_tri_shortlist_kernel(scene, oo, dd)
            refs = {"twin": twin.closest_tri_shortlist(scene, oo, dd),
                    "brute": tint.closest_tri_brute(scene, oo, dd)}
            torch.cuda.synchronize()
            for ref_name, ref in refs.items():
                assert_same_hits(f"{name} n={n}", scene, oo, dd, t, tri, ref_name, ref)
            t_b = refs["brute"][0]
            t_cut = torch.where(torch.isfinite(t_b), t_b, 1.0) * cut_scale[:n]
            occ = sk.occluded_tri_shortlist_kernel(scene, oo, dd, t_cut)
            occ_w = twin.occluded_tri_shortlist(scene, oo, dd, t_cut)
            occ_b, _ = tint._occluded_tri_brute(scene, oo, dd, t_cut)
            assert torch.equal(occ, occ_w), f"{name} n={n}: occluded differs from twin"
            assert torch.equal(occ, occ_b), f"{name} n={n}: occluded differs from brute"
            hits, n_occ = int(torch.isfinite(t).sum()), int(occ.sum())
            log("shortlist", f"{name} T={scene.num_tris} rays={n} hits={hits} "
                f"occluded={n_occ}: t 0 ULP from twin and brute, ids equal on hit "
                "lanes, occlusion equal to twin and brute")
            if n == N_RAYS:
                fin = torch.isfinite(refs["twin"][0])
                err = {"closest": (t[fin] - refs["twin"][0][fin]).abs().max().item()
                       if hits else 0.0,
                       "occluded": (occ.float() - occ_w.float()).abs().max().item()}
                cut = t_cut
                bound = {"closest": kernel_bound(scene, o, d, t_b),
                         "occluded": kernel_bound(scene, o, d, cut, occ_b)}

        ms = {
            "closest": event_ms(lambda: sk.closest_tri_shortlist_kernel(scene, o, d)),
            "closest_plain": event_ms(lambda: twin.closest_tri_shortlist(scene, o, d),
                                      TIMED_PLAIN),
            "closest_brute": event_ms(lambda: tint.closest_tri_brute(scene, o, d),
                                      TIMED_PLAIN),
            "occluded": event_ms(lambda: sk.occluded_tri_shortlist_kernel(scene, o, d, cut)),
            "occluded_plain": event_ms(
                lambda: twin.occluded_tri_shortlist(scene, o, d, cut), TIMED_PLAIN),
            "occluded_brute": event_ms(
                lambda: tint._occluded_tri_brute(scene, o, d, cut), TIMED_PLAIN),
        }
        records[name] = (ms, err, bound)
        log("shortlist", f"{name} at {N_RAYS} rays: closest {ms['closest']:.4f} ms vs "
            f"twin {ms['closest_plain']:.4f} ms vs brute {ms['closest_brute']:.4f} ms; "
            f"occluded {ms['occluded']:.4f} ms vs twin {ms['occluded_plain']:.4f} ms "
            f"vs brute {ms['occluded_brute']:.4f} ms; {bound_text(ms, bound)}")

    largest_scene_check(dev, o, d, cut_scale)

    lib = kernels.library()
    c = scenes[0][1].padded_tris // sk.CLUSTER
    for entry, lines in ptxas_report().items():
        if "shortlist" in entry:
            assert not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines), lines
            log("shortlist", f"ptxas {entry}: {'; '.join(lines)}")
    for any_hit, entry in ((0, "closest"), (1, "occluded")):
        # The wrapper's limit is the kernel's: it takes MAX_CLUSTERS, not one more.
        assert lib.pt_shortlist_blocks_per_sm(sk.MAX_CLUSTERS, any_hit) > 0
        assert lib.pt_shortlist_blocks_per_sm(sk.MAX_CLUSTERS + 1, any_hit) < 0
        blocks = lib.pt_shortlist_blocks_per_sm(c, any_hit)
        assert blocks > 0, f"occupancy query failed: {blocks}"
        p2 = 1 << (c - 1).bit_length()
        log("shortlist", f"{entry} at {c} clusters: {8 * p2} bytes of dynamic shared "
            f"memory per block, {blocks} resident blocks of 4 warps per SM = "
            f"{4 * blocks} warps")
    return records


def largest_scene_check(dev, o, d, cut_scale) -> None:
    """The kernel against brute on a scene above the earlier 415-cluster cap."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import scene_from_packed
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk

    scene = scene_from_packed(pack_scene(torus_cornell_mesh(*LARGEST_MESH)), dev)
    c = scene.padded_tris // sk.CLUSTER
    assert c > 415, c
    # Every fourth ray: camera rays and rays from inside the room.
    lanes = torch.arange(LARGEST_RAYS, device=dev) * 4
    oo, dd = o[lanes].contiguous(), d[lanes].contiguous()
    t, tri = sk.closest_tri_shortlist_kernel(scene, oo, dd)
    ref = tint.closest_tri_brute(scene, oo, dd)
    torch.cuda.synchronize()
    assert_same_hits(f"torus{scene.num_tris} n={LARGEST_RAYS}", scene, oo, dd, t, tri,
                     "brute", ref)
    t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * cut_scale[lanes]
    occ = sk.occluded_tri_shortlist_kernel(scene, oo, dd, t_cut)
    occ_b, _ = tint._occluded_tri_brute(scene, oo, dd, t_cut)
    assert torch.equal(occ, occ_b), "occluded differs from brute above 415 clusters"
    ms = {"closest": event_ms(lambda: sk.closest_tri_shortlist_kernel(scene, oo, dd)),
          "occluded": event_ms(lambda: sk.occluded_tri_shortlist_kernel(scene, oo, dd, t_cut))}
    bound = {"closest": kernel_bound(scene, oo, dd, ref[0]),
             "occluded": kernel_bound(scene, oo, dd, t_cut, occ_b)}
    log("shortlist", f"torus{scene.num_tris} ({c} clusters) rays={LARGEST_RAYS} "
        f"hits={int(torch.isfinite(t).sum())} occluded={int(occ.sum())}: t 0 ULP from "
        f"brute, ids equal on hit lanes, occlusion equal to brute; closest "
        f"{ms['closest']:.4f} ms, occluded {ms['occluded']:.4f} ms; {bound_text(ms, bound)}")


def phase_cli_large(dev):
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh, write_mesh_files
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk
    from pathtracer_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        ini = write_mesh_files(tmp, torus_cornell_mesh(), "torus")
        png = os.path.join(tmp, "cli.png")
        reset_launches()
        rc = cli.main([ini, "--size", str(CLI_LARGE_SIZE), "--spp", "4", "--out", png,
                       "--device", str(dev)])
        img = read_png(png)
    rose = dict(sk.launches)
    assert rc == 0, f"cli returned {rc}"
    assert img.shape == (CLI_LARGE_SIZE, CLI_LARGE_SIZE, 3), img.shape
    assert np.isfinite(img).all() and img.mean() > 0.01, img.mean()
    assert all(v > 0 for v in rose.values()), f"shortlist kernel not launched: {rose}"
    log("cli-large", f"12,580-triangle stand-in {CLI_LARGE_SIZE}^2 spp 4 PNG ok (mean "
        f"{img.mean():.4f}); shortlist kernel launches {rose}")


def phase_large(dev):
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera, torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats, sort_rays_on

    scene = scene_from_packed(pack_scene(torus_cornell_mesh()), dev)
    camera = cornell_box_camera()
    base = dict(samples_per_pixel=4, max_depth=17, rr_prob=0.9, scheduler="regen",
                batch_size=1 << 18)

    def run(label, size, **kw):
        st = RenderSettings(width=size, height=size, **base, **kw)
        reset_launches()
        (img, n, iters), wall = sync_time(
            lambda: render_regenerative_stats(scene, camera, st))
        counted = {**{f"shortlist_{k}": v for k, v in sk.launches.items()},
                   **{f"small_{k}": v for k, v in small.launches.items()}}
        assert torch.isfinite(img).all(), f"{label}: non-finite image"
        assert img.mean().item() > 0.01, f"{label}: image mean {img.mean().item()}"
        n = int(n)
        log("large", f"{label}: {size}x{size} spp 4, ray sort "
            f"{'on' if sort_rays_on(st, scene) else 'off'}: {wall:.4f} s, "
            f"{n / wall / 1e6:.2f} Mray/s, rays traced {n}, pool iterations {iters}, "
            f"kernel launches {counted}")
        return img, n, iters, wall, counted

    run("auto warm-up", LARGE_SIZE)
    kernel = run("auto (kernel)", LARGE_SIZE)
    launches = {k.removeprefix("shortlist_"): v for k, v in kernel[4].items()
                if k.startswith("shortlist_")}
    assert all(v > 0 for v in launches.values()), f"shortlist kernel not launched: {launches}"
    assert not any(v for k, v in kernel[4].items() if k.startswith("small_"))
    unsorted = run("auto, ray_sort off", LARGE_SIZE, ray_sort="off")
    assert unsorted[1:3] == kernel[1:3], (
        f"ray_sort off: rays {unsorted[1]} in {unsorted[2]} iterations vs "
        f"{kernel[1]} in {kernel[2]}")

    plain = run("shortlist (plain twin)", LARGE_SIZE, intersector="shortlist")
    assert not any(plain[4].values()), f"the twin launched a kernel: {plain[4]}"
    again = run("auto (kernel)", LARGE_SIZE)
    assert plain[1] == kernel[1], f"rays traced: kernel {kernel[1]} vs twin {plain[1]}"
    err = torch.mean((kernel[0] - plain[0]) ** 2).item()
    assert err <= 1e-6, f"image MSE kernel vs twin {err}"
    log("large", f"{LARGE_SIZE}^2: equal rays traced ({plain[1]}); image MSE "
        f"kernel vs twin {err:.3e}; {LARGE_SIZE}^2 ray sort off: equal rays ({unsorted[1]}) "
        f"and iterations ({unsorted[2]}); kernel walls {kernel[3]:.4f}, {again[3]:.4f} s")

    profiled = profiled_render(
        lambda: run("auto (kernel), profiled", LARGE_SIZE), "shortlist_kernel",
        lambda out: {k.removeprefix("shortlist_"): v for k, v in out[4].items()
                     if k.startswith("shortlist_")})
    assert profiled[0][1:3] == kernel[1:3], "the profiled render traced other rays"
    log("large", "profiled render " + profile_text(profiled[1], kernel[2],
                                                   [kernel[3], again[3]]))
    return launches


def device_spans(prof) -> list:
    """(start us, end us, name) of the device intervals of a torch.profiler
    run, in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def entry_spans(spans, kernel: str = "shortlist_kernel") -> dict:
    """The durations (us) in ``spans`` of a kernel templated on its any-hit
    flag (the shortlist or the tiled kernel), by entry."""
    # The entry's template flag, demangled (<true>) or not (ILb1E).
    return {k: [b - a for a, b, nm in spans if kernel in nm
                and (f"<{flag}>" in nm or f"ILb{int(flag == 'true')}E" in nm)]
            for k, flag in (("closest", "false"), ("occluded", "true"))}


def profiled_render(render, kernel: str, launched):
    """``render()`` under torch.profiler -> (its result, (spans, the durations
    of ``kernel``'s entries)); each entry's spans must number its launches,
    ``launched(result)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = render()
    spans = device_spans(prof)
    ks = entry_spans(spans, kernel)
    assert {k: len(v) for k, v in ks.items()} == launched(out), (
        {k: len(v) for k, v in ks.items()}, launched(out))
    return out, (spans, ks)


def profile_text(profile, iters: int, walls) -> str:
    """A profiled render's device intervals, its kernel's ms per render by
    entry, device busy (the union of the device intervals) and its share of
    the median of the unprofiled ``walls``."""
    spans, ks = profile
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    wall = float(np.median(walls))
    ms = {k: sum(v) / 1e3 for k, v in ks.items()}
    return (f"({len(spans)} device intervals, {len(spans) / iters:.1f} per pool "
            f"iteration): kernel {ms['closest'] + ms['occluded']:.3f} ms per render "
            f"(closest {ms['closest']:.3f} ms in {len(ks['closest'])} launches, occluded "
            f"{ms['occluded']:.3f} ms in {len(ks['occluded'])}); device busy "
            f"{busy_us / 1e3:.3f} ms, busy share {busy_us / 1e3 / (wall * 1e3):.4f} of the "
            f"unprofiled median wall {wall:.4f} s")


def band_mesh():
    """The band stand-in: 1,116 triangles, padded to 1,152 as the glossy
    final's, between the small kernel's 256 and the shortlist's 2048."""
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh

    return torus_cornell_mesh(30, 18)


def band_scene(dev):
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    scene = scene_from_packed(pack_scene(band_mesh()), dev)
    assert (scene.num_tris, scene.padded_tris) == (1116, 1152), scene.padded_tris
    return scene


def start_baseline_build():
    """Start nvcc on the tiled kernel's earlier design, alone, its entry
    renamed to BASELINE_ENTRY -> (library path, process)."""
    from pathtracer_tpu_torch import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libpt_tiled_sweep.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
           f"-Dpt_tiled_closest={BASELINE_ENTRY}", "-shared", "-o", so,
           os.path.join(kernels.CSRC, BASELINE_SOURCE)]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)


def load_baseline(build):
    """Wait for ``start_baseline_build``'s nvcc -> its loaded entry."""
    import ctypes

    so, proc = build
    out, _ = proc.communicate()
    assert proc.returncode == 0, f"nvcc failed on {BASELINE_SOURCE}:\n{out}"
    fn = getattr(ctypes.CDLL(so), BASELINE_ENTRY)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [p, p, p, i, i, p, p, p], i
    return fn


def baseline_closest(entry, scene, o, d):
    """The earlier design's closest hit -> (t, tri_id); it counts no launch
    (it is not on any path of the port)."""
    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops.intersect_shortlist_kernel import kernel_table

    table, _ = kernel_table(scene)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    tri_id = torch.empty(b, dtype=torch.int64, device=o.device)
    rc = entry(o.data_ptr(), d.data_ptr(), table.data_ptr(), table.shape[0], b, t.data_ptr(),
               tri_id.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "the tiled kernel's earlier design")
    return t, tri_id


def check_tiled_occluded(label, scene, o, d, t_b, cut_scale):
    """The any-hit entry, with and without hit_any, equals the brute sweep on
    cutoffs ``t_b * cut_scale`` and on the same with every seventh cutoff 0
    -> (the first cutoffs, brute's occlusion on them)."""
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    t_cut = torch.where(torch.isfinite(t_b), t_b, 1.0) * cut_scale
    parked = t_cut.clone()
    parked[::7] = 0.0
    occluded = []
    for cut in (t_cut, parked):
        occ_b, any_b = tint._occluded_tri_brute(scene, o, d, cut)
        occluded.append(occ_b)
        for want_any in (False, True):
            occ, hit_any = it.occluded_tri_tiled(scene, o, d, cut, want_any)
            torch.cuda.synchronize()
            assert torch.equal(occ, occ_b), f"{label}: tiled occluded differs from brute"
            if want_any:
                assert torch.equal(hit_any, any_b), f"{label}: tiled hit_any differs from brute"
    return t_cut, occluded[0]


def phase_oracles(dev, baseline):
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_cluster as ic
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    o, d, cut_scale = smoke_rays(dev)
    # kernel, its plain version (None: the brute sweep itself)
    kernels = {"tiled": (it.closest_tri_tiled, None),
               "cluster": (ic.closest_tri_cluster, ic.closest_tri_cluster_plain),
               "earlier tiled": (lambda sc, oo, dd: baseline_closest(baseline, sc, oo, dd),
                                 None)}
    scenes = [smoke_scenes(dev)[0], ("band1152", band_scene(dev)), *stand_in_scenes(dev)]
    records = {}
    for name, scene in scenes:
        for n in (N_RAYS, N_RAYS - 1):
            oo, dd = o[:n], d[:n]
            brute = tint.closest_tri_brute(scene, oo, dd)
            err = {}
            for kname, (kernel, plain) in kernels.items():
                t, tri = kernel(scene, oo, dd)
                refs = {"brute": brute}
                if plain is not None:
                    refs["plain"] = plain(scene, oo, dd)
                torch.cuda.synchronize()
                for ref_name, ref in refs.items():
                    assert_same_hits(f"{kname} {name} n={n}", scene, oo, dd, t, tri,
                                     ref_name, ref)
                t_p = refs.get("plain", brute)[0]
                fin = torch.isfinite(t_p)
                err[kname] = (t[fin] - t_p[fin]).abs().max().item() if fin.any() else 0.0
            t_cut, occ_b = check_tiled_occluded(f"{name} n={n}", scene, oo, dd, brute[0],
                                                cut_scale[:n])
            log("oracles", f"{name} T={scene.num_tris} rays={n} "
                f"hits={int(torch.isfinite(brute[0]).sum())} occluded={int(occ_b.sum())}: "
                "tiled, its earlier design and cluster t 0 ULP from their plain versions "
                "and brute, ids equal on hit lanes; tiled occlusion and hit_any equal "
                "brute's (cutoffs around the hit, and every seventh 0)")
            if n == N_RAYS:
                cut = t_cut
                bound = {"closest": kernel_bound(scene, o, d, brute[0]),
                         "occluded": kernel_bound(scene, o, d, cut, occ_b)}
                occ_err = (it.occluded_tri_tiled(scene, o, d, cut)[0].float()
                           - occ_b.float()).abs().max().item()
                errors = {"tiled": {"closest": err["tiled"], "occluded": occ_err},
                          "cluster": {"closest": err["cluster"]}}
        ms = {
            "tiled": event_ms(lambda: it.closest_tri_tiled(scene, o, d)),
            "tiled_plain": event_ms(lambda: tint.closest_tri_brute(scene, o, d), TIMED_PLAIN),
            "tiled_occluded": event_ms(lambda: it.occluded_tri_tiled(scene, o, d, cut)),
            "tiled_occluded_plain": event_ms(
                lambda: tint._occluded_tri_brute(scene, o, d, cut), TIMED_PLAIN),
            "earlier": event_ms(lambda: baseline_closest(baseline, scene, o, d)),
            "cluster": event_ms(lambda: ic.closest_tri_cluster(scene, o, d)),
            "cluster_plain": event_ms(lambda: ic.closest_tri_cluster_plain(scene, o, d),
                                      TIMED_PLAIN),
        }
        tiled_ms = {"closest": ms["tiled"], "closest_plain": ms["tiled_plain"],
                    "occluded": ms["tiled_occluded"],
                    "occluded_plain": ms["tiled_occluded_plain"]}
        records[name] = (tiled_ms, {"closest": ms["cluster"], "closest_plain": ms["cluster_plain"]},
                         errors, bound)
        (b, by), (bo, byo) = bound["closest"], bound["occluded"]
        log("oracles", f"{name} at {N_RAYS} rays: tiled closest {ms['tiled']:.4f} ms vs its "
            f"earlier design {ms['earlier']:.4f} ms vs plain (brute) {ms['tiled_plain']:.4f} "
            f"ms; tiled occluded {ms['tiled_occluded']:.4f} ms vs plain (brute) "
            f"{ms['tiled_occluded_plain']:.4f} ms; cluster {ms['cluster']:.4f} ms vs twin "
            f"{ms['cluster_plain']:.4f} ms; closest bound {b:.6f} ms ({by}), share tiled "
            f"{b / ms['tiled']:.4f}, earlier {b / ms['earlier']:.4f}, cluster "
            f"{b / ms['cluster']:.4f}; occluded bound {bo:.6f} ms ({byo}), share tiled "
            f"{bo / ms['tiled_occluded']:.4f}")
        if name == "band1152":
            sl = {"closest": event_ms(lambda: sk.closest_tri_shortlist_kernel(scene, o, d)),
                  "occluded": event_ms(
                      lambda: sk.occluded_tri_shortlist_kernel(scene, o, d, cut))}
            log("oracles", f"{name} at {N_RAYS} rays: the shortlist kernel, which culls "
                f"the same way: closest {sl['closest']:.4f} ms, occluded "
                f"{sl['occluded']:.4f} ms; {bound_text(sl, bound)}")

    tiled_largest_check(dev, o, d, cut_scale)
    tiled_occupancy(scenes[1][1])
    return records


def tiled_largest_check(dev, o, d, cut_scale) -> None:
    """The tiled kernel against brute on phase 7's 516-cluster stand-in: no
    cap."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import scene_from_packed
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    scene = scene_from_packed(pack_scene(torus_cornell_mesh(*LARGEST_MESH)), dev)
    lanes = torch.arange(LARGEST_RAYS, device=dev) * 4
    oo, dd = o[lanes].contiguous(), d[lanes].contiguous()
    label = f"tiled torus{scene.num_tris} n={LARGEST_RAYS}"
    t, tri = it.closest_tri_tiled(scene, oo, dd)
    ref = tint.closest_tri_brute(scene, oo, dd)
    torch.cuda.synchronize()
    assert_same_hits(label, scene, oo, dd, t, tri, "brute", ref)
    t_cut, occ_b = check_tiled_occluded(label, scene, oo, dd, ref[0], cut_scale[lanes])
    ms = {"closest": event_ms(lambda: it.closest_tri_tiled(scene, oo, dd)),
          "occluded": event_ms(lambda: it.occluded_tri_tiled(scene, oo, dd, t_cut))}
    bound = {"closest": kernel_bound(scene, oo, dd, ref[0]),
             "occluded": kernel_bound(scene, oo, dd, t_cut, occ_b)}
    log("oracles", f"torus{scene.num_tris} ({scene.padded_tris // 128} tiles) "
        f"rays={LARGEST_RAYS} hits={int(torch.isfinite(t).sum())} occluded="
        f"{int(occ_b.sum())}: tiled t 0 ULP from brute, ids equal on hit lanes, occlusion "
        f"and hit_any equal to brute; closest {ms['closest']:.4f} ms, occluded "
        f"{ms['occluded']:.4f} ms; {bound_text(ms, bound)}")


def tiled_occupancy(scene) -> None:
    """ptxas's registers and spills of the tiled kernel's entries (none may
    spill) and their resident warps per SM on ``scene``'s tiles."""
    from pathtracer_tpu_torch import kernels

    for entry, lines in ptxas_report().items():
        if "tiled_kernel" in entry:
            assert not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines), lines
            log("oracles", f"ptxas {entry}: {'; '.join(lines)}")
    c = scene.padded_tris // 128
    for any_hit, entry in ((0, "closest"), (1, "occluded")):
        blocks = kernels.library().pt_tiled_blocks_per_sm(c, any_hit)
        assert blocks > 0, f"occupancy query failed: {blocks}"
        log("oracles", f"tiled {entry} at {c} tiles: {blocks} resident blocks of 4 warps "
            f"per SM = {4 * blocks} warps")


def band_render(dev, size: int = LARGE_SIZE):
    """Phase 11's render: (run(intersector) -> (image, rays, iterations, wall,
    launches by family), scene)."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    scene, camera = band_scene(dev), cornell_box_camera()
    base = dict(samples_per_pixel=4, max_depth=17, rr_prob=0.9, scheduler="regen",
                batch_size=1 << 18)

    def run(route, side=size):
        kw = ROUTE_SETTINGS.get(route, {"intersector": route})
        st = RenderSettings(width=side, height=side, **kw, **base)
        reset_launches()
        (img, n, iters), wall = sync_time(
            lambda: render_regenerative_stats(scene, camera, st))
        counted = {fam: dict(c) for fam, c in launch_counts().items()}
        assert torch.isfinite(img).all(), f"{route}: non-finite image"
        assert img.mean().item() > 0.01, f"{route}: image mean {img.mean().item()}"
        return img, int(n), iters, wall, counted

    return run, scene


def phase_band(dev, pairs: int):
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops.intersect import resolve_intersector

    run, scene = band_render(dev)
    resolved = resolve_intersector(RenderSettings(), scene)
    for route in BAND_ROUTES:
        run(route, CLI_LARGE_SIZE)  # warm-up: tables, kernels' first launches
    results = {}
    for route in BAND_ROUTES:
        img, n, iters, wall, counted = results[route] = run(route)
        fam = FAMILY[resolved if route == "auto" else route]
        for f, counts in counted.items():
            assert all((v > 0) == (f == fam) for v in counts.values()), (route, counted)
        log("band", f"{route}{f' (-> {resolved})' if route == 'auto' else ''}: "
            f"{LARGE_SIZE}^2 spp 4: {wall:.4f} s, {n / wall / 1e6:.2f} Mray/s, rays traced "
            f"{n}, pool iterations {iters}, kernel launches "
            f"{ {f: c for f, c in counted.items() if any(c.values())} }")
    img_b, n_b = results["brute"][:2]
    for route, (img, n, *_rest) in results.items():
        assert n == n_b, f"rays traced: {route} {n} vs brute {n_b}"
        err = torch.mean((img - img_b) ** 2).item()
        assert err <= 1e-6, f"image MSE {route} vs brute {err}"
    log("band", f"equal rays traced ({n_b}); image MSE <= 1e-6 against brute for every route")
    again = run("auto")
    fam = FAMILY[resolved]
    profiled, profile = profiled_render(lambda: run("auto"), f"{fam}_kernel",
                                        lambda out: out[4][fam])
    assert profiled[1:3] == results["auto"][1:3], "the profiled render traced other rays"
    log("band", f"auto (-> {resolved}) walls {results['auto'][3]:.4f}, {again[3]:.4f} s; "
        "profiled render " + profile_text(profile, profiled[2],
                                          [results["auto"][3], again[3]]))
    if pairs:
        band_pairs(run, pairs)
    return {route: results[route][4][FAMILY[route]] for route in ("pallas", "cluster")}


def band_pairs(run, rounds: int) -> None:
    """``rounds`` rounds of the band render through each candidate and brute,
    forward and backward in turn; medians, quartiles and wins over the
    round's brute."""
    routes = (BAND_ROUTES[1], SORTED_PALLAS, *BAND_ROUTES[2:])  # the candidates, then brute
    walls = {r: [] for r in routes}
    for i in range(rounds):
        for route in (routes if i % 2 == 0 else routes[::-1]):
            walls[route].append(run(route)[3])
    brute = walls["brute"]
    for route in routes:
        q1, med, q3 = np.percentile(walls[route], [25, 50, 75])
        wins = sum(w < b for w, b in zip(walls[route], brute))
        log("band-pairs", f"{route}: median {med:.4f} s (quartiles {q1:.4f}-{q3:.4f}), "
            f"faster than the round's brute in {wins} of {rounds}; walls "
            f"{[round(w, 4) for w in walls[route]]}")
    best = min(routes, key=lambda r: np.median(walls[r]))
    wins = {r: sum(a < b for a, b in zip(walls[best], walls[r])) for r in routes if r != best}
    log("band-pairs", f"fastest median: {best}; faster than each other route in the same "
        f"round in {wins} of {rounds}")


def phase_cli_oracles(dev):
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import write_mesh_files
    from pathtracer_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        ini = write_mesh_files(tmp, band_mesh(), "band")
        for route in ("pallas", "cluster"):
            png = os.path.join(tmp, f"{route}.png")
            reset_launches()
            rc = cli.main([ini, "--size", str(CLI_LARGE_SIZE), "--spp", "4", "--out", png,
                           "--device", str(dev), "--intersector", route])
            img = read_png(png)
            counted = {f: dict(c) for f, c in launch_counts().items()}
            assert rc == 0, f"cli returned {rc}"
            assert img.shape == (CLI_LARGE_SIZE, CLI_LARGE_SIZE, 3), img.shape
            assert np.isfinite(img).all() and img.mean() > 0.01, img.mean()
            for f, counts in counted.items():
                assert all((v > 0) == (f == FAMILY[route]) for v in counts.values()), counted
            log("cli-oracles", f"band stand-in {CLI_LARGE_SIZE}^2 spp 4 --intersector {route}: "
                f"PNG ok (mean {img.mean():.4f}); {FAMILY[route]} kernel launches "
                f"{counted[FAMILY[route]]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--band-pairs", type=int, default=0, metavar="N",
                   help="rounds of the paired band measurement after phase 11")
    args = p.parse_args(argv)
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

    baseline_build = start_baseline_build()
    kernels.library()
    ptxas = [f"{entry}: {ln}" for entry, lines in ptxas_report().items()
             for ln in lines if "registers" in ln]
    log("build", f"nvcc built {os.path.basename(kernels.library_path())} in "
        f"{kernels.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")
    baseline = load_baseline(baseline_build)
    log("build", f"nvcc built the tiled kernel's earlier design ({BASELINE_SOURCE}) as "
        f"{BASELINE_ENTRY}")
    from pathtracer_tpu_torch import native

    assert native.get_lib() is not None, "the port's native host library did not load"
    log("build", f"g++ built and loaded the native host library {native.library_path()}")

    ms = phase_kernels(dev)
    phase_cli(dev)
    phase_cpu(dev)
    launches = phase_headline(dev)
    sl_ms = phase_shortlist(dev)
    phase_cli_large(dev)
    sl_launches = phase_large(dev)
    or_ms = phase_oracles(dev, baseline)
    band_launches = phase_band(dev, args.band_pairs)
    phase_cli_oracles(dev)

    tiled_ms, cluster_ms, or_err, or_bound = or_ms["band1152"]
    rows = []
    for family, source, replaces, counts, (k_ms, k_err, k_bound) in (
        ("intersect_small", "pathtracer_tpu_torch/csrc/intersect_small.cu",
         "pathtracer_tpu/ops/intersect_small_pallas.py:176", launches, ms["cornell36"]),
        ("intersect_shortlist", "pathtracer_tpu_torch/csrc/intersect_shortlist.cu",
         "pathtracer_tpu/ops/intersect_shortlist_pallas.py:425", sl_launches,
         sl_ms["torus12580"]),
        ("intersect_tiled", "pathtracer_tpu_torch/csrc/intersect_tiled.cu",
         "pathtracer_tpu/ops/intersect_pallas.py:120", band_launches["pallas"],
         (tiled_ms, or_err["tiled"], or_bound)),
        ("intersect_cluster", "pathtracer_tpu_torch/csrc/intersect_cluster.cu",
         "pathtracer_tpu/ops/intersect_cluster.py:182", band_launches["cluster"],
         (cluster_ms, or_err["cluster"], or_bound)),
    ):
        for entry in counts:
            bound, by = k_bound[entry]
            rows.append({"name": f"{family}_{entry}", "route": "cuda", "source": source,
                         "replaces": replaces, "launches": counts[entry],
                         "max_abs_err": k_err[entry], "ms": k_ms[entry],
                         "plain_ms": k_ms[f"{entry}_plain"], "bound_ms": bound,
                         "bound_by": by, "bound_share": bound / k_ms[entry],
                         "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
