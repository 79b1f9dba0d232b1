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
                the box, about a quarter of the lanes parked as the integrator
                parks dead lanes) and on 262,143 of them, on three scenes (36,
                37 and 250 triangles): t bit-equal, ids, normals, materials,
                occlusion and hit_any equal, with cutoffs around the nearest
                hit and with every seventh cutoff 0; the lanes the kernel
                swept equal its skip rule's (lanes_to_sweep); both entries
                timed beside their bounds (graph_ms: a wrapper call takes
                longer on the host than the kernel on the card, so 100 calls
                are replayed as one CUDA graph; the Cornell box's closest
                entry also by events and host clock around back-to-back
                calls); ptxas's registers and spills, the resident warps per
                SM and the instructions of each entry's row loop (cuobjdump).
4. cli       -- ``pathtracer_tpu_torch.cli`` renders Cornell-box files written
                to a temporary directory at 128^2, spp 8 through the kernel.
5. cpu       -- the card's render equals the CPU port's at 32^2, spp 4: equal
                rays traced, 99% of pixels within 1e-4, tonemapped MSE <= 1e-4.
6. headline  -- Cornell box at 512^2, spp 16, depth 17, regen, 2^18 lanes,
                with the kernel ("auto") and the plain sweep ("brute"): equal
                rays traced, image MSE <= 1e-6; wall time and rays/s of each;
                the share of launched lanes the kernel skipped in the warm-up
                render. One more "auto" render under torch.profiler: small
                kernel ms per render (closest and occluded), device busy and
                its share of the unprofiled walls, device intervals per pool
                iteration.
7. shortlist -- the shortlist kernel against its plain torch twin and the brute
                sweep on the torus stand-ins (12,580 and 2,276 triangles), on
                phase 3's 262,144 rays with none parked and on a batch of
                262,143: t 0 ULP
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
10. oracles  -- the tiled ("pallas") and cluster ("cluster") kernels, both
                entries each, against the brute sweeps and their plain
                versions (the tiled kernel's are the brute sweeps, the
                cluster kernel's its twin and t < t_cut, isfinite(t) of it),
                on the 262,144 rays of phase 7 and on 262,143, on the Cornell
                box, the band stand-in (1,116 triangles, 1,152 padded) and
                both torus stand-ins: closest t 0 ULP, ids equal on hit lanes;
                occlusion and hit_any equal, with cutoffs around the nearest
                hit and with every seventh cutoff 0 (lanes where the twin
                misses brute's answer, a defect of the JAX kernel's cull, are
                printed with their inputs and compared with brute only). All
                four entries timed on those rays and on the same sorted as
                the pool sorts its lanes on the cluster route, beside the
                bound and the plain versions; the shortlist kernel on the
                band stand-in too. Then the same checks and times on phase
                7's 516-cluster stand-in at 65,535 rays (no cap); ptxas's
                registers and spills of both kernels and their resident warps
                per SM.
11. band     -- the band stand-in at 512^2, spp 4, depth 17, regen, 2^18
                lanes through "auto", "pallas", "cluster", "shortlist_pallas"
                and "brute", each once after a warm-up: equal rays traced,
                image MSE <= 1e-6 against brute; "auto" launched the kernel it
                resolves to; wall time and rays/s of each. For "auto" and
                "cluster", one more render, then one under torch.profiler:
                kernel ms per render (closest and occluded, one launch of
                each per pool iteration), device busy and its share of the
                unprofiled walls, device intervals per pool iteration.
12. cli-oracles -- the CLI renders the band stand-in's files at 128^2, spp 4
                with --intersector pallas and with --intersector cluster; each
                launches its kernel.

13. threefry  -- the threefry generator: keys, jitter and 7 bounce uniforms
                (per-lane depths 0-16 and a scalar depth) on 262,144 lanes
                with seeds 0 and 7, bit-equal to the CPU port's; one bounce's
                uniform draw at 262,144 lanes, threefry beside hash (device ms
                of a CUDA graph, and back-to-back calls by events); the
                Cornell headline's shape (512^2, spp 16, depth 17, regen,
                2^18 lanes) with rng="threefry" through "auto" (the small
                kernel launched) and "brute": equal rays traced, image MSE <=
                1e-6; beside the hash "auto" render: tonemapped MSE and image
                means of the two streams within STREAMS_*; walls and rays/s.
14. bvh      -- the BVH oracle (intersector="bvh", torch ops) against brute on
                the Cornell box, the band stand-in and the 12,580-triangle
                torus stand-in, on phase 10's 262,144 rays and on 262,143: hit
                masks equal, t within BVH_RTOL / BVH_ATOL (and its ULP
                distance printed), ids equal but on tied lanes (counted); ms
                per call and loop iterations beside the tiled and shortlist
                kernels' times on the same rays; the band stand-in at 128^2,
                spp 4 through "bvh" and "brute": equal rays, image MSE <=
                1e-6, no kernel launched; walls.
15. cli-extras -- Cornell files at 128^2, spp 8: a render cut after its first
                chunk through render_checkpointed and resumed by the CLI's
                --checkpoint writes the straight CLI render's PNG (up to one
                8-bit step on at most 0.1% of the values: summation order);
                --preview-png 2 writes the three preview files; a --serve 0
                run exits 0; a PreviewServer on a free port answers /status
                and /latest.png (read by read_png); profiling.trace around a
                render writes a Chrome trace with the small kernel in it, and
                profiling.timed gives a positive wall.

17. parallel -- ``pathtracer_tpu_torch.parallel``: (a) a one-process NCCL
                group (``distributed.initialize``) and ``make_mesh()``: the
                Cornell headline's shape through ``render_pool_sharded_stats``
                against the unsharded ``render_stats``, in turns: equal rays
                traced, image MSE <= 1e-6, the small kernel launched; walls of
                both. (b) One process, three shards on the card
                (``make_mesh([cuda] * 3)``): the band and 12,580-triangle
                stand-ins at 128^2, spp 4 through the sharded pool (equal
                rays, MSE <= 1e-6, the tiled and shortlist kernels launched;
                walls), the sharded scan at 64^2, spp 2 bit-equal to the
                unsharded scan, and one training step (32^2, depth 9, over four
                shards: 1,024 rows) with gradients within 1e-5 of each field's
                max |g| of the unsharded step's. (c) Two processes on the card
                over gloo (NCCL refuses two ranks on one GPU), this script
                run again with ``--parallel-worker`` by
                ``parallel.launch.run_workers``, one shard each: Cornell
                128^2, spp 8, depth 17 equal to the single-process render
                within rtol 3e-5 / atol 3e-6, with equal rays; both exit 0.
                (d) The CLI's ``--sharded`` at 128^2, spp 8 writes the plain
                CLI's PNG (up to one 8-bit step on at most 0.1% of values).
18. bench    -- ``bench_torch.py`` in subprocesses, as a benchmark runs it:
                the Cornell headline (512^2, spp 16, regen: 29,723,280 rays
                in 76 pool iterations), the same with ``--scheduler scan``
                (rays equal to the sum of its waves' counts, traced here),
                the torus and band stand-ins at 512^2, spp 4 (7,613,742 and
                7,616,286 rays in 29 iterations) and the perf canary's spp 8
                run (14,871,501 in 45), each having launched its cell's
                kernel and no other; walls, median and Mray/s of each. Then
                ``--sharded`` over two workers sharing the card (gloo) at
                128^2, spp 8: the one-process run's rays; walls and
                efficiency. Then the CLI's ``--sharded --device cuda:0
                --device cuda:0`` (two workers) against the plain CLI at
                128^2, spp 8: the scan's PNG equal on every value, the
                pool's within one 8-bit step on at most 0.1% of them.

``--band-pairs N`` adds N rounds of phase 11's renders with "pallas",
"pallas" with the pool's ray sort on, "cluster", "shortlist_pallas" and
"brute", in turn forward and backward order, and prints each route's median
and quartile walls and how many rounds it beat brute in: the measurement
behind ``auto``'s route in the band and its ray-sort rule.

The build phase also builds the port's native host library (the BVH builder
and OBJ parser, ``pathtracer_tpu_torch/native``) and prints its path.

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
import urllib.request

import numpy as np
import torch

from pathtracer_tpu_torch.kernels import launch_counts, reset_launches

N_RAYS = 1 << 18
TIMED_LAUNCHES = 20
TIMED_PLAIN = 3  # the shortlist phase's plain twin and brute sweep are slow
PARKED_SHARE = 0.25  # phase 3's parked lanes, about the Cornell render's share
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
# Phase 7's scene above the earlier 415-cluster cap, and its batch.
LARGEST_MESH = (256, 128)  # torus_cornell_mesh: 65,572 triangles, 516 clusters
LARGEST_RAYS = (1 << 16) - 1


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


def graph_ms(fn, n: int = 100, rounds: int = 5) -> float:
    """Device milliseconds per call of ``fn``, for a kernel shorter than its
    wrapper's host time (where back-to-back calls time the host): ``n``
    calls captured in one CUDA graph, each replay timed by events; the
    median over ``rounds`` replays."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / n)
    return float(np.median(means))


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


def park_lanes(o, d):
    """``o``, ``d`` with about PARKED_SHARE of the lanes, scattered, parked as
    the integrator parks dead lanes (origin 1e6, direction +x: a sure miss)."""
    lanes = torch.as_tensor(np.random.default_rng(13).random(o.shape[0]) < PARKED_SHARE,
                            device=o.device)[:, None]
    plus_x = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    return (torch.where(lanes, 1.0e6, o).contiguous(),
            torch.where(lanes, plus_x, d).contiguous())


def ulp_distance(a, b) -> int:
    """Largest ULP distance between two f32 tensors over lanes where both are
    finite (a non-finite mismatch counts as infinitely far)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return 1 << 31
    ia = a[fa].view(torch.int32).to(torch.int64)
    ib = b[fb].view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if ia.numel() else 0


def kernel_bound(scene, o, d, t_stop, occluded=None, out_bytes=None):
    """(bound ms, "operations" or "bytes") of a closest-hit call (``occluded``
    None, ``t_stop`` the brute t) or an any-hit call (``t_stop`` the cutoff)
    on these rays, by ``roofline``'s one definition."""
    from pathtracer_tpu_torch import roofline

    tests = roofline.tests_needed(scene, o, d, t_stop, occluded)
    rows = -(-scene.padded_tris // roofline.CLUSTER) * roofline.CLUSTER
    return roofline.bound_ms(tests, o.shape[0], rows, occluded is not None, out_bytes)


def host_ms(fn, n: int = 100) -> float:
    """Host milliseconds per call of ``fn``, calls back to back (the enqueue:
    no synchronize among them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def sass_loops(kernel: str) -> dict:
    """By entry of ``kernel`` in the built library ("closest", or "occluded"
    for ``<true>``): (instruction slots, their opcodes counted) of its
    innermost loop, the shortest span a backward branch closes, from
    ``cuobjdump -sass``; {} where the toolkit has no cuobjdump."""
    from pathtracer_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", kernels.library_path()], capture_output=True,
                          text=True, check=True).stdout
    loops = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        if kernel not in name:
            continue
        ins = [(int(a, 16), text) for a, text in re.findall(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", func)]
        spans = [(int(m.group(1), 16), a) for a, text in ins
                 if (m := re.search(r"\bBRA\b.*0x([0-9a-f]+)", text)) and int(m.group(1), 16) < a]
        lo, hi = min(spans, key=lambda s: s[1] - s[0])
        ops = {}
        for a, text in ins:
            if lo <= a <= hi:
                op = next(w for w in text.split() if not w.startswith("@")).split(".")[0]
                ops[op] = ops.get(op, 0) + 1
        entry = "occluded" if "ILb1E" in name else "closest"
        loops[entry] = (sum(ops.values()), dict(sorted(ops.items(), key=lambda kv: -kv[1])))
    return loops


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


def swept_lanes(fn, scene, o, d, t_cut=None, want_any=False):
    """``fn()`` with the small kernel counting the lanes it sweeps -> (its
    result, the share of lanes skipped); the lanes swept must be those of
    the kernel's rule, ``lanes_to_sweep``."""
    from pathtracer_tpu_torch.ops import intersect_small as small

    small.lane_counts = {}
    try:
        out = fn()
        ((launched, swept),) = small.lane_counts.values()
    finally:
        small.lane_counts = None
    swept, rule = int(swept), int(small.lanes_to_sweep(scene, o, d, t_cut, want_any).sum())
    assert swept == rule, f"the kernel swept {swept} lanes, its rule {rule}"
    return out, 1.0 - swept / launched


def small_kernel_checks(name, scene, o, d, cut_scale, entries=None):
    """Both entries of the small kernel against their plain versions on rays
    ``o``, ``d``: closest, then any-hit with and without hit_any on cutoffs
    around the nearest hit and on the same with every seventh 0 -> (plain
    t, the zeroed cutoffs and the plain occlusion on them, largest error by
    entry, share of lanes skipped by entry). ``entries`` (closest, occluded)
    stand in for the wrappers, a design variant's: then no lane is counted
    and the shares are None."""
    from pathtracer_tpu_torch.ops import intersect_small as small

    closest, occluded = entries or (small.closest_tri_small, small.occluded_tri_small)

    def run(fn, t_cut=None, want_any=False):
        return (fn(), None) if entries else swept_lanes(fn, scene, o, d, t_cut, want_any)

    (t, tri, n, m), skip_c = run(lambda: closest(scene, o, d))
    tp, trip, np_, mp = small.closest_tri_small_plain(scene, o, d)
    torch.cuda.synchronize()
    ulp = ulp_distance(t, tp)
    assert ulp == 0, f"{name}: t differs from the plain version by {ulp} ULP"
    assert torch.equal(tri, trip), f"{name}: tri_id differs"
    assert torch.equal(n, np_), f"{name}: n_geo differs"
    assert torch.equal(m, mp), f"{name}: mat_id differs"
    fin = torch.isfinite(tp)
    err = {"closest": (t[fin] - tp[fin]).abs().max().item() if fin.any() else 0.0,
           "occluded": 0.0}
    t_cut = torch.where(fin, tp, 1.0) * cut_scale
    zeroed = t_cut.clone()
    zeroed[::7] = 0.0
    skip_o = []
    for cut in (t_cut, zeroed):
        for want_any in (False, True):
            (occ, hit_any), skip = run(lambda: occluded(scene, o, d, cut, want_any),
                                       cut, want_any)
            occ_p, any_p = small.occluded_tri_small_plain(scene, o, d, cut, want_any)
            assert torch.equal(occ, occ_p), f"{name}: occluded differs"
            if want_any:
                assert torch.equal(hit_any, any_p), f"{name}: hit_any differs"
            err["occluded"] = max(err["occluded"],
                                  (occ.float() - occ_p.float()).abs().max().item())
            skip_o.append(skip)
    return tp, zeroed, occ_p, err, {"closest": skip_c, "occluded": skip_o[2]}


def phase_kernels(dev):
    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops import intersect_small as small

    o, d, cut_scale = smoke_rays(dev)
    o, d = park_lanes(o, d)
    records, scenes = {}, dict(smoke_scenes(dev))
    for name, scene in scenes.items():
        for n in (N_RAYS - 1, N_RAYS):  # the full batch last: its inputs are timed
            tp, cut, occ_p, err, skip = small_kernel_checks(
                f"{name} n={n}", scene, o[:n], d[:n], cut_scale[:n])
            hits, n_occ = int(torch.isfinite(tp).sum()), int(occ_p.sum())
            log("kernel", f"{name} T={scene.num_tris} rays={n} hits={hits} occluded={n_occ} "
                f"(every seventh cutoff 0): t 0 ULP (bit-equal), ids/normals/materials/occ/"
                f"hit_any equal, cutoffs around the hit and every seventh 0; lanes skipped "
                f"(as lanes_to_sweep): closest {skip['closest']:.4f}, occluded "
                f"{skip['occluded']:.4f}")
        ms = {
            "closest": graph_ms(lambda: small.closest_tri_small(scene, o, d)),
            "closest_plain": event_ms(lambda: small.closest_tri_small_plain(scene, o, d)),
            "occluded": graph_ms(lambda: small.occluded_tri_small(scene, o, d, cut)),
            "occluded_plain": event_ms(
                lambda: small.occluded_tri_small_plain(scene, o, d, cut)),
        }
        bound = {"closest": kernel_bound(scene, o, d, tp, out_bytes=24),
                 "occluded": kernel_bound(scene, o, d, cut, occ_p)}
        records[name] = (ms, err, bound)
        log("kernel", f"{name} at {N_RAYS} rays: closest {ms['closest']:.4f} ms vs plain "
            f"{ms['closest_plain']:.4f} ms; occluded {ms['occluded']:.4f} ms vs plain "
            f"{ms['occluded_plain']:.4f} ms; {bound_text(ms, bound)}")
    def closest():
        return small.closest_tri_small(scenes["cornell36"], o, d)

    log("kernel", "cornell36 closest, wrapper calls back to back: events "
        f"{event_ms(closest, 100):.4f} ms a call, host {host_ms(closest):.4f} ms a call, "
        f"against the kernel's {graph_ms(closest):.4f} ms (a CUDA graph of 100 calls)")
    for entry, (slots, ops) in sass_loops("small_kernel").items():
        log("kernel", f"SASS small_kernel {entry}: the row loop is {slots} instruction "
            f"slots: {ops}")
    for entry, lines in ptxas_report().items():
        if "small_kernel" in entry:
            assert not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines), lines
            log("kernel", f"ptxas {entry}: {'; '.join(lines)}")
    for any_hit, entry in ((0, "closest"), (1, "occluded")):
        warps = kernels.library().pt_small_warps_per_sm(any_hit)
        assert warps > 0, f"occupancy query failed: {warps}"
        log("kernel", f"small {entry}: {warps} resident warps per SM")
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

    small.lane_counts = {}  # the warm-up counts the lanes the kernel sweeps
    try:
        run("auto")
        counts = small.lane_counts
    finally:
        small.lane_counts = None
    skipped = {k: 1.0 - int(swept) / launched for k, (launched, swept) in counts.items()}
    log("headline", "auto warm-up: share of launched lanes the kernel skipped (root box "
        f"and cutoff): closest {skipped['closest']:.4f}, occluded {skipped['occluded']:.4f}")
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

    def counted_run():
        reset_launches()
        return run("auto"), dict(small.launches)

    (profiled, _), profile = profiled_render(counted_run, "small_kernel", lambda out: out[1])
    assert profiled[1:3] == results["auto"][0][1:3], "the profiled render traced other rays"
    log("headline", "profiled render " + profile_text(profile, profiled[2], walls["auto"]))
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


def tied_lanes(scene, o, d, tri, t_ref, id_ref):
    """Lanes whose id differs from the reference's -> (their count, how many
    of them tie: the other triangle's t equals the reference's)."""
    from pathtracer_tpu_torch.ops.intersect import mt_components

    lanes = torch.nonzero((tri != id_ref) & torch.isfinite(t_ref)).squeeze(1)
    if lanes.numel() == 0:
        return 0, 0
    win = tri[lanes].clamp(min=0)
    oo, dd = o[lanes], d[lanes]
    v0, e1, e2 = scene.tri_v0[win], scene.tri_e1[win], scene.tri_e2[win]
    t, _ = mt_components(*(oo[:, i] for i in range(3)), *(dd[:, i] for i in range(3)),
                         *(v0[:, i] for i in range(3)), *(e1[:, i] for i in range(3)),
                         *(e2[:, i] for i in range(3)), tri[lanes] >= 0)
    return lanes.numel(), int((t == t_ref[lanes]).sum())


def assert_same_hits(label, scene, o, d, t, tri, ref_name, ref) -> None:
    """``t`` 0 ULP from ``ref``'s, ids equal on its hit lanes and -1 on the
    others."""
    t_r, id_r = ref
    ulp = ulp_distance(t, t_r)
    assert ulp == 0, f"{label}: t differs from {ref_name} by {ulp} ULP"
    hit = torch.isfinite(t_r)
    differ, ties = tied_lanes(scene, o, d, tri, t_r, id_r)
    assert differ == 0, (
        f"{label}: tri_id differs from {ref_name}: {differ} lanes differ, {ties} of them at "
        "tied t")
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
    flag (the small, shortlist, tiled or cluster kernel), by entry."""
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


def sorted_lanes(scene, o, d):
    """The order in which the pool sorts these lanes on the cluster route:
    ``wavefront._sort_key`` over ``_sort_bounds(scene)``, every lane alive,
    stable."""
    from pathtracer_tpu_torch.ops.wavefront import _sort_bounds, _sort_key

    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return torch.sort(_sort_key(o, d, alive, *_sort_bounds(scene)), stable=True).indices


def twin_defects(label, o, d, plain, brute):
    """Lanes where the cluster twin (the JAX kernel's cull, unwidened) misses
    the brute sweep's answer, each printed with its inputs: there brute is the
    kernels' contract, and the lane is a defect of the JAX kernel's cull."""
    (t_p, id_p), (t_b, id_b) = plain, brute
    bad = (t_p != t_b) | (torch.isfinite(t_b) & (id_p != id_b))
    for lane in torch.nonzero(bad).squeeze(1)[:8].tolist():
        log("oracles", f"{label}: the cluster twin misses lane {lane}: o {o[lane].tolist()} "
            f"d {d[lane].tolist()}: twin t {t_p[lane].item()!r} id {id_p[lane].item()}, "
            f"brute t {t_b[lane].item()!r} id {id_b[lane].item()}")
    return bad


def oracle_entries() -> dict:
    """family -> (closest entry, any-hit entry) of the tiled and cluster
    kernels' wrappers."""
    from pathtracer_tpu_torch.ops import intersect_cluster as ic
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    return {"tiled": (it.closest_tri_tiled, it.occluded_tri_tiled),
            "cluster": (ic.closest_tri_cluster, ic.occluded_tri_cluster)}


def check_oracles(label, scene, o, d, cut_scale):
    """Both entries of the tiled and cluster kernels against the brute sweeps
    and their plain versions (the tiled kernel's are the brute sweeps; the
    cluster kernel's the twin, and t < t_cut, isfinite(t) of it, compared on
    the lanes where the twin holds brute's answer): closest t 0 ULP, ids on
    hit lanes, -1 elsewhere; occlusion and hit_any equal, with and without
    hit_any, on cutoffs around brute's hit and on the same with every seventh
    0 -> (brute's t, the first cutoffs, brute's occlusion on them, each
    family's largest error against its plain version by entry, the twin's
    defect lanes)."""
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_cluster as ic

    brute = tint.closest_tri_brute(scene, o, d)
    twin = ic.closest_tri_cluster_plain(scene, o, d)
    torch.cuda.synchronize()
    every = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    keep = ~twin_defects(label, o, d, twin, brute)
    t_cut = torch.where(torch.isfinite(brute[0]), brute[0], 1.0) * cut_scale
    parked = t_cut.clone()
    parked[::7] = 0.0
    cuts = (t_cut, parked)
    flags = {"brute": [tint._occluded_tri_brute(scene, o, d, cut) for cut in cuts],
             "plain": [ic.occluded_tri_cluster_plain(scene, o, d, cut, True) for cut in cuts]}
    # family -> the references of its entries: (name, closest, flags, lanes)
    refs = {"tiled": [("brute", brute, flags["brute"], every)],
            "cluster": [("brute", brute, flags["brute"], every),
                        ("plain", twin, flags["plain"], keep)]}
    err = {}
    for fam, (closest, occluded) in oracle_entries().items():
        _, (t_p, _), flags_p, lanes_p = refs[fam][-1]  # the plain version
        t, tri = closest(scene, o, d)
        torch.cuda.synchronize()
        for ref_name, (t_r, id_r), _, lanes in refs[fam]:
            assert_same_hits(f"{fam} {label}", scene, o[lanes], d[lanes], t[lanes], tri[lanes],
                             ref_name, (t_r[lanes], id_r[lanes]))
        fin = torch.isfinite(t_p) & lanes_p
        occ_err = 0.0
        for i, cut in enumerate(cuts):
            for want_any in (False, True):
                occ, hit_any = occluded(scene, o, d, cut, want_any)
                torch.cuda.synchronize()
                for ref_name, _, ref_flags, lanes in refs[fam]:
                    occ_r, any_r = ref_flags[i]
                    assert torch.equal(occ[lanes], occ_r[lanes]), (
                        f"{fam} {label}: occluded differs from {ref_name}")
                    if want_any:
                        assert torch.equal(hit_any[lanes], any_r[lanes]), (
                            f"{fam} {label}: hit_any differs from {ref_name}")
                occ_err = max(occ_err, (occ[lanes_p].float()
                                        - flags_p[i][0][lanes_p].float()).abs().max().item())
        err[fam] = {"closest": (t[fin] - t_p[fin]).abs().max().item() if fin.any() else 0.0,
                    "occluded": occ_err}
    return brute[0], t_cut, flags["brute"][0][0], err, int((~keep).sum())


def time_oracles(scene, o, d, cut) -> dict:
    """Both entries of each family by ``event_ms`` on rays ``o``, ``d`` with
    cutoffs ``cut``, as they come and sorted as the pool sorts them ->
    {"<family> <order>": {"closest": ms, "occluded": ms}}."""
    perm = sorted_lanes(scene, o, d)
    orders = {"unsorted": (o, d, cut),
              "sorted": tuple(x[perm].contiguous() for x in (o, d, cut))}
    return {f"{fam} {order}": {
                "closest": event_ms(lambda: closest(scene, oo, dd)),
                "occluded": event_ms(lambda: occluded(scene, oo, dd, cc))}
            for order, (oo, dd, cc) in orders.items()
            for fam, (closest, occluded) in oracle_entries().items()}


def times_text(ms, bound) -> str:
    """Each timed family and order: both entries' ms and their shares of the
    bound."""
    return "; ".join(
        f"{key} closest {v['closest']:.4f} ms (share {bound['closest'][0] / v['closest']:.4f}), "
        f"occluded {v['occluded']:.4f} ms (share {bound['occluded'][0] / v['occluded']:.4f})"
        for key, v in ms.items())


def phase_oracles(dev):
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_cluster as ic
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk

    o, d, cut_scale = smoke_rays(dev)
    scenes = [smoke_scenes(dev)[0], ("band1152", band_scene(dev)), *stand_in_scenes(dev)]
    records = {}
    for name, scene in scenes:
        for n in (N_RAYS, N_RAYS - 1):
            t_b, cut, occ_b, err, defects = check_oracles(f"{name} n={n}", scene, o[:n], d[:n],
                                                           cut_scale[:n])
            log("oracles", f"{name} T={scene.num_tris} rays={n} "
                f"hits={int(torch.isfinite(t_b).sum())} occluded={int(occ_b.sum())}: tiled "
                "and cluster closest t 0 ULP from brute and their plain versions, ids equal "
                "on hit lanes; occlusion and hit_any equal brute's and the plain versions' "
                f"(cutoffs around the hit, and every seventh 0); twin defect lanes {defects}")
            if n == N_RAYS:
                errors, t_stop, t_cut, occ_stop = err, t_b, cut, occ_b
        ms = time_oracles(scene, o, d, t_cut)
        plain = {"tiled": {"closest": event_ms(lambda: tint.closest_tri_brute(scene, o, d),
                                               TIMED_PLAIN),
                           "occluded": event_ms(
                               lambda: tint._occluded_tri_brute(scene, o, d, t_cut),
                               TIMED_PLAIN)},
                 "cluster": {"closest": event_ms(lambda: ic.closest_tri_cluster_plain(scene, o, d),
                                                 TIMED_PLAIN),
                             "occluded": event_ms(lambda: ic.occluded_tri_cluster_plain(
                                 scene, o, d, t_cut), TIMED_PLAIN)}}
        bound = {"closest": kernel_bound(scene, o, d, t_stop),
                 "occluded": kernel_bound(scene, o, d, t_cut, occ_stop)}
        records[name] = ({fam: {**ms[f"{fam} unsorted"],
                                **{f"{k}_plain": v for k, v in plain[fam].items()}}
                          for fam in plain}, errors, bound)
        (b, by), (bo, byo) = bound["closest"], bound["occluded"]
        log("oracles", f"{name} at {N_RAYS} rays: closest bound {b:.6f} ms ({by}), occluded "
            f"bound {bo:.6f} ms ({byo}); {times_text(ms, bound)}; plain: brute "
            f"{plain['tiled']['closest']:.4f} / {plain['tiled']['occluded']:.4f} ms, cluster "
            f"twin {plain['cluster']['closest']:.4f} / {plain['cluster']['occluded']:.4f} ms")
        if name == "band1152":
            sl = {"closest": event_ms(lambda: sk.closest_tri_shortlist_kernel(scene, o, d)),
                  "occluded": event_ms(
                      lambda: sk.occluded_tri_shortlist_kernel(scene, o, d, t_cut))}
            log("oracles", f"{name} at {N_RAYS} rays: the shortlist kernel, which culls "
                f"the same way: closest {sl['closest']:.4f} ms, occluded "
                f"{sl['occluded']:.4f} ms; {bound_text(sl, bound)}")

    largest_oracle_check(dev, o, d, cut_scale)
    oracle_occupancy(scenes[1][1])
    return records


def largest_oracle_check(dev, o, d, cut_scale) -> None:
    """The tiled and cluster kernels against brute and their plain versions
    on phase 7's 516-cluster stand-in: no cap."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import scene_from_packed

    scene = scene_from_packed(pack_scene(torus_cornell_mesh(*LARGEST_MESH)), dev)
    lanes = torch.arange(LARGEST_RAYS, device=dev) * 4
    oo, dd = o[lanes].contiguous(), d[lanes].contiguous()
    label = f"torus{scene.num_tris} n={LARGEST_RAYS}"
    t_b, t_cut, occ_b, _, defects = check_oracles(label, scene, oo, dd, cut_scale[lanes])
    ms = time_oracles(scene, oo, dd, t_cut)
    bound = {"closest": kernel_bound(scene, oo, dd, t_b),
             "occluded": kernel_bound(scene, oo, dd, t_cut, occ_b)}
    log("oracles", f"torus{scene.num_tris} ({scene.padded_tris // 128} tiles) "
        f"rays={LARGEST_RAYS} hits={int(torch.isfinite(t_b).sum())} occluded="
        f"{int(occ_b.sum())}: tiled and cluster t 0 ULP from brute and their plain versions, "
        f"ids equal on hit lanes, occlusion and hit_any equal; twin defect lanes {defects}; "
        f"{bound_text(ms['tiled unsorted'], bound)}; {times_text(ms, bound)}")


def oracle_occupancy(scene) -> None:
    """ptxas's registers and spills of the tiled and cluster kernels' entries
    (none may spill) and their resident warps per SM on ``scene``'s tiles."""
    from pathtracer_tpu_torch import kernels

    lib = kernels.library()
    c = scene.padded_tris // 128
    for fam, blocks_per_sm in (("tiled", lib.pt_tiled_blocks_per_sm),
                               ("cluster", lib.pt_cluster_blocks_per_sm)):
        for entry, lines in ptxas_report().items():
            if f"{fam}_kernel" in entry:
                assert not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines), lines
                log("oracles", f"ptxas {entry}: {'; '.join(lines)}")
        for any_hit, entry in ((0, "closest"), (1, "occluded")):
            blocks = blocks_per_sm(c, any_hit)
            assert blocks > 0, f"occupancy query failed: {blocks}"
            log("oracles", f"{fam} {entry} at {c} tiles: {blocks} resident blocks of 4 warps "
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
    for route in ("auto", "cluster"):  # auto's route, and the cluster kernel's
        again = run(route)
        fam = FAMILY[resolved if route == "auto" else route]
        profiled, profile = profiled_render(lambda: run(route), f"{fam}_kernel",
                                            lambda out: out[4][fam])
        assert profiled[1:3] == results[route][1:3], "the profiled render traced other rays"
        iters = profiled[2]
        assert profiled[4][fam] == {"closest": iters, "occluded": iters}, profiled[4][fam]
        log("band", f"{route} (-> {fam} kernel) walls {results[route][3]:.4f}, "
            f"{again[3]:.4f} s; profiled render " + profile_text(
                profile, iters, [results[route][3], again[3]]))
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


THREEFRY_SEEDS = (0, 7)
# Phase 13's render: the Cornell headline's shape.
THREEFRY_RENDER = dict(width=512, height=512, samples_per_pixel=16, max_depth=17,
                       rr_prob=0.9, scheduler="regen", batch_size=1 << 18)
# Threefry and hash are two streams of one estimator: at 512^2 spp 16 their
# Cornell images differ by noise. Bounds: tonemapped MSE (the two CPU ports
# at 64^2 spp 16 read 0.0043) and the relative difference of the image means
# (0.29% there, with 64 times fewer paths).
STREAMS_TONEMAPPED_MSE = 0.01
STREAMS_MEAN_REL = 0.01
# Phase 14: the BVH oracle's t against brute's, as tests/test_torch_bvh.py.
BVH_RTOL, BVH_ATOL = 1e-5, 1e-6
BVH_RENDER_SIZE = 128
# Phase 15's CLI renders.
EXTRAS_SIZE, EXTRAS_SPP = 128, 8


def rng_inputs(dev, seed: int):
    """Phase 13's lanes: u32 pixel and sample ids and per-lane depths 0-16,
    made with numpy from ``seed``."""
    g = np.random.default_rng(100 + seed)
    ids = [g.integers(0, 1 << 32, N_RAYS, dtype=np.uint64).astype(np.int64)
           for _ in range(2)]
    depth = g.integers(0, 17, N_RAYS).astype(np.int64)
    return tuple(torch.as_tensor(a, device=dev) for a in (*ids, depth))


def threefry_draws(pix, smp, depth, seed):
    """Phase 13's draws: jitter, and 7 bounce uniforms at the per-lane depths
    and at a scalar depth."""
    from pathtracer_tpu_torch.ops import rng

    keys = rng.ray_keys(rng.prng_key(seed), pix, smp)
    return {"keys": keys, "jitter": rng.pixel_jitter_threefry(keys),
            "per-lane depth": rng.bounce_uniforms_threefry(keys, depth, 7),
            "scalar depth": rng.bounce_uniforms_threefry(keys, 3, 7)}


def phase_threefry(dev):
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.ops import rng
    from pathtracer_tpu_torch.ops.tonemap import tonemap_reference
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    for seed in THREEFRY_SEEDS:
        card = rng_inputs(dev, seed)
        got = threefry_draws(*card, seed)
        want = threefry_draws(*(x.cpu() for x in card), seed)
        for name, x in got.items():
            assert torch.equal(x.cpu(), want[name]), f"seed {seed}: threefry {name} differs"
        log("threefry", f"seed {seed}, {N_RAYS} lanes: keys, jitter and bounce uniforms "
            "(per-lane depths 0-16 and a scalar depth) bit-equal to the CPU port's")
    pix, smp, depth = rng_inputs(dev, 0)
    draw = {}
    for gen in ("hash", "threefry"):
        st = RenderSettings(rng=gen)
        draw[gen] = (graph_ms(lambda: rng.bounce_uniforms(st, pix, smp, depth, 7), n=10),
                     event_ms(lambda: rng.bounce_uniforms(st, pix, smp, depth, 7)))
    log("threefry", f"one bounce's uniform draw (7 per lane, per-lane depths) at {N_RAYS} "
        f"lanes: threefry {draw['threefry'][0]:.4f} ms vs hash {draw['hash'][0]:.4f} ms on "
        f"the device (a CUDA graph of 10 calls); back-to-back calls by events threefry "
        f"{draw['threefry'][1]:.4f} ms, hash {draw['hash'][1]:.4f} ms")

    scene, camera = cornell_box_scene(device=dev)
    base = THREEFRY_RENDER
    size = base["width"]
    paths = size * size * base["samples_per_pixel"]
    results = {}
    for label, kw in (("threefry auto", dict(rng="threefry")),
                      ("threefry brute", dict(rng="threefry", intersector="brute")),
                      ("hash auto", {})):
        st = RenderSettings(**base, **kw)
        render_regenerative_stats(scene, camera, st)  # warm-up
        reset_launches()
        (img, n, iters), wall = sync_time(lambda: render_regenerative_stats(scene, camera, st))
        counted = dict(small.launches)
        kernel = "brute" not in label
        assert all((v > 0) == kernel for v in counted.values()), (label, counted)
        assert torch.isfinite(img).all(), f"{label}: non-finite image"
        results[label] = (img, int(n), iters, wall)
        log("threefry", f"{label}: {size}^2 spp {base['samples_per_pixel']}: {wall:.4f} s, {int(n) / wall / 1e6:.2f} "
            f"Mray/s, {paths / wall / 1e6:.2f} Mpaths/s, rays traced {int(n)}, pool "
            f"iterations {iters}, small kernel launches {counted}")
    (img_k, n_k, *_), (img_b, n_b, *_) = results["threefry auto"], results["threefry brute"]
    assert n_k == n_b, f"threefry rays traced: kernel {n_k} vs brute {n_b}"
    err = torch.mean((img_k - img_b) ** 2).item()
    assert err <= 1e-6, f"threefry image MSE kernel vs brute {err}"
    img_h, n_h = results["hash auto"][:2]
    streams = torch.mean((tonemap_reference(img_k) - tonemap_reference(img_h)) ** 2).item()
    rel = abs(img_k.mean().item() - img_h.mean().item()) / img_h.mean().item()
    assert streams <= STREAMS_TONEMAPPED_MSE, f"threefry vs hash tonemapped MSE {streams}"
    assert rel <= STREAMS_MEAN_REL, f"threefry vs hash image means differ by {rel:.4f}"
    log("threefry", f"threefry: equal rays traced through the kernel and brute ({n_k}), "
        f"image MSE {err:.3e}; threefry vs hash (two streams): tonemapped MSE "
        f"{streams:.5f} (bound {STREAMS_TONEMAPPED_MSE}), image means differ by {rel:.5f} "
        f"(bound {STREAMS_MEAN_REL}), rays traced {n_k} vs {n_h}")


def phase_bvh(dev):
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk
    from pathtracer_tpu_torch.ops import intersect_tiled as it
    from pathtracer_tpu_torch.ops.bvh_traverse import closest_tri_bvh_stats
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    o, d, _ = smoke_rays(dev)
    scenes = [smoke_scenes(dev)[0], ("band1152", band_scene(dev)), stand_in_scenes(dev)[0]]
    for name, scene in scenes:
        for n in (N_RAYS, N_RAYS - 1):
            oo, dd = o[:n], d[:n]
            t, tri, iters = closest_tri_bvh_stats(scene, oo, dd)
            t_b, id_b = tint.closest_tri_brute(scene, oo, dd)
            torch.cuda.synchronize()
            hit = torch.isfinite(t_b)
            assert torch.equal(torch.isfinite(t), hit), f"bvh {name} n={n}: hit masks differ"
            assert torch.allclose(t[hit], t_b[hit], rtol=BVH_RTOL, atol=BVH_ATOL), (
                f"bvh {name} n={n}: t differs from brute's")
            differ, ties = tied_lanes(scene, oo, dd, tri, t_b, id_b)
            assert differ == ties, f"bvh {name} n={n}: {differ - ties} ids differ off a tie"
            log("bvh", f"{name} T={scene.num_tris} rays={n} hits={int(hit.sum())}: hit masks "
                f"equal to brute's, t {ulp_distance(t, t_b)} ULP from brute's (within rtol "
                f"{BVH_RTOL} / atol {BVH_ATOL}), ids equal but on {ties} tied lanes; "
                f"{iters} loop iterations (the worst lane's node pops)")
        (_, _, iters), wall = sync_time(lambda: closest_tri_bvh_stats(scene, o, d))
        ms = {"bvh": wall * 1e3, "tiled": event_ms(lambda: it.closest_tri_tiled(scene, o, d))}
        if scene.padded_tris >= tint.SHORTLIST_MIN_T:
            ms["shortlist"] = event_ms(lambda: sk.closest_tri_shortlist_kernel(scene, o, d))
        log("bvh", f"{name} at {N_RAYS} rays, closest hit: bvh oracle {ms['bvh']:.2f} ms a "
            f"call (host clock, one call) in {iters} iterations, against "
            + ", ".join(f"the {k} kernel {v:.4f} ms" for k, v in ms.items() if k != "bvh"))

    scene, camera = band_scene(dev), cornell_box_camera()
    out = {}
    for route in ("bvh", "brute"):
        st = RenderSettings(width=BVH_RENDER_SIZE, height=BVH_RENDER_SIZE, samples_per_pixel=4,
                            max_depth=17, rr_prob=0.9, intersector=route)
        reset_launches()
        (img, n, iters), wall = sync_time(lambda: render_regenerative_stats(scene, camera, st))
        moved = {f: c for f, c in launch_counts().items() if any(c.values())}
        assert not moved, f"{route}: a kernel was launched: {moved}"
        assert torch.isfinite(img).all() and img.mean().item() > 0.01, route
        out[route] = (img, int(n), wall)
        log("bvh", f"band stand-in {BVH_RENDER_SIZE}^2 spp 4 through {route}: {wall:.4f} s, "
            f"rays traced {int(n)}, pool iterations {iters}, no kernel launched")
    (img_v, n_v, _), (img_b, n_b, _) = out["bvh"], out["brute"]
    assert n_v == n_b, f"rays traced: bvh {n_v} vs brute {n_b}"
    err = torch.mean((img_v - img_b) ** 2).item()
    assert err <= 1e-6, f"image MSE bvh vs brute {err}"
    log("bvh", f"band render: equal rays traced ({n_v}), image MSE bvh vs brute {err:.3e}")


class _Cut(Exception):
    """Raised by phase 15's progress callback to cut a render."""


def phase_cli_extras(dev):
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.render import render_checkpointed, render_stats
    from pathtracer_tpu_torch.utils import profiling
    from pathtracer_tpu_torch.utils.checkpoint import load_render_state, render_fingerprint
    from pathtracer_tpu_torch.utils.image import read_png
    from pathtracer_tpu_torch.utils.preview_server import PreviewServer

    size, spp = EXTRAS_SIZE, EXTRAS_SPP
    with tempfile.TemporaryDirectory() as tmp:
        ini = write_cornell_box_files(tmp)
        common = [ini, "--size", str(size), "--spp", str(spp), "--device", str(dev)]

        def run(name, *extra):
            png = os.path.join(tmp, name)
            rc = cli.main([*common, "--out", png, *extra])
            assert rc == 0, f"cli {extra} returned {rc}"
            img = read_png(png)
            assert img.shape == (size, size, 3) and img.mean() > 0.01, (extra, img.mean())
            return img

        ckpt = os.path.join(tmp, "state.npz")
        scene, camera, settings, _ = load_scene(ini, device=dev, width=size, height=size,
                                                samples_per_pixel=spp)

        def cut(done, total):
            raise _Cut

        try:
            render_checkpointed(scene, camera, settings, ckpt, chunk_samples=spp // 2,
                                progress_callback=cut)
        except _Cut:
            pass
        fp = render_fingerprint(scene, settings)
        assert load_render_state(ckpt, fp)[1] == spp // 2, "the cut state was not saved"
        resumed = run("resumed.png", "--checkpoint", ckpt)
        assert load_render_state(ckpt, fp)[1] == spp, "the CLI did not resume the state"
        straight = run("straight.png")
        steps = np.abs(np.rint(resumed * 255) - np.rint(straight * 255))
        assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3, (steps.max(), (steps > 0).mean())
        log("cli-extras", f"--checkpoint: a {size}^2 spp {spp} render cut after its first "
            f"chunk ({spp // 2} samples) and resumed by the CLI: its PNG equals the straight "
            f"CLI render's on {(steps == 0).mean():.6f} of the values, the rest one 8-bit "
            "step apart (summation order)")

        run("p.png", "--preview-png", "2")
        previews = sorted(f for f in os.listdir(tmp) if f.startswith("p.preview_"))
        assert previews == [f"p.preview_{k:04d}.png" for k in (2, 4, 6)], previews
        for f in previews:
            assert read_png(os.path.join(tmp, f)).shape == (size, size, 3), f
        run("served.png", "--serve", "0")
        log("cli-extras", f"--preview-png 2 wrote {previews}; a --serve 0 run exited 0")

        srv = PreviewServer(port=0)
        try:
            srv.update(np.rint(straight * 255).astype(np.uint8), 3, spp)
            base = f"http://127.0.0.1:{srv.port}"
            status = json.loads(urllib.request.urlopen(f"{base}/status", timeout=10).read())
            png = urllib.request.urlopen(f"{base}/latest.png", timeout=10).read()
        finally:
            srv.close()
        assert status == {"spp_done": 3, "spp_total": spp, "width": size, "height": size,
                          "done": False}, status
        served = os.path.join(tmp, "latest.png")
        with open(served, "wb") as f:
            f.write(png)
        assert read_png(served).shape == (size, size, 3)
        log("cli-extras", f"PreviewServer on port {srv.port}: /status {status}, /latest.png "
            f"a {len(png)}-byte PNG that read_png reads")

        result, logdir = {}, os.path.join(tmp, "trace")
        with profiling.trace(logdir):
            with profiling.timed(result):
                img, n_rays = render_stats(scene, camera, settings)
                result["block_on"] = img
        trace_file = os.path.join(logdir, "trace.json")
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
        assert any("small_kernel" in e.get("name", "") for e in events), "no kernel traced"
        assert result["wall_s"] > 0.0
        stats = profiling.RenderStats(result["wall_s"], float(n_rays), float(size * size * spp))
        log("cli-extras", f"profiling.trace wrote {os.path.getsize(trace_file)} bytes "
            f"({len(events)} events, the small kernel among them); profiling.timed: {stats}")


# Phase 16: inverse rendering by path replay. Sizes: (a) card vs the CPU
# port, (b) the Cornell headline's shape, (c) kernel routes vs plain routes,
# (e) resume; (d) runs recover_from_ground_truth at its defaults against a
# GT_SIZE^2 spp GT_SPP render of the true scene.
INVERSE_CHECK = dict(width=32, height=32, max_depth=9, scheduler="scan")
INVERSE_FULL = dict(width=512, height=512, max_depth=17, scheduler="scan")
INVERSE_ROUTES = dict(width=128, height=128, max_depth=9, scheduler="scan")
INVERSE_RESUME = dict(width=32, height=32, max_depth=9, scheduler="scan")
GT_SIZE, GT_SPP, GT_EVAL_SPP = 512, 16, 32
# (d)'s steps, cut from recover_from_ground_truth's 120 to keep the phase
# near 90 s: at 64^2 a step takes ~0.3-0.5 s on the H100 (PERF.md §6), and
# the CPU port's fit passes both gates in 60 steps as in 120.
GT_STEPS = 60
RESUME_STEPS = 20
# Gradient tolerances, of each field's largest |g|: card vs CPU (libm and
# summation order; phase 5's renders agree to a tonemapped MSE of ~4e-15) and
# a kernel route vs its plain route (t bit-equal: only the summation order of
# the index backward differs).
GRAD_TOL_CPU = 1e-3
GRAD_TOL_ROUTE = 1e-4
# A resumed run against the straight one, where the card's runs are not
# bit-identical: largest |param difference| after RESUME_STEPS Adam steps.
RESUME_ATOL = 1e-4


def leaf_params(scene) -> dict:
    """The scene's material arrays (``inverse.PARAM_FIELDS``) as fresh leaf
    tensors requiring grad."""
    from pathtracer_tpu_torch.inverse import material_params

    return {k: v.detach().clone().requires_grad_(True)
            for k, v in material_params(scene).items()}


def step_inputs(scene, camera, st, seed: int = 0):
    """A paired step's (frame, target rows, pixel ids, ids a, ids b) on the
    scene's device: one path per pixel and wave, the target uniform in [0,
    0.6) from ``seed``."""
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors

    dev = scene.device
    n = st.width * st.height
    target = torch.as_tensor(np.random.default_rng(seed).uniform(0.0, 0.6, (n, 3)),
                             dtype=torch.float32, device=dev)
    pix = torch.arange(n, device=dev)
    return (ray_frame_tensors(camera, st.width, st.height, dev), target, pix,
            torch.zeros_like(pix), torch.ones_like(pix))


def counted(fn):
    """``fn()`` with every launch count set to 0 just before -> (its result,
    the counts by family just after)."""
    reset_launches()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {f: dict(c) for f, c in launch_counts().items()}


def replayed_grads(scene, camera, st, loss_space: str = "radiance", forward: bool = True):
    """One paired step's (loss, grads) by ``inverse.loss_and_grads`` ->
    ((loss, grads), launches of the forward pass alone (the objective under
    no_grad; None unless ``forward``), launches of the whole step)."""
    from pathtracer_tpu_torch import inverse

    inputs = step_inputs(scene, camera, st)
    params = leaf_params(scene)
    fwd = None
    if forward:
        with torch.no_grad():
            _, fwd = counted(lambda: inverse._OBJECTIVES[loss_space](params, scene, st,
                                                                     *inputs))
    out, total = counted(lambda: inverse.loss_and_grads(params, scene, st, *inputs,
                                                        loss_space=loss_space))
    return out, fwd, total


def grad_errors(grads, ref) -> dict:
    """By field: the largest |difference| over the field's largest |g| in
    ``ref`` (0 where both are all zero)."""
    out = {}
    for k, r in ref.items():
        r, g = r.detach().cpu().double(), grads[k].detach().cpu().double()
        assert torch.isfinite(g).all(), f"{k}: non-finite gradient"
        scale = r.abs().max().item()
        diff = (g - r).abs().max().item()
        out[k] = diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))
    return out


def check_replay(label, fwd, total, family: str) -> None:
    """The kernel ``family`` launched in the forward pass, each bounce's
    closest hit once more in the replay, and the gather backward's kernel in
    the backward pass."""
    f, t = fwd[family], total[family]
    assert all(v > 0 for v in f.values()), f"{label}: {family} kernel not launched: {f}"
    assert t["closest"] == 2 * f["closest"], f"{label}: replay launches {t} vs forward {f}"
    assert t["occluded"] > f["occluded"], f"{label}: no any-hit launch in the replay: {t}"
    assert total["gather_backward"]["sum"] > 0, f"{label}: no segment-sum kernel: {total}"
    assert not any(v for fam, c in total.items() if fam not in (family, "gather_backward")
                   for v in c.values()), total


def inverse_card_vs_cpu(dev) -> None:
    """(a) One paired step, both loss spaces, on the glossy Cornell box (so
    all four fields have gradients): the card (small kernel) against the CPU
    port."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings

    st = RenderSettings(**INVERSE_CHECK)
    card, camera = cornell_box_scene(glossy_tall_box=True, device=dev)
    cpu, _ = cornell_box_scene(glossy_tall_box=True, device="cpu")
    for space in ("radiance", "display"):
        (loss, grads), fwd, total = replayed_grads(card, camera, st, space)
        (loss_c, grads_c), _, _ = replayed_grads(cpu, camera, st, space, forward=False)
        check_replay(space, fwd, total, "small")
        err = grad_errors(grads, grads_c)
        assert all(e <= GRAD_TOL_CPU for e in err.values()), (space, err)
        rel = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
        assert rel <= 1e-5, (space, loss.item(), loss_c.item())
        log("inverse", f"(a) {space} loss, {st.width}^2 depth {st.max_depth}, glossy box: card "
            f"{loss.item():.8f} vs CPU {loss_c.item():.8f}; grads card vs CPU, largest "
            f"difference over max |g| by field {err} (tolerance {GRAD_TOL_CPU}); small kernel "
            f"launches forward {fwd['small']}, forward + replay {total['small']}")


def kept_loss_and_grads(params, scene, st, frame, target, pix, ids_a, ids_b):
    """The paired radiance objective's (loss, grads) without path replay: the
    integrator's loop over ``bounce_core`` written out here, so autograd
    keeps every bounce's intermediates."""
    from pathtracer_tpu_torch.inverse import with_material_params
    from pathtracer_tpu_torch.ops import rng
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays
    from pathtracer_tpu_torch.ops.integrator import bounce_core

    scene = with_material_params(scene, params)

    def rows(ids):
        o, d = generate_rays(frame, st.width, st.height, pix, rng.pixel_jitter(st, pix, ids))
        beta, radiance = torch.ones_like(o), torch.zeros_like(o)
        alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
        spec = torch.zeros_like(alive)
        for depth in range(st.max_depth):
            o, d, beta, radiance, alive, spec, _ = bounce_core(
                scene, st, o, d, beta, radiance, alive, spec, pix, ids, depth)
            if not bool(torch.any(alive)):
                break
        return torch.maximum(radiance, torch.zeros((), device=o.device))

    rad_a, rad_b = rows(ids_a), rows(ids_b)
    surrogate = torch.mean((rad_a.detach() - target) * rad_b + (rad_b.detach() - target) * rad_a)
    grads = torch.autograd.grad(surrogate, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    loss = torch.mean((0.5 * (rad_a + rad_b).detach() - target) ** 2)
    return loss, dict(zip(params, grads))


def busy_ms(spans) -> float:
    """Device busy: the union of the device intervals, ms."""
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy_us / 1e3


def top_kernels(spans, n: int = 5) -> str:
    """The ``n`` device kernels with the most time in ``spans``: name (cut),
    ms, count."""
    by = {}
    for a, b, name in spans:
        ms, k = by.get(name, (0.0, 0))
        by[name] = (ms + (b - a) / 1e3, k + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return "; ".join(f"{name[:90]} {ms:.1f} ms in {k}" for name, (ms, k) in top)


def inverse_full(dev) -> None:
    """(b) One ``make_train_step`` step at the Cornell headline's shape (two
    waves of 262,144 paths): wall, peak memory, one profiled step (busy
    share, intervals per bounce, the kernels with the most device time),
    and the first step's loss and gradients without replay (peak and
    agreement)."""
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch.inverse import loss_and_grads, make_train_step
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings

    scene, camera = cornell_box_scene(device=dev)
    st = RenderSettings(**INVERSE_FULL)
    inputs = step_inputs(scene, camera, st)
    params = leaf_params(scene)
    first = {k: v.detach().clone() for k, v in params.items()}
    step = make_train_step(st, torch.optim.Adam(list(params.values()), lr=5e-2))
    torch.cuda.reset_peak_memory_stats()
    (loss, wall), counts = counted(lambda: sync_time(lambda: step(params, scene, *inputs)))
    peak = torch.cuda.max_memory_allocated()
    grads = {k: p.grad.detach().clone() for k, p in params.items()}
    assert all(v > 0 for v in counts["small"].values()), f"small kernel not launched: {counts}"
    assert torch.isfinite(loss), loss
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (_, prof_wall), prof_counts = counted(
            lambda: sync_time(lambda: step(params, scene, *inputs)))
    spans = device_spans(prof)
    bounces = prof_counts["small"]["closest"]  # each bounce run, forward and replay
    busy = busy_ms(spans)
    log("inverse", f"(b) make_train_step at {st.width}^2 depth {st.max_depth}, 2 waves of "
        f"{st.width * st.height} paths: first step {wall:.4f} s, loss {loss.item():.6f}, peak "
        f"memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated), kernel launches "
        f"{counts['small']}; profiled step ({prof_wall:.4f} s): {len(spans)} device "
        f"intervals, {len(spans) / bounces:.1f} per bounce run ({bounces} bounces, forward "
        f"and replay), device busy {busy:.3f} ms, busy share {busy / (wall * 1e3):.4f} of "
        f"the first step's wall; most device time: {top_kernels(spans)}")

    gather_backward_kernel(dev, scene.mat_Kd.shape[0], st.width * st.height)

    kept = {k: v.clone().requires_grad_(True) for k, v in first.items()}
    torch.cuda.reset_peak_memory_stats()
    (loss_k, grads_k), wall_k = sync_time(lambda: kept_loss_and_grads(kept, scene, st,
                                                                      *inputs))
    peak_k = torch.cuda.max_memory_allocated()
    err = grad_errors(grads, grads_k)
    assert all(e <= GRAD_TOL_ROUTE for e in err.values()), err
    assert abs(loss.item() - loss_k.item()) <= 1e-6 * abs(loss_k.item()), (loss, loss_k)
    log("inverse", f"(b) the first step's loss and gradients without replay (every bounce's "
        f"intermediates kept): peak {peak_k / 2**30:.3f} GiB ({peak_k / peak:.1f}x the "
        f"step's) in {wall_k:.4f} s; grads agree with the step's, largest difference over "
        f"max |g| {err} (tolerance {GRAD_TOL_ROUTE})")


def gather_backward_kernel(dev, m: int, rows: int) -> None:
    """(b) One material gather's backward alone, at the step's lanes: the
    segment-sum kernel (``ops.gather.segment_sum``) summing [rows, k] path
    gradients into an [m, k] table (k = 3: Kd, Ks, Ke; k = 1: Ns), ids
    uniform over the table, against the same sum in float64 (within 1e-5 of
    each element's sum of |terms|) and in five calls' bits; its time (a CUDA
    graph of 100 calls: the wrapper's host time exceeds the kernel's) beside
    the byte bound (each input read once, the table written once, at 3.35
    TB/s) and the plain version's on the card (a zero table and
    ``_index_put_impl_`` with accumulate, autograd's own backward: events,
    mean of 5); ptxas's registers and spills."""
    from pathtracer_tpu_torch.ops.gather import segment_sum

    g = torch.Generator(dev).manual_seed(0)
    ids = torch.randint(0, m, (rows,), device=dev, generator=g)
    for shape in ((m, 3), (m,)):
        grad = torch.randn((rows, *shape[1:]), device=dev, generator=g)
        runs = [segment_sum(grad, ids, shape) for _ in range(5)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:]), f"{shape}: bits differ"
        zero = torch.zeros(shape, dtype=torch.float64, device=dev)
        err = ((runs[0].double() - zero.index_add(0, ids, grad.double())).abs()
               / zero.index_add(0, ids, grad.abs().double()).clamp_min(1e-300)).max().item()
        assert err <= 1e-5, f"{shape}: relative error {err}"

        def plain():
            out = grad.new_zeros(shape)
            torch.ops.aten._index_put_impl_(out, [ids], grad, True, True)
            return out

        ms = graph_ms(lambda: segment_sum(grad, ids, shape))
        plain_ms = event_ms(plain, n=5)
        nbytes = grad.numel() * 4 + ids.numel() * 8 + runs[0].numel() * 4
        bound = nbytes / 3.35e12 * 1e3
        log("inverse", f"(b) segment-sum kernel, [{rows}, {grad.numel() // rows}] rows into "
            f"{list(shape)}: {ms * 1e3:.2f} us (graph of 100), bound {bound * 1e3:.3f} us "
            f"({nbytes} bytes), share {bound / ms:.4f}; plain _index_put_impl_ "
            f"{plain_ms:.3f} ms (events, mean of 5); five calls bit-equal, error over the "
            f"sum of |terms| {err:.3g}")
    for entry, lines in ptxas_report().items():
        if "segment_sum" in entry:
            assert not any(re.search(r"[1-9]\d* bytes spill", ln) for ln in lines), lines
            log("inverse", f"ptxas {entry}: {'; '.join(lines)}")


def inverse_routes(dev) -> None:
    """(c) One paired step at INVERSE_ROUTES on the band stand-in (``auto``:
    the tiled kernel, against brute) and on the 12,580-triangle stand-in
    (``auto``: the shortlist kernel, against its twin)."""
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera, torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed

    camera = cornell_box_camera()
    for label, mesh, family, plain in (("band", band_mesh(), "tiled", "brute"),
                                       ("torus12580", torus_cornell_mesh(), "shortlist",
                                        "shortlist")):
        scene = scene_from_packed(pack_scene(mesh), dev)
        st = RenderSettings(**INVERSE_ROUTES)
        ((loss, grads), fwd, total), wall = sync_time(lambda: replayed_grads(scene, camera, st))
        check_replay(label, fwd, total, family)
        ((loss_p, grads_p), _, total_p), wall_p = sync_time(
            lambda: replayed_grads(scene, camera, RenderSettings(**INVERSE_ROUTES,
                                                                 intersector=plain),
                                   forward=False))
        assert total_p["gather_backward"]["sum"] > 0, total_p
        assert not any(v for f, c in total_p.items() if f != "gather_backward"
                       for v in c.values()), total_p
        err = grad_errors(grads, grads_p)
        assert all(e <= GRAD_TOL_ROUTE for e in err.values()), (label, err)
        log("inverse", f"(c) {label} ({scene.num_tris} triangles) {st.width}^2 depth "
            f"{st.max_depth}: auto ({family} kernel, forward {fwd[family]}, forward + replay "
            f"{total[family]}) loss {loss.item():.8f}, {wall:.4f} s; {plain} loss "
            f"{loss_p.item():.8f}, {wall_p:.4f} s, no kernel; grads, largest difference over "
            f"max |g| {err} (tolerance {GRAD_TOL_ROUTE})")


def inverse_ground_truth(dev) -> None:
    """(d) Configuration 5's shape through ``recover_from_ground_truth`` at
    its defaults but GT_STEPS steps, against a PNG of the true scene
    rendered here."""
    from pathtracer_tpu_torch.inverse import (
        downsample_display,
        recover_from_ground_truth,
        with_material_params,
    )
    from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.ops.tonemap import tonemap_reference
    from pathtracer_tpu_torch.render import render
    from pathtracer_tpu_torch.utils.image import read_png, write_png

    with tempfile.TemporaryDirectory() as tmp:
        ini = write_cornell_box_files(tmp)
        scene, camera, st, _ = load_scene(ini, device=dev, width=GT_SIZE, height=GT_SIZE,
                                          samples_per_pixel=GT_SPP)
        png = os.path.join(tmp, "target.png")
        write_png(png, tonemap_reference(render(scene, camera, st)).cpu().numpy())
        (out, wall), counts = counted(lambda: sync_time(
            lambda: recover_from_ground_truth(ini, png, steps=GT_STEPS)))
        true, pert, params, losses = out
        assert all(v > 0 for v in counts["small"].values()), counts
        _, _, ev, _ = load_scene(ini, device=dev, width=64, height=64,
                                 samples_per_pixel=GT_EVAL_SPP, max_depth=9, scheduler="scan")
        gt = downsample_display(read_png(png), GT_SIZE // ev.width)

    def display_mse(s):
        img = tonemap_reference(render(s, camera, ev)).cpu().numpy()
        return float(np.mean((img - gt) ** 2))

    mse_true, mse_pert = display_mse(true), display_mse(pert)
    mse_fit = display_mse(with_material_params(pert, params))
    kd, kd_true = params["mat_Kd"].cpu().numpy(), true.mat_Kd.cpu().numpy()
    visible = true.mat_Ke.cpu().numpy().sum(axis=1) == 0.0
    colored = visible & (np.ptp(kd_true, axis=1) > 0.2)
    err_rg = np.abs(kd - kd_true)[:, :2].max(axis=1)
    assert mse_fit < 0.5 * mse_pert, (mse_pert, mse_fit)
    assert colored.sum() == 2 and (err_rg[colored] < 0.25).all(), err_rg[colored]
    log("inverse", f"(d) recover_from_ground_truth at its defaults (fit {ev.width}^2, lr "
        f"5e-2, Kd x 0.5, depth 9) but {len(losses)} steps (default 120) against a "
        f"{GT_SIZE}^2 spp {GT_SPP} render: {wall:.3f} s, {len(losses) / wall:.2f} steps/s "
        f"(scene load included); "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; display MSE ({GT_EVAL_SPP} spp) true "
        f"{mse_true:.6f}, perturbed {mse_pert:.6f}, fit {mse_fit:.6f}; colored walls' R/G Kd "
        f"error {err_rg[colored]} (< 0.25); small kernel launches {counts['small']}")


def inverse_resume(dev) -> None:
    """(e) A RESUME_STEPS-step recovery cut after half by ``stop_after`` and
    resumed from its checkpoint, against a straight run; where they differ,
    a second straight run and the same under
    torch.use_deterministic_algorithms."""
    from pathtracer_tpu_torch.inverse import recover_materials, with_material_params
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.render import render

    scene, camera = cornell_box_scene(device=dev)
    st = RenderSettings(**INVERSE_RESUME, samples_per_pixel=4)
    target = render(scene, camera, st)
    pert = with_material_params(scene, {"mat_Kd": scene.mat_Kd * 0.5})
    kw = dict(steps=RESUME_STEPS, learning_rate=5e-2)

    def runs(again: bool):
        straight, _ = recover_materials(pert, camera, st, target, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "state.npz")
            recover_materials(pert, camera, st, target, checkpoint_path=ckpt,
                              stop_after=RESUME_STEPS // 2, **kw)
            resumed, losses = recover_materials(pert, camera, st, target,
                                                checkpoint_path=ckpt, **kw)
        assert len(losses) == RESUME_STEPS - RESUME_STEPS // 2
        other = {"resumed": resumed}
        if again:
            other["again"] = recover_materials(pert, camera, st, target, **kw)[0]
        return {name: max((run[k] - straight[k]).abs().max().item() for k in straight)
                for name, run in other.items()}

    diff, wall = sync_time(lambda: runs(again=False))
    exact = diff["resumed"] == 0.0
    log("inverse", f"(e) {RESUME_STEPS}-step recovery at {st.width}^2, cut after "
        f"{RESUME_STEPS // 2} and resumed: largest |param difference| from a straight run "
        f"{diff['resumed']:.3e} ({'bit-identical' if exact else 'not bit-identical'} by "
        f"default; {wall:.2f} s)")
    if exact:
        return
    diff = runs(again=True)
    # Which op: the backward of a gather by index (material_lookup's
    # scene.mat_Kd[mat_id]) accumulates into the table twice on the same input.
    idx = torch.randint(0, 5, (1 << 18,), device=dev)
    table = torch.rand((5, 3), device=dev, requires_grad=True)
    w = torch.rand((1 << 18, 3), device=dev)
    g1, g2 = (torch.autograd.grad((table[idx] * w).sum(), table)[0] for _ in range(2))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = runs(again=True)
        g3, g4 = (torch.autograd.grad((table[idx] * w).sum(), table)[0] for _ in range(2))
    finally:
        torch.use_deterministic_algorithms(False)
    log("inverse", f"(e) the index backward (gather of a [5, 3] table by 262,144 ids) twice: "
        f"{'equal' if torch.equal(g1, g2) else 'different'} by default, "
        f"{'equal' if torch.equal(g3, g4) else 'different'} under "
        f"torch.use_deterministic_algorithms(True); a second straight run differs by "
        f"{diff['again']:.3e}; under it: resumed {det['resumed']:.3e}, a second straight "
        f"run {det['again']:.3e}")
    if det["resumed"] != 0.0:
        assert diff["resumed"] <= RESUME_ATOL, diff
        log("inverse", f"(e) held to a tolerance: resumed within {RESUME_ATOL} of straight")


def phase_inverse(dev) -> None:
    t0 = time.perf_counter()
    inverse_card_vs_cpu(dev)
    inverse_full(dev)
    inverse_routes(dev)
    inverse_ground_truth(dev)
    inverse_resume(dev)
    log("inverse", f"phase 16 took {time.perf_counter() - t0:.1f} s")


# Phase 17: parallel/. (a) the Cornell headline over a one-process NCCL
# group; (b) three shards on one card: the band and 12,580-triangle stand-ins
# at PAR_SIZE^2 spp PAR_SPP, the scan at PAR_SCAN_SIZE^2, and one training
# step at INVERSE_CHECK over four; (c) two processes on the card over gloo (NCCL refuses two
# ranks on one GPU) at PAR_WORKER; (d) the CLI's --sharded at EXTRAS_SIZE.
PAR_SHARDS = 3
PAR_STEP_SHARDS = 4  # INVERSE_CHECK's 1,024 rows do not split into 3
PAR_SIZE, PAR_SPP = 128, 4
PAR_SCAN_SIZE, PAR_SCAN_SPP = 64, 2
PAR_WORKER = dict(width=128, height=128, samples_per_pixel=8, max_depth=17, scheduler="regen")
PAR_GRAD_TOL = 1e-5  # of each field's largest |g|: only summation order differs
PAR_TIMEOUT = 300  # seconds for each worker of (c)


def sharded_against_unsharded(label, scene, camera, st, mesh, family):
    """The pool sharded over ``mesh`` against the unsharded pool, in turns
    (unsharded, sharded, sharded, unsharded): equal rays traced, image MSE
    <= 1e-6, ``family``'s kernel launched by the first sharded run; walls."""
    from pathtracer_tpu_torch.parallel.render import render_pool_sharded_stats
    from pathtracer_tpu_torch.render import render_stats

    walls, out, launches = {"unsharded": [], "sharded": []}, {}, None
    for kind in ("unsharded", "sharded", "sharded", "unsharded"):
        reset_launches()
        if kind == "sharded":
            (img, n, _), wall = sync_time(lambda: render_pool_sharded_stats(scene, camera, st,
                                                                            mesh))
            launches = launches or dict(launch_counts()[family])
        else:
            (img, n), wall = sync_time(lambda: render_stats(scene, camera, st))
        assert torch.isfinite(img).all(), f"{label} {kind}: non-finite image"
        walls[kind].append(wall)
        out.setdefault(kind, (img, int(n)))
    (img_s, n_s), (img_u, n_u) = out["sharded"], out["unsharded"]
    assert n_s == n_u, f"{label}: rays traced sharded {n_s} vs unsharded {n_u}"
    err = torch.mean((img_s - img_u) ** 2).item()
    assert err <= 1e-6, f"{label}: image MSE sharded vs unsharded {err}"
    assert all(v > 0 for v in launches.values()), f"{label}: {family} kernel not launched"
    log("parallel", f"{label}: {mesh.size} shard(s) on {[str(d) for d in mesh.devices]}: rays "
        f"traced {n_s} as unsharded, image MSE {err:.3e}, {family} launches {launches}; "
        f"walls sharded {walls['sharded']} s, unsharded {walls['unsharded']} s")


def parallel_nccl(dev):
    """(a) A real NCCL group of one process and ``make_mesh()``: the Cornell
    headline's shape through ``render_pool_sharded_stats``."""
    import torch.distributed as dist

    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.parallel import distributed
    from pathtracer_tpu_torch.parallel.launch import free_port, port_taken
    from pathtracer_tpu_torch.parallel.mesh import make_mesh

    for attempt in range(2):
        try:
            distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
            break
        except Exception as e:
            if attempt or not port_taken(str(e)):
                raise
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_mesh()
        assert mesh.group is not None and mesh.devices == (torch.device("cuda", 0),), mesh
        scene, camera = cornell_box_scene(device=dev)
        st = RenderSettings(width=512, height=512, samples_per_pixel=16, max_depth=17,
                            rr_prob=0.9, scheduler="regen", batch_size=1 << 18)
        sharded_against_unsharded("NCCL group of 1, Cornell 512x512 spp 16", scene, camera,
                                  st, mesh, "small")
        distributed.sync_global_devices("headline")
    finally:
        dist.destroy_process_group()


def parallel_one_card(dev):
    """(b) PAR_SHARDS shards on one card: the band and torus stand-ins'
    pools, the scan (bit-equal) and a training step's gradients."""
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera, cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.parallel.mesh import make_mesh
    from pathtracer_tpu_torch.parallel.render import render_sharded
    from pathtracer_tpu_torch.render import render_stats

    mesh = make_mesh([dev] * PAR_SHARDS)
    assert mesh.group is None and mesh.size == PAR_SHARDS
    camera = cornell_box_camera()
    st = RenderSettings(width=PAR_SIZE, height=PAR_SIZE, samples_per_pixel=PAR_SPP,
                        max_depth=17, scheduler="regen")
    sharded_against_unsharded(f"band stand-in {PAR_SIZE}x{PAR_SIZE} spp {PAR_SPP}",
                              band_scene(dev), camera, st, mesh, "tiled")
    torus = dict(stand_in_scenes(dev))["torus12580"]
    sharded_against_unsharded(f"torus stand-in {PAR_SIZE}x{PAR_SIZE} spp {PAR_SPP}", torus,
                              camera, st, mesh, "shortlist")

    scene, camera = cornell_box_scene(device=dev)
    st = RenderSettings(width=PAR_SCAN_SIZE, height=PAR_SCAN_SIZE,
                        samples_per_pixel=PAR_SCAN_SPP, max_depth=17, scheduler="scan")
    sharded, wall_s = sync_time(lambda: render_sharded(scene, camera, st, mesh))
    (plain, _), wall_u = sync_time(lambda: render_stats(scene, camera, st))
    assert torch.equal(sharded, plain), "the sharded scan differs from the unsharded scan"
    log("parallel", f"scan {PAR_SCAN_SIZE}x{PAR_SCAN_SIZE} spp {PAR_SCAN_SPP} over "
        f"{PAR_SHARDS} shards: bit-equal to the unsharded scan; walls {wall_s:.4f} s "
        f"sharded, {wall_u:.4f} s unsharded")

    scene, camera = cornell_box_scene(glossy_tall_box=True, device=dev)
    st = RenderSettings(**INVERSE_CHECK)
    frame, target, pix, ids_a, ids_b = step_inputs(scene, camera, st)
    # The step's rows split into equal shards: 32^2 into PAR_STEP_SHARDS.
    step_mesh = make_mesh([dev] * PAR_STEP_SHARDS)
    grads, walls = [], []
    for m in (None, step_mesh):
        params = leaf_params(scene)
        step = inverse.make_train_step(st, torch.optim.SGD(list(params.values()), lr=0.0),
                                       mesh=m)
        loss, wall = sync_time(lambda: step(params, scene, frame, target, pix, ids_a, ids_b))
        grads.append({k: p.grad for k, p in params.items()})
        walls.append((float(loss), wall))
    errs = grad_errors(grads[1], grads[0])
    assert all(e <= PAR_GRAD_TOL for e in errs.values()), errs
    log("parallel", f"training step {st.width}x{st.height} depth {st.max_depth} over "
        f"{PAR_STEP_SHARDS} shards: gradients within {errs} of each field's max |g| of the "
        f"unsharded step; (loss, wall s) unsharded {walls[0]}, sharded {walls[1]}")


def parallel_worker(out: str) -> int:
    """(c)'s worker, started by ``parallel.launch.run_workers`` (its rank, the
    group and gloo come from the ``PT_TPU_*`` variables): ``make_mesh()``
    (this process's card), the Cornell box at PAR_WORKER through the sharded
    pool, once to warm up and once timed; writes the timed render's image,
    rays, iterations, wall and kernel launches to ``out.<rank>.npz``."""
    import torch.distributed as dist

    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.parallel import distributed
    from pathtracer_tpu_torch.parallel.mesh import make_mesh
    from pathtracer_tpu_torch.parallel.render import render_pool_sharded_stats

    distributed.initialize()
    rank, n = distributed.process_index(), dist.get_world_size()
    try:
        assert dist.get_backend() == "gloo", dist.get_backend()
        mesh = make_mesh()
        assert mesh.size == n and mesh.devices == (torch.device("cuda", 0),), mesh
        scene, camera = cornell_box_scene(device="cuda")
        st = RenderSettings(**PAR_WORKER)
        render_pool_sharded_stats(scene, camera, st, mesh)  # warm-up: first calls' set-up
        reset_launches()
        (img, rays, iters), wall = sync_time(
            lambda: render_pool_sharded_stats(scene, camera, st, mesh))
        small = launch_counts()["small"]
        np.savez(f"{out}.{rank}.npz", image=img.cpu().numpy(), rays=int(rays), iters=iters,
                 wall=wall, closest=small["closest"], occluded=small["occluded"])
        distributed.sync_global_devices("done")
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}: OK", flush=True)
    return 0


def parallel_two_processes(dev):
    """(c) Two processes on the one card over gloo, each with one shard,
    against the single-process render."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.parallel.launch import run_workers
    from pathtracer_tpu_torch.render import render_stats

    n = 2
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "proc")
        t0 = time.perf_counter()
        rc = run_workers([os.path.abspath(__file__), "--parallel-worker", out], ["cuda:0"] * n,
                         timeout=PAR_TIMEOUT)
        elapsed = time.perf_counter() - t0
        assert rc == 0, f"a worker of (c) exited {rc}"
        runs = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(n)]
    scene, camera = cornell_box_scene(device=dev)
    (ref, rays), wall = sync_time(lambda: render_stats(scene, camera,
                                                       RenderSettings(**PAR_WORKER)))
    ref = ref.cpu().numpy()
    for rank, r in enumerate(runs):
        assert int(r["rays"]) == int(rays), (rank, int(r["rays"]), int(rays))
        np.testing.assert_allclose(r["image"], ref, rtol=3e-5, atol=3e-6,
                                   err_msg=f"process {rank}")
        assert r["closest"] > 0 and r["occluded"] > 0, f"process {rank}: kernel not launched"
    log("parallel", f"two processes over gloo on one card, Cornell {PAR_WORKER['width']}^2 spp "
        f"{PAR_WORKER['samples_per_pixel']}: rays traced {int(rays)} as one process, images "
        f"within rtol 3e-5 / atol 3e-6; pool walls {[float(r['wall']) for r in runs]} s, "
        f"iterations {[int(r['iters']) for r in runs]}, small launches "
        f"{[(int(r['closest']), int(r['occluded'])) for r in runs]}; single process "
        f"{wall:.4f} s; both exited 0, {elapsed:.1f} s from start to exit")


def parallel_cli(dev):
    """(d) The CLI with --sharded writes the plain CLI's PNG."""
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
    from pathtracer_tpu_torch.utils.image import read_png

    size, spp = EXTRAS_SIZE, EXTRAS_SPP
    with tempfile.TemporaryDirectory() as tmp:
        ini = write_cornell_box_files(tmp)
        imgs = []
        for extra in ([], ["--sharded"]):
            png = os.path.join(tmp, f"cli{len(extra)}.png")
            reset_launches()
            rc = cli.main([ini, "--size", str(size), "--spp", str(spp), "--out", png, *extra])
            assert rc == 0, f"cli {extra} returned {rc}"
            assert all(v > 0 for v in launch_counts()["small"].values()), extra
            imgs.append(read_png(png))
    steps = np.abs(np.rint(imgs[0] * 255) - np.rint(imgs[1] * 255))
    assert imgs[1].shape == (size, size, 3) and imgs[1].mean() > 0.01, imgs[1].shape
    assert steps.max() <= 1 and (steps > 0).mean() <= 1e-3, (steps.max(), (steps > 0).mean())
    log("parallel", f"CLI --sharded {size}^2 spp {spp}: its PNG equals the plain CLI's on "
        f"{(steps == 0).mean():.6f} of the values, the rest one 8-bit step apart")


def phase_parallel(dev) -> None:
    t0 = time.perf_counter()
    parallel_nccl(dev)
    parallel_one_card(dev)
    parallel_two_processes(dev)
    parallel_cli(dev)
    log("parallel", f"phase 17 took {time.perf_counter() - t0:.1f} s")


BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_torch.py")
BENCH_TIMEOUT = 600  # seconds for one bench_torch.py run
# (rays, pool iterations) of the bench's cells, as phases 6, 9 and 11 trace them.
BENCH_CELLS = {
    "headline": (["--spp", "16"], "small", (29_723_280, 76)),
    "scan": (["--spp", "16", "--scheduler", "scan"], "small", None),
    "torus": (["--scene", "torus", "--spp", "4"], "shortlist", (7_613_742, 29)),
    "band": (["--scene", "band", "--spp", "4"], "tiled", (7_616_286, 29)),
    # tests/test_torch_perf_canary.py's run
    "canary": (["--spp", "8"], "small", (14_871_501, 45)),
}
BENCH_SHARDED = ["--size", "128", "--spp", "8", "--device", "cuda:0", "--device", "cuda:0",
                 "--sharded"]


def run_bench(*argv) -> tuple:
    """``bench_torch.py argv`` in a subprocess -> (its JSON line, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, BENCH, *argv], capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    assert proc.returncode == 0, (f"bench_torch.py {' '.join(argv)} exited {proc.returncode}:\n"
                                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0


def bench_text(out: dict) -> str:
    return (f"walls {out['walls_s']} s, median {out['wall_median_s']:.4f} s, best "
            f"{out['wall_s']:.4f} s: {out['value'] / 1e6:.2f} Mray/s at the best wall, "
            f"{out['rays'] / out['wall_median_s'] / 1e6:.2f} at the median; rays {out['rays']} "
            f"in {out['iterations']} iterations, launches {out['launches']}")


def scan_rays(dev, size: int = 512, spp: int = 16) -> int:
    """The scan headline's rays: the sum of its waves' counts, traced here."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors
    from pathtracer_tpu_torch.ops.integrator import radiance_batch_stats
    from pathtracer_tpu_torch.ops.rng import pixel_jitter_hash

    scene, camera = cornell_box_scene(device=dev)
    st = RenderSettings(width=size, height=size, samples_per_pixel=spp, scheduler="scan")
    frame = ray_frame_tensors(camera, size, size, dev)
    pix = torch.arange(size * size, device=dev)
    counts = []
    for s in range(spp):
        ids = torch.full_like(pix, s)
        o, d = generate_rays(frame, size, size, pix, pixel_jitter_hash(pix, ids))
        counts.append(radiance_batch_stats(scene, st, o, d, pix, ids)[1])
    return int(torch.stack(counts).sum())


def bench_cli_two_workers(dev) -> None:
    """The CLI's ``--sharded`` over two workers on the card (gloo) against the
    plain CLI: the scan's PNG equal on every value, the pool's within one
    8-bit step on at most 0.1% of the values."""
    from pathtracer_tpu_torch import cli
    from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
    from pathtracer_tpu_torch.utils.image import read_png

    size, spp = EXTRAS_SIZE, EXTRAS_SPP
    with tempfile.TemporaryDirectory() as tmp:
        ini = write_cornell_box_files(tmp)
        for scheduler in ("regen", "scan"):
            imgs, walls = [], []
            for extra in ([], ["--device", "cuda:0", "--device", "cuda:0", "--sharded"]):
                png = os.path.join(tmp, f"{scheduler}{len(extra)}.png")
                t0 = time.perf_counter()
                rc = cli.main([ini, "--size", str(size), "--spp", str(spp), "--scheduler",
                               scheduler, "--out", png, *extra])
                walls.append(time.perf_counter() - t0)
                assert rc == 0, f"cli {scheduler} {extra} returned {rc}"
                imgs.append(read_png(png))
            steps = np.abs(np.rint(imgs[0] * 255) - np.rint(imgs[1] * 255))
            assert imgs[1].mean() > 0.01, imgs[1].mean()
            assert steps.max() <= (1 if scheduler == "regen" else 0), (scheduler, steps.max())
            assert (steps > 0).mean() <= 1e-3, (scheduler, (steps > 0).mean())
            log("bench", f"CLI --sharded over two workers on the card, {scheduler} {size}^2 spp "
                f"{spp}: its PNG equals the plain CLI's on {(steps == 0).mean():.6f} of the "
                f"values (max step {steps.max():.0f}); calls {walls[0]:.1f} s plain, "
                f"{walls[1]:.1f} s with the two workers' start-up")


def phase_bench(dev, smi: str) -> None:
    """18. bench_torch.py as a benchmark runs it: each cell's exact rays and
    iterations, the kernel it launched, walls and Mray/s; two workers
    sharing the card for --sharded; the CLI's two-worker --sharded."""
    t0 = time.perf_counter()
    for label, (argv, family, expect) in BENCH_CELLS.items():
        out, took = run_bench("--size", "512", *argv, "--no-sharded")
        assert out["device"] == torch.cuda.get_device_name(0), out["device"]
        assert list(out["launches"]) == [family], (label, out["launches"])
        assert all(v > 0 for v in out["launches"][family].values()), (label, out["launches"])
        if expect is None:
            expect = (scan_rays(dev), None)
        if expect[0] is not None:
            assert out["rays"] == expect[0], (label, out["rays"], expect[0])
        if expect[1] is not None:
            assert out["iterations"] == expect[1], (label, out["iterations"], expect[1])
        log("bench", f"{label}: {out['workload']} {out['scheduler']}: {bench_text(out)}; "
            f"{took:.1f} s in all; {out['nvidia_smi']}")
    out, took = run_bench(*BENCH_SHARDED)
    sh = out["sharded"]
    assert sh["n_devices"] == 2 and sh["rays"] == out["rays"], (sh, out["rays"])
    log("bench", f"--sharded over two workers on cuda:0 (gloo), {out['workload']}: rays "
        f"{sh['rays']} as the one-process headline's; worker walls {sh['walls_s']} s, "
        f"{sh['rays_per_sec'] / 1e6:.2f} Mray/s in all; one process on the same card "
        f"{bench_text(out)}; one device on ceil(spp / 2) samples "
        f"{sh['single_device_walls_s']} s; efficiency {sh['efficiency']:.4f}; {took:.1f} s "
        f"in all; {smi}")
    bench_cli_two_workers(dev)
    log("bench", f"phase 18 took {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--band-pairs", type=int, default=0, metavar="N",
                   help="rounds of the paired band measurement after phase 11")
    p.add_argument("--parallel-worker", metavar="OUT",
                   help="run as one process of phase 17 (c) and exit")
    args = p.parse_args(argv)
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)
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
    ptxas = [f"{entry}: {ln}" for entry, lines in ptxas_report().items()
             for ln in lines if "registers" in ln]
    log("build", f"nvcc built {os.path.basename(kernels.library_path())} in "
        f"{kernels.build_seconds:.2f} s; ptxas: {'; '.join(ptxas)}")
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
    or_ms = phase_oracles(dev)
    band_launches = phase_band(dev, args.band_pairs)
    phase_cli_oracles(dev)
    phase_threefry(dev)
    phase_bvh(dev)
    phase_cli_extras(dev)
    phase_inverse(dev)
    phase_parallel(dev)
    phase_bench(dev, smi)

    or_ms, or_err, or_bound = or_ms["band1152"]
    rows = []
    for family, source, replaces, counts, (k_ms, k_err, k_bound) in (
        ("intersect_small", "pathtracer_tpu_torch/csrc/intersect_small.cu",
         "pathtracer_tpu/ops/intersect_small_pallas.py:176", launches, ms["cornell36"]),
        ("intersect_shortlist", "pathtracer_tpu_torch/csrc/intersect_shortlist.cu",
         "pathtracer_tpu/ops/intersect_shortlist_pallas.py:425", sl_launches,
         sl_ms["torus12580"]),
        ("intersect_tiled", "pathtracer_tpu_torch/csrc/intersect_tiled.cu",
         "pathtracer_tpu/ops/intersect_pallas.py:120", band_launches["pallas"],
         (or_ms["tiled"], or_err["tiled"], or_bound)),
        ("intersect_cluster", "pathtracer_tpu_torch/csrc/intersect_cluster.cu",
         "pathtracer_tpu/ops/intersect_cluster.py:182", band_launches["cluster"],
         (or_ms["cluster"], or_err["cluster"], or_bound)),
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
