#!/usr/bin/env python3
"""Smoke run of the port's CUDA kernels on one card: each kernel entry
checked against its plain version, counted in a run of its cell, and timed
alone beside its roofline bound.

    python chip_smoke.py

Needs a CUDA device (and nvcc). Thirteen entries, each at 262,144 rays,
rows or lanes:
the small kernel's closest and any-hit entries on the Cornell box (Cornell
camera rays and random rays inside the box, about a quarter of the lanes
parked as the integrator parks dead lanes: origin 1e6, direction +x); the
shortlist kernel's on the 12,580-triangle torus stand-in and the tiled and
cluster kernels' on the 1,116-triangle band stand-in (the same rays
unparked); any-hit cutoffs around the nearest hit, 0 on every seventh lane;
the gathers' segment sum of 262,144 rows into a [5, 3] and a [5] table;
the bounce kernels of the fit's path replay on the ``cornell_fit_512``
cell's 262,144 lanes (one wave of 512^2 camera rays, depth 17): the shade
and finish kernels at the wave's second bounce, the adjoint over the wave's
17 records.

- Checks: closest t bit-equal, ids equal on hit lanes and -1 on misses (the
  small kernel's normals and materials equal), any-hit flags equal, against
  the plain version and the brute sweep; the segment sum within SUM_RTOL of
  each element's sum of |terms| of the float64 sum; the bounce kernels
  against their torch twin (``ops/path_replay.py``): the shade and finish
  kernels through the wave they make, its radiance, rays and records
  bit-equal to the twin's, the adjoint's rows within BOUNCE_RTOL of each
  field's largest row of the twin's on the same records. A wrong answer
  raises.
- Launches in one run of its cell, every count set to 0 just before: regen
  renders at 512^2, depth 17 of the Cornell box at spp 16 (``auto``: small),
  the torus at spp 4 (``auto``: shortlist), the band at spp 4 (``pallas``:
  tiled; ``cluster``: cluster); one eager training step of the
  ``cornell_fit_512`` cell's shape (small, bounce, segment sum). Each
  launches its cell's kernels and no other.
- Time: GRAPH_CALLS calls as one CUDA graph, replays timed by events (a
  wrapper takes longer on the host than its kernel on the card); the plain
  version's by events around PLAIN_CALLS calls (the bounce kernels': one
  bounce of the twin, ``_bounce_plain``, and its adjoint). The finish
  kernel updates its lanes in place: each of its calls first restores them,
  and a graph of the restores alone is subtracted. The bound:
  ``roofline.py``'s for the intersection calls, the bytes moved at 3.35 TB/s
  for the sum and the bounce kernels (``BOUNCE_BYTES``).
- ptxas's registers and spilled bytes from this process's build (null when
  an earlier process built the library).

Prints nvidia-smi's name and power limit first, then ``{"kernels": [...]}``
(``library_ms``: null for intersection, which no PyTorch call computes; the
plain ``index_put_`` for the sum), and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import numpy as np
import torch

N_RAYS = 1 << 18
GRAPH_CALLS, ROUNDS, PLAIN_CALLS = 100, 5, 3
SUM_RTOL = 1e-5
BOUNCE_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12
# Bytes per lane each bounce kernel must move (csrc/bounce.cu): shade reads
# o, d (24), flags (1), t and the small kernel's int32 id (8), the pixel and
# sample ids (16) and writes the shadow ray (28); finish reads o, d, beta,
# radiance (48), flags, t, id, the occlusion flag (10), the ids (16) and
# writes the state (49) and its record (40); the adjoint reads dL/dradiance
# (12) and per bounce a record (40) and writes its rows (52), at the cell's
# depth of 17.
BOUNCE_BYTES = {"shade": 77, "finish": 163, "adjoint": 12 + 17 * 92}
BAND = (30, 18)  # torus_cornell_mesh's arguments of the band stand-in
# family -> (its CUDA source, the JAX kernel it stands in for)
SOURCES = {
    "small": ("intersect_small.cu", "pathtracer_tpu/ops/intersect_small_pallas.py:176"),
    "shortlist": ("intersect_shortlist.cu", "pathtracer_tpu/ops/intersect_shortlist_pallas.py:425"),
    "tiled": ("intersect_tiled.cu", "pathtracer_tpu/ops/intersect_pallas.py:120"),
    "cluster": ("intersect_cluster.cu", "pathtracer_tpu/ops/intersect_cluster.py:182"),
    "gather_backward": ("gather_backward.cu", None),
    "bounce": ("bounce.cu", None),
}


def graph_ms(fn) -> float:
    """Device milliseconds per call of ``fn``: GRAPH_CALLS calls captured in
    one CUDA graph, each replay timed by events; the median over ROUNDS
    replays."""
    fn()  # the first call fills the scene's cached tables
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(ROUNDS):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / GRAPH_CALLS)
    return float(np.median(means))


def event_ms(fn) -> float:
    """Device milliseconds per call of ``fn`` over PLAIN_CALLS calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(PLAIN_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / PLAIN_CALLS


def rays(dev, n: int = N_RAYS):
    """``n`` rays, half Cornell camera rays (every other pixel of 512^2, off
    the quad-diagonal seams), half from random points inside the box, and a
    cutoff scale per ray uniform in [0.5, 1.5)."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

    half = n // 2
    frame = ray_frame_tensors(cornell_box_camera(), 512, 512, dev)
    pix = torch.arange(half, device=dev) * 2
    jitter = torch.tensor([[0.371, 0.613]], device=dev).expand(half, 2)
    o_cam, d_cam = generate_rays(frame, 512, 512, pix, jitter)
    rng = np.random.default_rng(11)
    o_in = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n - half, 3))
    d_in = rng.normal(size=(n - half, 3))
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.as_tensor(o_in, dtype=torch.float32, device=dev)])
    d = torch.cat([d_cam, torch.as_tensor(d_in, dtype=torch.float32, device=dev)])
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32, device=dev)
    return o.contiguous(), d.contiguous(), scale


def parked(o, d):
    """``o``, ``d`` with about a quarter of the lanes, scattered, parked."""
    lanes = torch.as_tensor(np.random.default_rng(13).random(o.shape[0]) < 0.25,
                            device=o.device)[:, None]
    plus_x = torch.tensor([1.0, 0.0, 0.0], device=d.device)
    return (torch.where(lanes, 1.0e6, o).contiguous(),
            torch.where(lanes, plus_x, d).contiguous())


def closest_error(got, ref) -> float:
    """Raises unless ``got`` is ``ref``'s closest hit: t bit-equal, ids equal
    on hit lanes and -1 on misses, any further outputs (the small kernel's
    normals and materials) equal. -> the largest |t| difference (0.0)."""
    (t, ids, *more), (t_r, ids_r, *more_r) = got, ref
    assert torch.equal(t, t_r), "closest t differs"
    hit = torch.isfinite(t_r)
    assert torch.equal(ids[hit].long(), ids_r[hit].long()), "ids differ on hit lanes"
    assert (ids[~hit] == -1).all(), "an id on a missing lane"
    assert all(torch.equal(a, b) for a, b in zip(more, more_r)), "hit attributes differ"
    return 0.0


def occluded_error(got, ref) -> float:
    """Raises unless the any-hit flags are equal -> 0.0."""
    assert torch.equal(got, ref), "any-hit flags differ"
    return 0.0


def intersection_entries(dev, n: int = N_RAYS) -> list:
    """Per intersection entry a dict: name, family, entry (its launch
    counter), call (the wrapper), refs (its plain version first), error
    (one reference check) and bound ((ms, "operations" or "bytes"))."""
    from pathtracer_tpu_torch import roofline
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import cornell_box_mesh, torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import scene_from_packed
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_cluster as cluster
    from pathtracer_tpu_torch.ops import intersect_shortlist as twin
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as shortlist
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.ops import intersect_tiled as tiled

    o, d, scale = rays(dev, n)
    po, pd = parked(o, d)
    # family -> (mesh, rays, closest, occluded, plain closest, plain occluded,
    # bytes a closest answer writes per ray)
    families = {
        "small": (cornell_box_mesh(), (po, pd), small.closest_tri_small,
                  lambda *a: small.occluded_tri_small(*a)[0], small.closest_tri_small_plain,
                  lambda *a: small.occluded_tri_small_plain(*a)[0], 24),
        "shortlist": (torus_cornell_mesh(), (o, d), shortlist.closest_tri_shortlist_kernel,
                      shortlist.occluded_tri_shortlist_kernel, twin.closest_tri_shortlist,
                      twin.occluded_tri_shortlist, None),
        "tiled": (torus_cornell_mesh(*BAND), (o, d), tiled.closest_tri_tiled,
                  lambda *a: tiled.occluded_tri_tiled(*a)[0], None, None, None),
        "cluster": (torus_cornell_mesh(*BAND), (o, d), cluster.closest_tri_cluster,
                    lambda *a: cluster.occluded_tri_cluster(*a)[0],
                    cluster.closest_tri_cluster_plain,
                    lambda *a: cluster.occluded_tri_cluster_plain(*a)[0], None),
    }
    out = []
    for family, (mesh, (ro, rd), closest, occluded, plain_c, plain_o, out_bytes) in (
            families.items()):
        scene = scene_from_packed(pack_scene(mesh), dev)
        t, tri = tint.closest_tri_brute(scene, ro, rd)
        cut = torch.where(torch.isfinite(t), t, 1.0) * scale
        cut[::7] = 0.0
        occ = tint._occluded_tri_brute(scene, ro, rd, cut)[0]
        tests = roofline.tests_needed(scene, ro, rd, t)
        rows = -(-scene.padded_tris // roofline.CLUSTER) * roofline.CLUSTER
        brute_c = lambda s=scene, a=ro, b=rd: tint.closest_tri_brute(s, a, b)  # noqa: E731
        brute_o = lambda s=scene, a=ro, b=rd, c=cut: (  # noqa: E731
            tint._occluded_tri_brute(s, a, b, c)[0])
        args = (scene, ro, rd)
        out.append({
            "name": f"intersect_{family}_closest", "family": family, "entry": "closest",
            "call": lambda f=closest, a=args: f(*a),
            "refs": ([lambda f=plain_c, a=args: f(*a)] if plain_c else []) + [brute_c],
            "error": closest_error,
            "bound": roofline.bound_ms(tests, ro.shape[0], rows, False, out_bytes)})
        tests = roofline.tests_needed(scene, ro, rd, cut, occ)
        out.append({
            "name": f"intersect_{family}_occluded", "family": family, "entry": "occluded",
            "call": lambda f=occluded, a=args + (cut,): f(*a),
            "refs": ([lambda f=plain_o, a=args + (cut,): f(*a)] if plain_o else []) + [brute_o],
            "error": occluded_error,
            "bound": roofline.bound_ms(tests, ro.shape[0], rows, True)})
    return out


def segment_sum_entries(dev, n: int = N_RAYS) -> list:
    """The segment sum into [5, 3] and [5], as ``intersection_entries``; its
    plain version is the only reference, and its check is against the
    float64 sum."""
    from pathtracer_tpu_torch.ops.gather import segment_sum

    g = torch.Generator(dev).manual_seed(0)
    ids = torch.randint(0, 5, (n,), device=dev, generator=g)
    out = []
    for shape in ((5, 3), (5,)):
        grad = torch.randn((n, *shape[1:]), device=dev, generator=g)
        zero = torch.zeros(shape, dtype=torch.float64, device=dev)
        want = zero.index_add(0, ids, grad.double())
        mass = zero.index_add(0, ids, grad.abs().double())

        def error(got, ref, want=want, mass=mass):
            assert ((got.double() - want).abs() <= SUM_RTOL * mass).all(), "segment sum"
            return float((got - ref).abs().max())

        def plain(grad=grad, shape=shape):
            table = grad.new_zeros(shape)
            return table.index_put_((ids,), grad, accumulate=True)

        nbytes = grad.numel() * 4 + ids.numel() * 8 + int(np.prod(shape)) * 4
        out.append({
            "name": f"gather_backward_sum_{'x'.join(map(str, shape))}",
            "family": "gather_backward", "entry": "sum",
            "call": lambda grad=grad, shape=shape: segment_sum(grad, ids, shape),
            "refs": [plain], "error": error, "bound": (nbytes / HBM_BYTES_PER_S * 1e3, "bytes")})
    return out


def bounce_entries(dev, n: int = N_RAYS) -> list:
    """The three bounce kernels, as ``intersection_entries``; the finish
    entry's ``baseline`` is the restore its timing subtracts."""
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera, cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops import path_replay, rng
    from pathtracer_tpu_torch.ops.camera_rays import generate_rays, ray_frame_tensors

    scene = cornell_box_scene(device=dev)[0]
    st = RenderSettings(width=512, height=512, samples_per_pixel=1, max_depth=17)
    pix = torch.arange(n, device=dev)
    smp = torch.full_like(pix, 1)
    frame = ray_frame_tensors(cornell_box_camera(), 512, 512, dev)
    o, d = generate_rays(frame, 512, 512, pix, rng.pixel_jitter(st, pix, smp))
    g = torch.randn((n, 3), generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        wave = path_replay.record_kernels(scene, st, o, d, pix, smp)
        twin = path_replay.record_plain(scene, st, o, d, pix, smp)

    def wave_error(got, ref):
        (rad, rays, rec), (rad_p, rays_p, rec_p) = wave, twin
        assert torch.equal(rad, rad_p) and int(rays) == int(rays_p), "the wave's radiance"
        assert all(torch.equal(a, b) for a, b in zip(rec, rec_p)), "the wave's records"
        return 0.0

    def rows_error(got, ref):
        for a, b in zip(got, ref):
            assert ((a - b).abs().max() <= BOUNCE_RTOL * b.abs().max()).item(), "adjoint rows"
        return max(float((a - b).abs().max()) for a, b in zip(got, ref))

    # the second bounce's inputs
    lanes = path_replay.KernelWave(scene, st, o, d, pix, smp)
    lanes.bounce(0)
    t, tri = lanes.closest()
    lanes.shade(1, t, tri)
    occ = lanes.occluded()
    state = [lanes.o, lanes.d, lanes.beta, lanes.rad, lanes.flags]
    saved = [x.clone() for x in state]

    def restore():
        for x, y in zip(state, saved):
            x.copy_(y)

    def finish():
        restore()
        lanes.finish(1, t, tri, occ)

    def twin_bounce():
        alive, spec = (saved[4] & 1) == 1, (saved[4] & 2) == 2
        return path_replay._bounce_plain(scene, st, *saved[:4], alive, spec, pix, smp, 1)

    rec = twin[2]
    needs = (True,) * 4
    bound = {k: (v * n / HBM_BYTES_PER_S * 1e3, "bytes") for k, v in BOUNCE_BYTES.items()}
    return [
        {"name": "bounce_shade", "family": "bounce", "entry": "shade",
         "call": lambda: lanes.shade(1, t, tri), "refs": [twin_bounce], "error": wave_error,
         "bound": bound["shade"]},
        {"name": "bounce_finish", "family": "bounce", "entry": "finish", "call": finish,
         "baseline": restore, "refs": [twin_bounce], "error": wave_error,
         "bound": bound["finish"]},
        {"name": "bounce_adjoint", "family": "bounce", "entry": "adjoint",
         "call": lambda: path_replay.adjoint_kernel(scene, st, rec, g, needs),
         "refs": [lambda: path_replay.adjoint_plain(scene, st, rec, g)], "error": rows_error,
         "bound": bound["adjoint"]},
    ]


def check(entry) -> float:
    """Raises unless the entry's answer passes its check against every
    reference -> its largest error against the plain version."""
    got = entry["call"]()
    errors = [entry["error"](got, ref()) for ref in entry["refs"]]
    return errors[0]


def cell_launches(dev) -> dict:
    """family -> its launch counts in one run of its cell (module
    docstring), every count set to 0 just before."""
    from pathtracer_tpu_torch import inverse
    from pathtracer_tpu_torch.kernels import launch_counts, reset_launches
    from pathtracer_tpu_torch.models import procedural
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
    from pathtracer_tpu_torch.ops.camera_rays import ray_frame_tensors
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    def counted(fn, families):
        reset_launches()
        fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        launched = {f for f, c in counts.items() if any(c.values())}
        assert launched == set(families), f"launched {launched}, not {families}"
        return {f: dict(counts[f]) for f in families}

    camera = procedural.cornell_box_camera()
    cornell = procedural.cornell_box_scene(device=dev)[0]
    out = {}
    for family, scene, spp, route in (
            ("small", cornell, 16, "auto"),
            ("shortlist", procedural.torus_cornell_mesh(), 4, "auto"),
            ("tiled", procedural.torus_cornell_mesh(*BAND), 4, "pallas"),
            ("cluster", procedural.torus_cornell_mesh(*BAND), 4, "cluster")):
        if family != "small":
            scene = scene_from_packed(pack_scene(scene), dev)
        st = RenderSettings(width=512, height=512, samples_per_pixel=spp, max_depth=17,
                            rr_prob=0.9, intersector=route)
        out.update(counted(lambda: render_regenerative_stats(scene, camera, st), [family]))

    st = RenderSettings(width=512, height=512, samples_per_pixel=1, max_depth=17, rr_prob=0.9)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in inverse.material_params(cornell).items()}
    step = inverse.make_train_step(st, torch.optim.Adam(list(params.values()), lr=0.05))
    pixel = torch.arange(512 * 512, device=dev)
    frame = ray_frame_tensors(camera, 512, 512, dev)
    target = torch.full((512 * 512, 3), 0.5, device=dev)
    step_counts = counted(lambda: step(params, cornell, frame, target, pixel,
                                       torch.zeros_like(pixel), torch.ones_like(pixel)),
                          ["small", "bounce", "gather_backward"])
    out["gather_backward"] = step_counts["gather_backward"]
    out["bounce"] = step_counts["bounce"]
    return out


def ptxas() -> dict:
    """ptxas's (registers, spilled bytes) by mangled entry name, from this
    process's build of the kernels."""
    from pathtracer_tpu_torch import kernels

    out, entry = {}, None
    for ln in kernels.build_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            entry = m.group(1)
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(entry, [0, 0])[0] = int(m.group(1))
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out.setdefault(entry, [0, 0])[1] = int(m.group(1)) + int(m.group(2))
    return out


def kernel_patterns(entry) -> list:
    """Substrings of the mangled names of the kernels ``entry`` launches."""
    if entry["family"] == "gather_backward":
        return ["segment_sum_partialIlE", "segment_sum_finish"]
    if entry["family"] == "bounce":
        return [f"bounce_{entry['entry']}_kernel"]
    return [f"{entry['family']}_kernelILb{int(entry['entry'] == 'occluded')}E"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    entries = intersection_entries(dev) + segment_sum_entries(dev) + bounce_entries(dev)
    errors = {e["name"]: check(e) for e in entries}
    print(f"checked {len(errors)} entries against their references", flush=True)
    launches = cell_launches(dev)
    regs = ptxas()
    rows = []
    for e in entries:
        ms, plain_ms = graph_ms(e["call"]), event_ms(e["refs"][0])
        if "baseline" in e:
            ms -= graph_ms(e["baseline"])
        bound, by = e["bound"]
        found = [v for name, v in regs.items() if any(p in name for p in kernel_patterns(e))]
        source, replaces = SOURCES[e["family"]]
        rows.append({
            "name": e["name"], "route": "cuda", "source": f"pathtracer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[e["family"]][e["entry"]],
            "max_abs_err": errors[e["name"]], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
            "library_ms": plain_ms if e["family"] == "gather_backward" else None,
            "registers": [v[0] for v in found] or None,
            "spill_bytes": [v[1] for v in found] or None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
