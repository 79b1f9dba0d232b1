#!/usr/bin/env python3
"""What each part of the cluster kernel's design costs, on one GPU.

    python cluster_variants.py [--rounds 2] [--earlier DIR]

Builds one library per variant of ``pathtracer_tpu_torch/csrc/
intersect_cluster.cu`` (with ``csrc/tile_walk.cuh`` inlined), each from edits
of the source, with the port's nvcc flags:

- ``shipped``: the source as it is (tile_walk.cuh's walk, the tiled
  kernel's, in index order).
- ``dense only`` / ``sparse only``: every needed cluster swept one ray per
  lane, or one ray at a time by the whole warp.
- ``tiled kernel``: ``csrc/intersect_tiled.cu`` as it is (the same walk),
  through its own wrappers: its times beside the shipped ones are the spread
  of identical kernels in one call.

``--earlier DIR`` adds the cluster and tiled kernels of ``DIR``, a checkout
of the port before (``earlier cluster``: its closest entry alone, which then
also answered the shadow rays; ``earlier tiled``), each built alone from
``DIR``'s sources.

Every variant must give the brute sweep's ``t`` (0 ULP), its ids on hit lanes
and, for an any-hit entry, its occlusion and hit_any, on chip_smoke.py's
262,144 rays as they come and sorted as the pool sorts them on the cluster
route, on the band stand-in (9 clusters), the 2,276-triangle stand-in (20)
and the 12,580-triangle one (100); of the earlier cluster kernel, whose cull
could not promise it, the lanes that differ are counted. Then, in
``--rounds`` rounds, forward and backward in turn, each variant's ms per call
(``chip_smoke.event_ms``, 20 launches) of both entries on those rays,
unsorted and sorted, and its kernel
ms in one profiled band render (512^2, spp 4, as chip_smoke.py phase 11)
through "cluster" (the tiled variants: through "pallas"). Prints ptxas's
registers and spills of each entry and the resident warps per SM of each
variant, every reading, and each variant's mean over the rounds.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
import shortlist_variants as sv

SOURCE = "intersect_cluster.cu"
TILED_SOURCE = "intersect_tiled.cu"
ENTRIES = ("pt_cluster_closest", "pt_cluster_occluded", "pt_cluster_blocks_per_sm")
TILED_ENTRIES = ("pt_tiled_closest", "pt_tiled_occluded", "pt_tiled_blocks_per_sm")
DENSE = "constexpr int kDenseLanes = 28;"
TILED, EARLIER, EARLIER_TILED = "tiled kernel", "earlier cluster", "earlier tiled"
SCENES = ("band1152", "torus2276", "torus12580")


def variants() -> dict:
    """name -> [(text of the source, its replacement)]."""
    return {
        "shipped": [],
        "dense only": [(DENSE, DENSE.replace("28", "0"))],
        "sparse only": [(DENSE, DENSE.replace("28", "33"))],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--earlier", metavar="DIR",
                   help="a checkout of the port with the earlier design, timed beside")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_variants: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_cluster as ic
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kernels.library()
    built = sv.build(variants(), SOURCE)
    built.update(sv.build({TILED: []}, TILED_SOURCE))
    if args.earlier:
        csrc = os.path.join(args.earlier, "pathtracer_tpu_torch", "csrc")
        built.update(sv.build({EARLIER: []}, SOURCE, csrc))
        built.update(sv.build({EARLIER_TILED: []}, TILED_SOURCE, csrc))
    # name -> (library, closest, occluded or None, route of its render, kernel)
    kinds = {}
    for name, (so, _) in built.items():
        if name in (TILED, EARLIER_TILED):
            kinds[name] = (sv.load(so, TILED_ENTRIES), it.closest_tri_tiled,
                           it.occluded_tri_tiled, "pallas", "tiled_kernel")
        elif name == EARLIER:
            kinds[name] = (sv.load(so, ENTRIES[:1]), ic.closest_tri_cluster, None, "cluster",
                           "cluster_closest_kernel")
        else:
            kinds[name] = (sv.load(so, ENTRIES), ic.closest_tri_cluster,
                           ic.occluded_tri_cluster, "cluster", "cluster_kernel")
    shipped = kernels._lib

    o, d, cut_scale = cs.smoke_rays(dev)
    scenes = dict(cs.stand_in_scenes(dev))
    scenes["band1152"] = cs.band_scene(dev)
    cases = {}  # (scene, order) -> (scene, o, d, t_cut, brute (t, id), brute (occ, hit_any))
    for label in SCENES:
        scene = scenes[label]
        ref = tint.closest_tri_brute(scene, o, d)
        t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * cut_scale
        flags = tint._occluded_tri_brute(scene, o, d, t_cut)
        perm = cs.sorted_lanes(scene, o, d)
        cases[label, "unsorted"] = (scene, o, d, t_cut, ref, flags)
        cases[label, "sorted"] = (scene, *(x[perm].contiguous() for x in (o, d, t_cut)),
                                  tuple(x[perm] for x in ref), tuple(x[perm] for x in flags))
    c = scenes["band1152"].padded_tris // 128
    for name, (_, lines) in built.items():
        lib = kinds[name][0]
        query = getattr(lib, "pt_tiled_blocks_per_sm" if kinds[name][3] == "pallas"
                        else "pt_cluster_blocks_per_sm", None)
        resident = (f"closest {4 * query(c, 0)}, occluded {4 * query(c, 1)}" if query
                    else "not queried (no occupancy entry)")
        print(f"[ptxas] {name}: {' | '.join(lines)}; resident warps per SM at {c} clusters: "
              f"{resident}", flush=True)

    run, _ = cs.band_render(dev)
    for route in ("cluster", "pallas"):
        run(route)  # warm-up: tables, sort bounds
    rays = set()

    def use(name):
        """Route the wrappers (and the band render) to ``name``'s kernels."""
        kernels._lib = kinds[name][0]
        if name == EARLIER:  # its shadow rays went through the closest entry
            tint._OCCLUDED_ANY.pop("cluster")
        return kinds[name][1:]

    def restore():
        kernels._lib = shipped
        tint._OCCLUDED_ANY["cluster"] = ic.occluded_tri_cluster

    for name in kinds:  # exactness, once per variant
        closest, occluded, *_ = use(name)
        for (label, order), (scene, oo, dd, t_cut, ref, (occ_b, any_b)) in cases.items():
            t, tri = closest(scene, oo, dd)
            torch.cuda.synchronize()
            if name == EARLIER:  # its unwidened cull cannot promise brute's answer
                wrong = (t != ref[0]) | (torch.isfinite(ref[0]) & (tri != ref[1]))
                print(f"[exact] {name} {label} {order}: {int(wrong.sum())} lanes differ from "
                      "brute", flush=True)
                continue
            cs.assert_same_hits(f"{name} {label} {order}", scene, oo, dd, t, tri, "brute", ref)
            if occluded is not None:
                occ, hit_any = occluded(scene, oo, dd, t_cut, True)
                assert torch.equal(occ, occ_b) and torch.equal(hit_any, any_b), (name, label)
                assert torch.equal(occluded(scene, oo, dd, t_cut)[0], occ_b), (name, label)
        restore()

    def measure(name) -> list:
        closest, occluded, route, kernel = use(name)
        row = []
        for scene, oo, dd, t_cut, _, _ in cases.values():
            row += [cs.event_ms(lambda: closest(scene, oo, dd)),
                    cs.event_ms(lambda: occluded(scene, oo, dd, t_cut)) if occluded
                    else float("nan")]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = run(route)
        spans = cs.device_spans(prof)
        if name == EARLIER:
            ks = {"closest": [b - a for a, b, nm in spans if kernel in nm], "occluded": []}
        else:
            ks = cs.entry_spans(spans, kernel)
        family = "tiled" if route == "pallas" else "cluster"
        assert {k: len(v) for k, v in ks.items() if v} == {
            k: v for k, v in out[4][family].items() if v}, (ks.keys(), out[4][family])
        rays.add(out[1])
        row += [sum(ks["closest"]) / 1e3, sum(ks["occluded"]) / 1e3]
        restore()
        print(f"[variant] {name}: " + "; ".join(
            f"{label} {order} closest {row[2 * i]:.4f} occluded {row[2 * i + 1]:.4f} ms"
            for i, (label, order) in enumerate(cases))
            + f"; per band render ({route}) closest {row[-2]:.3f} occluded {row[-1]:.3f} ms "
            f"({len(ks['closest'])} + {len(ks['occluded'])} launches)", flush=True)
        return row

    names = list(kinds)
    readings = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            readings[name].append(measure(name))
    assert len(rays) == 1, f"the variants traced different rays: {rays}"
    print(f"[summary] every variant: t 0 ULP from brute, ids equal, occlusion and hit_any "
          f"equal on {len(cases)} cases; each band render traced {rays.pop()} rays", flush=True)
    for name, rows in readings.items():
        mean = np.mean(rows, axis=0)
        print(f"[summary] {name}: mean of {args.rounds}: " + "; ".join(
            f"{label} {order} {mean[2 * i]:.4f} / {mean[2 * i + 1]:.4f} ms"
            for i, (label, order) in enumerate(cases))
            + f"; per band render {mean[-2]:.3f} + {mean[-1]:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
