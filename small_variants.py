#!/usr/bin/env python3
"""What each part of the small kernel's design costs, on one GPU.

    python small_variants.py [--rounds 2] [--earlier DIR]

Builds one library per variant of ``pathtracer_tpu_torch/csrc/
intersect_small.cu``, each from edits of the source, with the port's nvcc
flags, all variants' nvcc started together:

- ``shipped``: the source as it is (rows in the launch's parameters, the
  root-box and cutoff skip, each block's lanes that need a sweep listed and
  swept together, the scene's valid rows only, 512 threads a block, ptxas
  asked for 64 resident warps).
- ``rows in shared memory``: each block copies the rows into shared memory,
  behind a barrier, and the sweep reads them there.
- ``rows via L1/L2``: the sweep reads the rows from the device table through
  the read-only path.
- ``no compaction``: each lane sweeps its own ray if it needs to (the skip
  per lane only); ``no skip``: every lane sweeps.
- ``all T8 rows``: the rows padded with zero rows to a multiple of 8 and all
  swept, as the 8-rounded table (the Cornell box 40 rows, the 250-triangle
  soup 256).
- ``256 threads`` / ``1024 threads`` a block (the same 32-register cap);
  ``no register cap``: no resident-warp request to ptxas; ``unroll 4``: the
  row loop unrolled 4 times.
- ``no sweep``: every lane's prologue, the list and the stores, no test
  (not exact: timed only).

``--earlier DIR`` adds the earlier design: ``DIR`` is a checkout of the port
before it (its ``pathtracer_tpu_torch/csrc/intersect_small.cu``, built alone
with its own header), driven with the plain versions' [T8, 16] table.

Every exact variant must give the plain versions' ``t`` (0 ULP), ids,
normals, materials, occlusion and hit_any on chip_smoke.py phase 3's rays
(262,144, a quarter parked; cutoffs around the hit, then every seventh 0) on
the Cornell box (36 triangles) and the 250-triangle soup. Then, in
``--rounds`` rounds, forward and backward in turn, each variant's ms per
call of both entries on those (chip_smoke.graph_ms: a CUDA graph of 100
calls, the median of 5 replays timed by events), and, for the exact ones,
its kernel ms in one profiled Cornell render (512^2, spp 16, as
chip_smoke.py phase 6). Prints ptxas's registers and spills of each entry and
the resident warps per SM of each variant, every reading, and each variant's
mean over the rounds.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
import shortlist_variants as sv

SOURCE = "intersect_small.cu"
ENTRIES = ("pt_small_closest", "pt_small_occluded", "pt_small_warps_per_sm")
EARLIER = "earlier design"
ROWS = "  const float* rows = u.rows;\n"
ROW_AT = "row[j] = rows[k * kRowFloats + j];"
THREADS = "constexpr int kThreads = 512;"
MIN_BLOCKS = "constexpr int kMinBlocks = 2048 / kThreads;"
NEED = "need = needs_sweep<kAnyHit>(u.box, ray, kAnyHit ? t_cut[r] : INFINITY, want_any);"
COUNT = "  u.count = count;\n"
LOOP = "  for (int k = 0; k < count; ++k) {\n    float row[10];"
SWEEP = "sweep<kAnyHit>(rows, u.count, table,"
CUT = ("no sweep",)  # not exact: timed only
# The compaction, from its comment to the barrier that ends a chunk.
LIST_FROM = "    // List the chunk's lanes"
LIST_TO = "    __syncthreads();  // the next chunk reuses list and warp_need\n"
NO_LIST = ("    if (need)\n"
           "      sweep<kAnyHit>(rows, u.count, table, load_ray(o, d, r),\n"
           "                     kAnyHit ? t_cut[r] : 0.0f, r, t_out, id_out, n_out, mat_out,\n"
           "                     occ_out, any_out);\n")


def variants(src: str) -> dict:
    """name -> [(text of the source, its replacement)]."""
    listing = src[src.index(LIST_FROM):src.index(LIST_TO) + len(LIST_TO)]
    staged = ("  __shared__ float staged[kMaxRows * kRowFloats];\n"
              "  for (int i = threadIdx.x; i < u.count * kRowFloats; i += kThreads)\n"
              "    staged[i] = u.rows[i];\n"
              "  __syncthreads();\n"
              "  const float* rows = staged;\n")
    padded = ("  u.count = (count + 7) / 8 * 8;\n"
              "  memset(&u.rows[count * kRowFloats], 0,\n"
              "         (u.count - count) * kRowFloats * sizeof(float));\n")
    return {
        "shipped": [],
        "rows in shared memory": [(ROWS, staged)],
        "rows via L1/L2": [(ROWS, "  const float* rows = table;\n"),
                           (ROW_AT, "row[j] = __ldg(&rows[k * kCols + j]);")],
        "no compaction": [(listing, NO_LIST)],
        "no skip": [(NEED, "need = true;")],
        "all T8 rows": [(COUNT, padded)],
        "256 threads": [(THREADS, THREADS.replace("512", "256"))],
        "1024 threads": [(THREADS, THREADS.replace("512", "1024"))],
        "no register cap": [(MIN_BLOCKS, "constexpr int kMinBlocks = 1;")],
        "unroll 4": [(LOOP, f"#pragma unroll 4\n{LOOP}")],
        # The lanes' prologue, list and stores without a test: timed only.
        "no sweep": [(SWEEP, SWEEP.replace("u.count", "0"))],
    }


def earlier_entries(so: str):
    """The earlier design's entries (its C signatures) as (closest,
    occluded) with the wrappers' arguments and results."""
    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops import intersect_small as small

    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pt_small_closest.argtypes = [p, p, p, i, i, p, p, p, p, p]
    lib.pt_small_occluded.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.pt_small_closest.restype = lib.pt_small_occluded.restype = i

    def closest(scene, o, d):
        tab, b = small.small_table(scene), o.shape[0]
        out = (torch.empty(b, device=o.device), torch.empty(b, dtype=torch.int32, device=o.device),
               torch.empty((b, 3), device=o.device),
               torch.empty(b, dtype=torch.int32, device=o.device))
        rc = lib.pt_small_closest(o.data_ptr(), d.data_ptr(), tab.data_ptr(), tab.shape[0], b,
                                  *(x.data_ptr() for x in out),
                                  torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "the earlier small closest-hit kernel")
        return out

    def occluded(scene, o, d, t_cut, want_any=False):
        tab, b = small.small_table(scene), o.shape[0]
        occ = torch.empty(b, dtype=torch.uint8, device=o.device)
        hit_any = torch.empty(b, dtype=torch.uint8, device=o.device) if want_any else None
        rc = lib.pt_small_occluded(o.data_ptr(), d.data_ptr(), t_cut.data_ptr(), tab.data_ptr(),
                                   tab.shape[0], b, occ.data_ptr(),
                                   hit_any.data_ptr() if want_any else None,
                                   torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "the earlier small any-hit kernel")
        return occ.bool(), (hit_any.bool() if want_any else None)

    return closest, occluded


def render_spans(spans) -> dict:
    """The small kernel's device intervals (us) by entry, in the shipped
    design's names (``small_kernel<false>``, ``<true>``) or the earlier
    one's (``small_closest_kernel``, ``small_occluded_kernel``)."""
    ks = cs.entry_spans(spans, "small_kernel")
    for entry in ks:
        ks[entry] += [b - a for a, b, nm in spans if f"small_{entry}_kernel" in nm]
    return ks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--earlier", metavar="DIR",
                   help="a checkout of the port with the earlier design, timed beside")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("small_variants: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.models.procedural import cornell_box_scene
    from pathtracer_tpu_torch.models.scene import RenderSettings
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_small as small
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kernels.library()
    with open(os.path.join(kernels.CSRC, SOURCE)) as f:
        built = sv.build(variants(f.read()), SOURCE)
    libs = {name: sv.load(so, ENTRIES) for name, (so, _) in built.items()}
    shipped = kernels._lib
    # name -> (closest, occluded) as the wrappers take them
    entries = {name: (small.closest_tri_small, small.occluded_tri_small) for name in libs}
    if args.earlier:
        csrc = os.path.join(args.earlier, "pathtracer_tpu_torch", "csrc")
        built.update(sv.build({EARLIER: []}, SOURCE, csrc))
        entries[EARLIER] = earlier_entries(built[EARLIER][0])
    for name, (_, lines) in built.items():
        if name in libs:
            warps = [libs[name].pt_small_warps_per_sm(a) for a in (0, 1)]
            resident = f"closest {warps[0]}, occluded {warps[1]}"
        else:
            resident = "not queried (no occupancy entry)"
        print(f"[ptxas] {name}: {' | '.join(lines)}; resident warps per SM: {resident}",
              flush=True)

    o, d, cut_scale = cs.smoke_rays(dev)
    o, d = cs.park_lanes(o, d)
    cases = {label: scene for label, scene in cs.smoke_scenes(dev)
             if label in ("cornell36", "soup250")}
    cuts = {}  # phase 3's timed cutoffs: around the hit, every seventh 0
    for label, scene in cases.items():
        t = small.closest_tri_small_plain(scene, o, d)[0]
        cuts[label] = torch.where(torch.isfinite(t), t, 1.0) * cut_scale
        cuts[label][::7] = 0.0
    cornell, camera = cornell_box_scene(device=dev)
    settings = RenderSettings(width=512, height=512, samples_per_pixel=16, max_depth=17,
                              rr_prob=0.9, scheduler="regen", batch_size=1 << 18)
    render_regenerative_stats(cornell, camera, settings)  # warm-up: tables, first launches
    torch.cuda.synchronize()
    rays = set()

    def use(name):
        """Route the wrappers (and the render) to ``name``'s kernels."""
        closest, occluded = entries[name]
        kernels._lib = libs.get(name, shipped)
        small.closest_tri_small = closest
        tint._OCCLUDED_ANY["small_pallas"] = occluded
        return closest, occluded

    def measure(name) -> list:
        closest, occluded = use(name)
        row = []
        for label, scene in cases.items():
            cut = cuts[label]
            if name not in CUT:
                cs.small_kernel_checks(f"{name} {label}", scene, o, d, cut_scale,
                                       (closest, occluded))
            row += [cs.graph_ms(lambda: closest(scene, o, d)),
                    cs.graph_ms(lambda: occluded(scene, o, d, cut))]
        launches = ""
        if name in CUT:
            row += [float("nan")] * 2
        else:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, n, _ = render_regenerative_stats(cornell, camera, settings)
                torch.cuda.synchronize()
            rays.add(int(n))
            ks = render_spans(cs.device_spans(prof))
            row += [sum(ks["closest"]) / 1e3, sum(ks["occluded"]) / 1e3]
            launches = f" ({len(ks['closest'])} + {len(ks['occluded'])} launches)"
        use("shipped")
        print(f"[variant] {name}: Cornell 262,144 rays closest {row[0]:.4f} occluded "
              f"{row[1]:.4f} ms; soup250 closest {row[2]:.4f} occluded {row[3]:.4f} ms; "
              f"per Cornell render closest {row[4]:.3f} occluded {row[5]:.3f} ms{launches}",
              flush=True)
        return row

    names = list(entries)
    readings = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            readings[name].append(measure(name))
    assert len(rays) == 1, f"the variants traced different rays: {rays}"
    print(f"[summary] every variant but {', '.join(CUT)}: t 0 ULP from the plain version, "
          f"ids, normals, materials, occlusion and hit_any equal; each Cornell render traced "
          f"{rays.pop()} rays", flush=True)
    for name, rows in readings.items():
        mean = np.mean(rows, axis=0)
        print(f"[summary] {name}: mean of {args.rounds}: Cornell closest {mean[0]:.4f} "
              f"occluded {mean[1]:.4f} ms; soup250 closest {mean[2]:.4f} occluded "
              f"{mean[3]:.4f} ms; per Cornell render {mean[4]:.3f} + {mean[5]:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
