#!/usr/bin/env python3
"""What each part of the tiled kernel's design costs, on one GPU.

    python tiled_variants.py [--rounds 2]

Builds one library per variant of ``pathtracer_tpu_torch/csrc/
intersect_tiled.cu``, each from edits of the source, with the port's nvcc
flags, all variants' nvcc started together:

- ``shipped``: the source as it is (rows read through L1/L2, 128 threads a
  block).
- ``rows in shared, 128 / 512 threads``: each block stages the whole table in
  shared memory once (8 KB a tile, so at most 28 tiles) and reads the rows
  from there; ``rows via L1/L2, 512 threads`` isolates the block size.
- ``dense only`` / ``sparse only``: every needed tile swept one ray per lane,
  or one ray at a time by the whole warp.
- ``no slack``: the cull compares entries exactly, as the shortlist kernel
  does.
- ``no sweeps``: the walk visits the tiles but sweeps none (no lane's bound
  ever falls, so every lane computes every entry it would: the root test
  and the walk without the tests).

The cut variant is only timed. Every other variant must give the brute
sweep's ``t`` (0 ULP), its ids on hit lanes and its occlusion and hit_any on
chip_smoke.py's 262,144 rays on the band stand-in (1,152 padded triangles, 9
tiles) and on the 2,276-triangle one (20 tiles). Then, in ``--rounds``
rounds, forward and backward in turn, each variant's ms per call
(``torch.cuda.Event`` over 20 launches) of both entries at 262,144 rays on
those two stand-ins, and, for the exact variants, its kernel ms in one
profiled render of the band cell (512^2, spp 4, as chip_smoke.py phase 11).
Prints ptxas's registers and spills of each entry (closest, occluded) and
the resident warps per SM of each variant, every reading, and each variant's
mean over the rounds.
"""

import argparse
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
import shortlist_variants as sv

SOURCE = "intersect_tiled.cu"
ENTRIES = ("pt_tiled_closest", "pt_tiled_occluded", "pt_tiled_blocks_per_sm")
# Rows staged in shared memory: plain loads (shared memory has no read-only
# path), the block's copy of the table, and the dynamic shared memory its
# launch and occupancy query ask for.
STAGED = [
    ("  const float4 a = __ldg(rows + j * kRow4), b = __ldg(rows + j * kRow4 + 1),\n"
     "               v = __ldg(rows + j * kRow4 + 2);",
     "  const float4 a = rows[j * kRow4], b = rows[j * kRow4 + 1], v = rows[j * kRow4 + 2];"),
    ("  const float4* table4 = reinterpret_cast<const float4*>(table);\n",
     "  const float4* table4 = reinterpret_cast<const float4*>(table);\n"
     "  extern __shared__ float4 staged[];\n"
     "  for (int i = threadIdx.x; i < c * kTile * kRow4; i += kThreads) staged[i] = table4[i];\n"
     "  __syncthreads();\n"
     "  table4 = staged;\n"),
    ("template <bool kAnyHit>\nint launch(",
     "template <bool kAnyHit>\nint stage(int c) {\n"
     "  const int smem = c * kTile * kCols * static_cast<int>(sizeof(float));\n"
     "  cudaFuncSetAttribute(tiled_kernel<kAnyHit>,\n"
     "                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  return smem;\n}\n\n"
     "template <bool kAnyHit>\nint launch("),
    ("<<<grid, kThreads, 0, ", "<<<grid, kThreads, stage<kAnyHit>(c), "),
    ("tiled_kernel<kAnyHit>, kThreads, 0);", "tiled_kernel<kAnyHit>, kThreads, stage<kAnyHit>(c));"),
]
THREADS = "constexpr int kThreads = 128;"
DENSE = "constexpr int kDenseLanes = 28;"
SLACK = "constexpr float kSlack = 1.0f / 4096;"
SWEEP = "if (!needing) return;"
CUT = ("no sweeps",)  # not exact: timed only


def variants() -> dict:
    """name -> [(text of the source, its replacement)]."""
    wide = (THREADS, THREADS.replace("128", "512"))
    return {
        "shipped": [],
        "rows in shared, 128 threads": STAGED,
        "rows in shared, 512 threads": [*STAGED, wide],
        "rows via L1/L2, 512 threads": [wide],
        "dense only": [(DENSE, DENSE.replace("28", "0"))],
        "sparse only": [(DENSE, DENSE.replace("28", "33"))],
        "no slack": [(SLACK, "constexpr float kSlack = 0.0f;")],
        # A condition nvcc cannot fold, so the entry and the vote stay.
        "no sweeps": [(SWEEP, "if (!needing || bounds != nullptr) return;")],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiled_variants: no CUDA device available", file=sys.stderr)
        return 1
    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_tiled as it

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kernels.library()
    built = sv.build(variants(), SOURCE)
    libs = {name: sv.load(so, ENTRIES) for name, (so, _) in built.items()}
    shipped = kernels._lib

    o, d, cut_scale = cs.smoke_rays(dev)
    cases = {}
    for label, scene in (("band1152", cs.band_scene(dev)),
                         ("torus2276", cs.stand_in_scenes(dev)[1][1])):
        ref = tint.closest_tri_brute(scene, o, d)
        t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * cut_scale
        cases[label] = (scene, t_cut, ref, tint._occluded_tri_brute(scene, o, d, t_cut))
    for name, (_, lines) in built.items():
        c = cases["band1152"][0].padded_tris // 128
        warps = [libs[name].pt_tiled_blocks_per_sm(c, a) for a in (0, 1)]
        threads = 512 if "512" in name else 128
        print(f"[ptxas] {name}: {' | '.join(lines)}; resident warps per SM at {c} tiles: "
              f"closest {warps[0] * threads // 32}, occluded {warps[1] * threads // 32}",
              flush=True)

    run, _ = cs.band_render(dev)
    run("pallas")  # warm-up: tables, sort bounds
    rays = set()

    def measure(name) -> list:
        kernels._lib = libs[name]
        row = []
        for label, (scene, t_cut, ref, (occ_b, any_b)) in cases.items():
            if name not in CUT:
                t, tri = it.closest_tri_tiled(scene, o, d)
                torch.cuda.synchronize()
                cs.assert_same_hits(f"{name} {label}", scene, o, d, t, tri, "brute", ref)
                occ, hit_any = it.occluded_tri_tiled(scene, o, d, t_cut, True)
                assert torch.equal(occ, occ_b) and torch.equal(hit_any, any_b), name
                assert torch.equal(it.occluded_tri_tiled(scene, o, d, t_cut)[0], occ_b), name
            row += [cs.event_ms(lambda: it.closest_tri_tiled(scene, o, d)),
                    cs.event_ms(lambda: it.occluded_tri_tiled(scene, o, d, t_cut))]
        if name in CUT:
            row += [float("nan")] * 2
            launches = ""
        else:
            out, (_, ks) = cs.profiled_render(lambda: run("pallas"), "tiled_kernel",
                                              lambda res: res[4]["tiled"])
            rays.add(out[1])
            row += [sum(ks["closest"]) / 1e3, sum(ks["occluded"]) / 1e3]
            launches = f" ({len(ks['closest'])} + {len(ks['occluded'])} launches)"
        kernels._lib = shipped
        print(f"[variant] {name}: band 262,144 rays closest {row[0]:.4f} occluded "
              f"{row[1]:.4f} ms; 2,276 tris closest {row[2]:.4f} occluded {row[3]:.4f} ms; "
              f"per band render closest {row[4]:.3f} occluded {row[5]:.3f} ms{launches}",
              flush=True)
        return row

    names = list(libs)
    readings = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            readings[name].append(measure(name))
    assert len(rays) == 1, f"the variants traced different rays: {rays}"
    print(f"[summary] every variant but {', '.join(CUT)}: t 0 ULP from brute, ids, "
          f"occlusion and hit_any equal; each band render traced {rays.pop()} rays",
          flush=True)
    for name, rows in readings.items():
        mean = np.mean(rows, axis=0)
        print(f"[summary] {name}: mean of {args.rounds}: band closest {mean[0]:.4f} "
              f"occluded {mean[1]:.4f} ms; 2,276 tris closest {mean[2]:.4f} occluded "
              f"{mean[3]:.4f} ms; per band render {mean[4]:.3f} + {mean[5]:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
