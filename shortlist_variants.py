#!/usr/bin/env python3
"""What each part of the shortlist kernel costs, on one GPU.

    python shortlist_variants.py [--rounds 2]

Builds one library per variant of ``pathtracer_tpu_torch/csrc/
intersect_shortlist.cu``, each from one edit of the source, with the port's
nvcc flags, all variants' nvcc started together:

- ``dense>=N``: a cluster that at least N lanes of a warp need takes the dense
  sweep (one ray per lane), fewer lanes the sparse one (the whole warp on one
  ray at a time). 28 is the source as it is, 0 dense sweeps only, 33 sparse
  sweeps only.
- ``dense>=28 unroll 1`` and ``unroll full``: the dense sweep's row loop
  unrolled 1 or 128 times instead of 2.
- ``keys only``: the walk visits no cluster, so the root test, the keys and
  their sort remain.
- ``no sweeps``: the walk runs but sweeps nothing (no lane's best ever falls,
  so it visits every cluster a lane enters: more walk than the kernel does).

Each ``dense>=N`` variant must give the brute sweep's ``t`` (0 ULP), its ids
on hit lanes and its occlusion on chip_smoke.py's 262,144 rays; the two cut
variants are only timed. Then, in ``--rounds`` rounds, forward and backward in
turn, each variant's ms per call (``torch.cuda.Event`` over 20 launches) at
262,144 rays on the 12,580-triangle stand-in and at 65,535 rays on the
65,572-triangle one (516 clusters), and for the ``dense>=N`` variants the
shortlist kernel's ms in one profiled render of the torus cell (512^2, spp 4,
as chip_smoke.py phase 9). Prints ptxas's registers and spills per variant,
every reading, and each variant's mean over the rounds.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import types

import numpy as np
import torch

import chip_smoke as cs

SOURCE = "intersect_shortlist.cu"
DENSE = "constexpr int kDenseLanes = 28;"
UNROLL = "#pragma unroll 2\n  for (int j = 0; j < kCluster; ++j) {"
WALK = "for (int i = 0; i < c; ++i) {"
SWEEP = "const unsigned needing = __ballot_sync(kFull, need);"


def variants() -> dict:
    """name -> [(text of the source, its replacement)]."""
    out = {f"dense>={n}": [(DENSE, f"constexpr int kDenseLanes = {n};")]
           for n in (0, 16, 24, 28, 31, 33)}
    out["dense>=28 unroll 1"] = [(UNROLL, UNROLL.replace("unroll 2", "unroll 1"))]
    out["dense>=28 unroll full"] = [(UNROLL, UNROLL.replace("unroll 2", "unroll"))]
    out["keys only"] = [(WALK, "for (int i = 0; i < 0; ++i) {")]
    out["no sweeps"] = [(SWEEP, SWEEP + "\n      if (needing) continue;")]
    return out


def build(names_edits: dict, source: str = SOURCE) -> dict:
    """Build every variant of ``csrc/<source>``; name -> (library path,
    ptxas's figures, one line per entry: ``kernel<true>`` is the occluded
    entry, ``kernel<false>`` the closest one)."""
    from pathtracer_tpu_torch import kernels

    with open(os.path.join(kernels.CSRC, source)) as f:
        src = f.read()
    out_dir = os.path.join(kernels.BUILD_DIR, "variants", os.path.splitext(source)[0])
    os.makedirs(out_dir, exist_ok=True)
    nvcc = kernels._nvcc()
    procs = {}
    for i, (name, edits) in enumerate(names_edits.items()):
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-shared", "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed for {name}:\n{log}"
        figures, entry = {}, "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                entry = "occluded" if "ILb1E" in ln else "closest"
            elif "registers" in ln or "spill" in ln:
                figures.setdefault(entry, []).append(ln.split("info    : ")[-1].strip())
        built[name] = (so, [f"{e}: {', '.join(v)}" for e, v in sorted(figures.items())])
    return built


def load(so: str, entries=("pt_shortlist_closest", "pt_shortlist_occluded")):
    """A stand-in for ``kernels.library()`` whose ``entries`` are the
    variant's."""
    from pathtracer_tpu_torch import kernels

    lib = ctypes.CDLL(so)
    ns = types.SimpleNamespace(pt_error_string=kernels.library().pt_error_string)
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = kernels._SIGNATURES[name]
        setattr(ns, name, fn)
    return ns


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("shortlist_variants: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from pathtracer_tpu_torch import kernels
    from pathtracer_tpu_torch.models.pack import pack_scene
    from pathtracer_tpu_torch.models.procedural import cornell_box_camera, torus_cornell_mesh
    from pathtracer_tpu_torch.models.scene import RenderSettings, scene_from_packed
    from pathtracer_tpu_torch.ops import intersect as tint
    from pathtracer_tpu_torch.ops import intersect_shortlist_kernel as sk
    from pathtracer_tpu_torch.ops.wavefront import render_regenerative_stats

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    kernels.library()
    built = build(variants())
    for name, (_, lines) in built.items():
        print(f"[ptxas] {name}: {' | '.join(lines)}", flush=True)
    libs = {name: load(so) for name, (so, _) in built.items()}
    shipped = kernels._lib

    o, d, cut_scale = cs.smoke_rays(dev)
    scene = cs.stand_in_scenes(dev)[0][1]
    big = scene_from_packed(pack_scene(torus_cornell_mesh(*cs.LARGEST_MESH)), dev)
    lanes = torch.arange(cs.LARGEST_RAYS, device=dev) * 4
    ob, db = o[lanes].contiguous(), d[lanes].contiguous()
    cases = {}
    for label, sc, oo, dd, scale in (("12580", scene, o, d, cut_scale),
                                     ("65572", big, ob, db, cut_scale[lanes])):
        ref = tint.closest_tri_brute(sc, oo, dd)
        t_cut = torch.where(torch.isfinite(ref[0]), ref[0], 1.0) * scale
        cases[label] = (sc, oo, dd, t_cut, ref, tint._occluded_tri_brute(sc, oo, dd, t_cut)[0])

    camera = cornell_box_camera()
    settings = RenderSettings(width=cs.LARGE_SIZE, height=cs.LARGE_SIZE, samples_per_pixel=4,
                              max_depth=17, rr_prob=0.9, scheduler="regen",
                              batch_size=1 << 18)
    render_regenerative_stats(scene, camera, settings)  # warm-up: tables, sort
    torch.cuda.synchronize()
    rays = set()

    def measure(name) -> list:
        kernels._lib = libs[name]
        row = []
        for label, (sc, oo, dd, t_cut, ref, occ_ref) in cases.items():
            if name.startswith("dense"):
                t, tri = sk.closest_tri_shortlist_kernel(sc, oo, dd)
                occ = sk.occluded_tri_shortlist_kernel(sc, oo, dd, t_cut)
                torch.cuda.synchronize()
                cs.assert_same_hits(f"{name} {label}", sc, oo, dd, t, tri, "brute", ref)
                assert torch.equal(occ, occ_ref), f"{name} {label}: occluded differs"
            row += [cs.event_ms(lambda: sk.closest_tri_shortlist_kernel(sc, oo, dd)),
                    cs.event_ms(lambda: sk.occluded_tri_shortlist_kernel(sc, oo, dd, t_cut))]
        if name.startswith("dense"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, n, _ = render_regenerative_stats(scene, camera, settings)
                torch.cuda.synchronize()
            rays.add(int(n))
            sl = cs.entry_spans(cs.device_spans(prof))
            row += [sum(sl["closest"]) / 1e3, sum(sl["occluded"]) / 1e3]
            launches = f" ({len(sl['closest'])} + {len(sl['occluded'])} launches)"
        else:
            row += [float("nan")] * 2
            launches = ""
        kernels._lib = shipped
        print(f"[variant] {name}: 12,580 tris x 262,144 rays closest {row[0]:.4f} occluded "
              f"{row[1]:.4f} ms; 516 clusters x 65,535 rays closest {row[2]:.4f} occluded "
              f"{row[3]:.4f} ms; per torus render closest {row[4]:.3f} occluded "
              f"{row[5]:.3f} ms{launches}", flush=True)
        return row

    names = list(libs)
    readings = {name: [] for name in names}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            readings[name].append(measure(name))
    assert len(rays) == 1, f"the variants traced different rays: {rays}"
    print(f"[summary] every dense>=N variant: t 0 ULP from brute, ids and occlusion "
          f"equal; each render traced {rays.pop()} rays", flush=True)
    for name, rows in readings.items():
        mean = np.mean(rows, axis=0)
        print(f"[summary] {name}: mean of {args.rounds}: 12,580 closest {mean[0]:.4f} "
              f"occluded {mean[1]:.4f} ms; 516 clusters closest {mean[2]:.4f} occluded "
              f"{mean[3]:.4f} ms; per render {mean[4]:.3f} + {mean[5]:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
