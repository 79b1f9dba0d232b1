"""The least time an NVIDIA H100 could take for an intersection call.

One definition for the four intersection kernels (small, shortlist, tiled,
cluster), so that kernels computing the same closest hit on the same rays are
held to the same work whatever implements it. ``chip_smoke.py`` reports it as
``bound_ms`` beside each kernel's time.

- Operations: 46 float operations per ray/triangle test, counted from
  ``hit_triangle`` (csrc/ray_triangle.cuh): 9 for pvec, 5 for det, 1 for
  the reciprocal, 3 for s, 6 for u, 9 for qvec, 6 for v, 6 for t and 1 for
  u + v; times the tests these inputs need (``tests_needed``); over the
  card's 67 TFLOP/s in float32 outside the tensor cores.
- Bytes: per ray 24 of origin and direction, plus 4 of cutoff for any-hit;
  out 12 (t and id; 24 with the small kernel's normal and material) or 1
  (the flag); 64 per table row, read once; over
  3.35 TB/s.

The bound is the larger of the two (NVIDIA's data sheet, H100 SXM, at the
700 W power limit).
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.intersect_shortlist import cluster_bounds, enter_dists

FLOPS_PER_TEST = 46
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CLUSTER = 128  # triangles per cluster, as the kernels' table groups them
ROW_BYTES = 64
_CHUNK = 1 << 15  # rays per [chunk, C] entry matrix


def tests_needed(scene, o, d, t_stop, occluded=None) -> int:
    """Ray/triangle tests these inputs need.

    Closest hit (``occluded`` None): per ray, the valid triangles of every
    128-triangle cluster whose slab entry is below ``t_stop``, the brute
    sweep's final ``t`` (inf on a miss). Any-hit (``occluded`` the [B] bool
    result): an unoccluded ray counts every cluster entered before its
    cutoff ``t_stop``; an occluded ray counts 1.
    """
    lo, hi = cluster_bounds(scene, CLUSTER)
    valid = scene.tri_valid.to(torch.int64)
    pad = lo.shape[0] * CLUSTER - valid.shape[0]
    counts = torch.nn.functional.pad(valid, (0, pad)).reshape(-1, CLUSTER).sum(dim=1)
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    for s in range(0, o.shape[0], _CHUNK):
        e = enter_dists(o[s : s + _CHUNK], d[s : s + _CHUNK], lo, hi)
        per_ray = torch.where(e < t_stop[s : s + _CHUNK, None], counts, 0).sum(dim=1)
        if occluded is not None:
            per_ray = torch.where(occluded[s : s + _CHUNK], 1, per_ray)
        total += per_ray.sum()
    return int(total)


def bound_ms(tests: int, rays: int, table_rows: int, any_hit: bool,
             out_bytes: int | None = None) -> tuple[float, str]:
    """(least milliseconds, "operations" or "bytes", whichever bounds it).

    ``out_bytes``: the bytes written per ray, where the call writes more than
    the module's default (the small kernel's closest entry: t, id, normal and
    material, 24).
    """
    ops_s = FLOPS_PER_TEST * tests / PEAK_F32_FLOPS
    if out_bytes is None:
        out_bytes = 1 if any_hit else 12
    per_ray = 24 + (4 if any_hit else 0) + out_bytes
    bytes_s = (per_ray * rays + ROW_BYTES * table_rows) / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
