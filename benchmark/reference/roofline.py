"""The least time an NVIDIA H100 could take for an intersection call: a
frozen copy of ``pathtracer_tpu_torch/roofline.py``'s arithmetic (with
``cluster_bounds`` and ``enter_dists`` of ``ops/intersect_shortlist.py``),
applied to the inputs of the calls a traced window made.

- Operations: 46 float operations per ray/triangle test (``hit_triangle`` in
  the port's ``csrc/ray_triangle.cuh``) times the tests the inputs need:
  closest hit, per ray the valid triangles of every 128-triangle cluster
  (in the port's packed order) whose slab entry lies before the call's
  closest ``t``; any-hit, those before the cutoff, or 1 test for a ray found
  occluded. Over 67 TFLOP/s, the H100 SXM's float32 rate outside the tensor
  cores at its 700 W limit.
- Bytes: per ray 24 of origin and direction, 4 more of cutoff for any-hit;
  out 12 (t and id) or 1 (the flag); 64 per table row, read once. Over
  3.35 TB/s. The same for every kernel that implements a call, so the share
  reads the same work whatever computes it.

The bound is the larger of the two.
"""

from __future__ import annotations

import torch

FLOPS_PER_TEST = 46
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CLUSTER = 128
ROW_BYTES = 64
_CHUNK = 1 << 15
_BIG_F = 3.0e38
INF = float("inf")


def padded_rows(num_tris: int) -> int:
    """The port's padded triangle count (``models/pack.py``), rounded up to
    whole clusters: the rows of a kernel's table."""
    tp = -(-max(num_tris, 1) // 128) * 128
    if tp > 2048:
        tp = -(-tp // 512) * 512
    return -(-tp // CLUSTER) * CLUSTER


def cluster_bounds(v0, e1, e2):
    """(lo [C, 3], hi [C, 3]) of each CLUSTER-triangle run."""
    t = v0.shape[0]
    tp = -(-t // CLUSTER) * CLUSTER
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
    valid = torch.arange(tp, device=v0.device) < t
    pts = torch.nn.functional.pad(pts, (0, 0, 0, 0, 0, tp - t))
    m = valid[:, None, None]
    c = tp // CLUSTER
    lo = torch.where(m, pts, _BIG_F).reshape(c, CLUSTER * 3, 3).amin(dim=1)
    hi = torch.where(m, pts, -_BIG_F).reshape(c, CLUSTER * 3, 3).amax(dim=1)
    counts = valid.reshape(c, CLUSTER).sum(dim=1)
    return lo, hi, counts


def _inv(w):
    mag = torch.clamp(torch.abs(w), min=1e-12)
    return torch.where(w >= 0.0, 1.0, -1.0) / mag


def enter_dists(o, d, lo, hi):
    """Slab entry distance of every ray to every box -> [B, C], inf on a miss."""
    t_near = torch.full((o.shape[0], lo.shape[0]), -_BIG_F, device=o.device)
    t_far = torch.full((o.shape[0], lo.shape[0]), _BIG_F, device=o.device)
    for ax in range(3):
        i = _inv(d[:, ax:ax + 1])
        t0 = (lo[None, :, ax] - o[:, ax:ax + 1]) * i
        t1 = (hi[None, :, ax] - o[:, ax:ax + 1]) * i
        t_near = torch.maximum(t_near, torch.minimum(t0, t1))
        t_far = torch.minimum(t_far, torch.maximum(t0, t1))
    ok = (t_far >= t_near) & (t_far > 0.0) & (lo[None, :, 0] <= hi[None, :, 0])
    return torch.where(ok, torch.clamp(t_near, min=0.0), INF)


def tests_needed(bounds, o, d, t_stop, occluded=None) -> int:
    """Ray/triangle tests these inputs need (``bounds`` from
    ``cluster_bounds``)."""
    lo, hi, counts = bounds
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    for s in range(0, o.shape[0], _CHUNK):
        e = enter_dists(o[s:s + _CHUNK], d[s:s + _CHUNK], lo, hi)
        per_ray = torch.where(e < t_stop[s:s + _CHUNK, None], counts, 0).sum(dim=1)
        if occluded is not None:
            per_ray = torch.where(occluded[s:s + _CHUNK], 1, per_ray)
        total += per_ray.sum()
    return int(total)


def bound_ms(tests: int, rays: int, table_rows: int, any_hit: bool) -> float:
    ops_s = FLOPS_PER_TEST * tests / PEAK_F32_FLOPS
    per_ray = 24 + (4 if any_hit else 0) + (1 if any_hit else 12)
    bytes_s = (per_ray * rays + ROW_BYTES * table_rows) / PEAK_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s)
