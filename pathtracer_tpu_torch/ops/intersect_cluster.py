"""Cluster-culled closest hit and any-hit: the CUDA kernel and its plain
torch twin.

Port of ``pathtracer_tpu/ops/intersect_cluster.py`` (``closest_tri_cluster``,
``intersector="cluster"``). What the JAX kernel computes: triangles sit in
packed (BVH-leaf) order, so each run of ``CLUSTER`` triangles is spatially
tight and gets the box of its valid triangles. Rays go in groups of
``GROUP`` consecutive lanes (the pool sorts its lanes for this route). The
clusters are visited in index order; a cluster is swept only if some ray of
the group enters its box before that ray's best ``t``, and then every ray of
the group sweeps all its triangles with a strict ``<`` on ``t`` in id order.
The slab math is JAX's: the sign-preserving ``1/max(|w|, 1e-12)``, ``enter =
max(t_near, 0)``, a box hit needs ``t_far >= t_near``, ``t_far > 0`` and
``lo <= hi`` (false for a cluster of padding only), bounds clamped to
+-3e38.

The kernel (``csrc/intersect_cluster.cu``) computes the same function, the
brute sweep's nearest ``t`` with the smallest id among equal ``t``, another
way: per warp and per ray, over the shortlist kernel's table and 128-row
boxes (``intersect_shortlist_kernel.kernel_table``), with a widened cull that
never skips a cluster holding a ray's answer (``csrc/tile_walk.cuh``, the
tiled kernel's walk). Its any-hit entry answers "some triangle before the
per-ray cutoff" and, when asked, "some triangle at all": exactly ``t <
t_cut`` and ``isfinite(t)``, which the JAX package computes from its closest
hit on this route. No cluster cap.

``closest_tri_cluster_plain`` is the closest entry's plain version, the twin
of the JAX kernel's cull at the kernel's cluster and group sizes by default.
It calls ``intersect.mt_components``, so its ``t`` is bit-equal to
``intersect.closest_tri_brute``'s. ``occluded_tri_cluster_plain`` is the
any-hit entry's: ``t < t_cut`` and ``isfinite(t)`` of the twin. The wrappers
take them for tensors on the CPU and launch the kernel for tensors on a CUDA
device: a CUDA tensor never reaches a plain version. ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import intersect_shortlist as shortlist
from pathtracer_tpu_torch.ops.intersect_tiled import launch_closest, launch_occluded

INF = float("inf")
CLUSTER = 128  # triangles per cluster: the shortlist kernel's table and boxes
GROUP = 128  # rays per cull decision of the twin

# Kernel launches by entry point; only the wrappers' launches add to it.
launches = {"closest": 0, "occluded": 0}


def closest_tri_cluster_plain(scene, o, d, cluster: int = CLUSTER, group: int = GROUP):
    """Closest hit by the cluster cull in plain torch -> (t [B] f32, inf on a
    miss; tri_id [B] i64, -1 on a miss).

    The last group is filled with rays at best ``t`` 0, which never make a
    cluster live.
    """
    from pathtracer_tpu_torch.ops.intersect import mt_components

    dev = o.device
    b = o.shape[0]
    ng = -(-b // group)
    bp = ng * group
    best = torch.full((bp,), INF, device=dev)
    best[b:] = 0.0
    if bp != b:
        o = torch.cat([o, torch.zeros((bp - b, 3), device=dev)])
        d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(bp - b, 3)])
    best_id = torch.full((bp,), -1, dtype=torch.int64, device=dev)

    lo, hi = shortlist.cluster_bounds(scene, cluster)
    tp = lo.shape[0] * cluster
    v0, e1, e2 = (shortlist._pad(x, tp) for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    valid = shortlist._pad(scene.tri_valid, tp)
    for k in range(lo.shape[0]):
        enter = shortlist.enter_dists(o, d, lo[k : k + 1], hi[k : k + 1])[:, 0]
        live = (enter < best).reshape(ng, group).any(dim=1)
        if not bool(live.any()):
            continue
        rows = torch.nonzero(live.repeat_interleave(group)).squeeze(1)
        s = slice(k * cluster, (k + 1) * cluster)
        ro, rd = o[rows], d[rows]
        t, _ = mt_components(
            ro[:, 0:1], ro[:, 1:2], ro[:, 2:3], rd[:, 0:1], rd[:, 1:2], rd[:, 2:3],
            v0[None, s, 0], v0[None, s, 1], v0[None, s, 2],
            e1[None, s, 0], e1[None, s, 1], e1[None, s, 2],
            e2[None, s, 0], e2[None, s, 1], e2[None, s, 2], valid[None, s],
        )
        tile_t, tile_arg = torch.min(t, dim=1)
        better = tile_t < best[rows]
        best[rows] = torch.where(better, tile_t, best[rows])
        best_id[rows] = torch.where(better, tile_arg + k * cluster, best_id[rows])
    t = best[:b]
    return t, torch.where(torch.isfinite(t), best_id[:b], -1)


def occluded_tri_cluster_plain(scene, o, d, t_cut, want_any: bool = False):
    """The any-hit entry's plain version: ``t < t_cut`` and, when
    ``want_any``, ``isfinite(t)`` of the twin's ``t`` (else None)."""
    t, _ = closest_tri_cluster_plain(scene, o, d)
    return t < t_cut, (torch.isfinite(t) if want_any else None)


def closest_tri_cluster(scene, o, d):
    """Closest hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1 on a
    miss)."""
    if o.device.type == "cpu":
        return closest_tri_cluster_plain(scene, o, d)
    return launch_closest("pt_cluster_closest", "cluster closest-hit kernel", launches,
                          scene, o, d)


def occluded_tri_cluster(scene, o, d, t_cut, want_any: bool = False):
    """Shadow occlusion -> (occluded [B] bool: some triangle strictly before
    ``t_cut``; hit_any [B] bool: some triangle at all, when ``want_any``,
    else None)."""
    if o.device.type == "cpu":
        return occluded_tri_cluster_plain(scene, o, d, t_cut, want_any)
    return launch_occluded("pt_cluster_occluded", "cluster any-hit kernel", launches, scene,
                           o, d, t_cut, want_any)
