"""Cluster-culled closest hit: the CUDA kernel and its plain torch twin.

Port of ``pathtracer_tpu/ops/intersect_cluster.py`` (``closest_tri_cluster``,
``intersector="cluster"``). What both compute: triangles sit in packed
(BVH-leaf) order, so each run of ``CLUSTER`` triangles is spatially tight and
gets the box of its valid triangles. Rays go in groups of ``GROUP``
consecutive lanes (the pool sorts its lanes for this route). The clusters are
visited in index order; a cluster is swept only if some ray of the group
enters its box before that ray's best ``t``, and then every ray of the group
sweeps all its triangles with a strict ``<`` on ``t`` in id order. The slab
math is JAX's: the sign-preserving ``1/max(|w|, 1e-12)``, ``enter =
max(t_near, 0)``, a box hit needs ``t_far >= t_near``, ``t_far > 0`` and
``lo <= hi`` (false for a cluster of padding only), bounds clamped to
+-3e38.

The kernel (``csrc/intersect_cluster.cu``) takes one group per 128-thread
block and reads the shortlist kernel's table and boxes
(``intersect_shortlist_kernel.kernel_table``); it computes each entry
distance when it reaches the cluster, so it has no cluster cap. The JAX
kernel's 1024-ray blocks and 512-triangle clusters were TPU sizes.

``closest_tri_cluster_plain`` is the kernel's plain version, at the kernel's
cluster and group sizes by default. It calls ``intersect.mt_components``, so
its ``t`` is bit-equal to ``intersect.closest_tri_brute``'s. The wrapper
takes it for tensors on the CPU and launches the kernel for tensors on a CUDA
device: a CUDA tensor never reaches the plain version. ``launches`` counts the
kernel launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import intersect_shortlist as shortlist
from pathtracer_tpu_torch.ops.intersect_shortlist_kernel import kernel_table
from pathtracer_tpu_torch.ops.intersect_small import check_rays

INF = float("inf")
CLUSTER = 128  # triangles per cluster: the shortlist kernel's table and boxes
GROUP = 128  # rays per cull decision: the kernel's threads per block

# Kernel launches by entry point; only the wrapper below adds to it.
launches = {"closest": 0}


def closest_tri_cluster_plain(scene, o, d, cluster: int = CLUSTER, group: int = GROUP):
    """Closest hit by the cluster cull in plain torch -> (t [B] f32, inf on a
    miss; tri_id [B] i64, -1 on a miss).

    The last group is filled with rays at best ``t`` 0, which never make a
    cluster live, as the kernel's threads past the batch do.
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


def closest_tri_cluster(scene, o, d):
    """Closest hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1 on a
    miss)."""
    if o.device.type == "cpu":
        return closest_tri_cluster_plain(scene, o, d)
    check_rays(scene, o, d)
    from pathtracer_tpu_torch import kernels

    table, bounds = kernel_table(scene)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    tri_id = torch.empty(b, dtype=torch.int64, device=o.device)
    if b == 0:
        return t, tri_id
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_cluster_closest(
            o.data_ptr(), d.data_ptr(), table.data_ptr(), bounds.data_ptr(),
            bounds.shape[0] - 1, b, t.data_ptr(), tri_id.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "cluster closest-hit kernel")
    launches["closest"] += 1
    return t, tri_id
