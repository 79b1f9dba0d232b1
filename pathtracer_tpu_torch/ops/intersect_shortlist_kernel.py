"""Shortlist closest hit and any-hit for large scenes: the CUDA kernel.

Port of ``pathtracer_tpu/ops/intersect_shortlist_pallas.py``
(``intersector="shortlist_pallas"``, ``auto``'s choice on a CUDA scene of
>= 2048 padded triangles). The kernel (``csrc/intersect_shortlist.cu``) takes
128 rays per block against 128-triangle clusters: a root-box pre-test, one
sorted order of the clusters per block by their least slab entry, then a
walk per warp in that order in which each ray tests a cluster only when it
enters the cluster's box before its own best ``t`` (see the source).

The wrappers take the plain torch twin (``ops.intersect_shortlist`` with its
defaults) for tensors on the CPU and launch the kernel for tensors on a CUDA
device: a CUDA tensor never reaches the twin. ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops import intersect_shortlist as twin
from pathtracer_tpu_torch.ops.intersect_small import check_rays, triangle_rows

CLUSTER = 128  # triangles per cluster = rays per block
_BIG_F = 3.0e38

# The kernel keeps 8 bytes of sort key per cluster, padded to a power of two,
# in shared memory: 128 KB at this limit, 2,097,152 padded triangles. It is
# the kernel's kMaxClusters (csrc/intersect_shortlist.cu); the card test
# test_shortlist_cluster_limit_is_the_kernels holds the two equal.
MAX_CLUSTERS = 16384


# Kernel launches by entry point; only the wrappers below add to it.
launches = {"closest": 0, "occluded": 0}


def check_clusters(c: int) -> None:
    """The kernel's sort keys of ``c`` clusters must fit its limit."""
    if c > MAX_CLUSTERS:
        raise ValueError(
            f"the shortlist kernel takes at most MAX_CLUSTERS = {MAX_CLUSTERS} "
            f"clusters of {CLUSTER} triangles ({MAX_CLUSTERS * CLUSTER} padded "
            f"triangles); this scene has {c}"
        )


def kernel_table(scene):
    """(table [C*128, 16] f32, bounds [C+1, 6] f32), kept in ``scene.cache``.

    Table rows in packed (BVH-leaf) order, with the small kernel's columns:
    v0.xyz e1.xyz e2.xyz valid id n.xyz mat_id pad; rows past the scene's
    triangles have valid = 0. Bounds: per 128-triangle cluster lo.xyz hi.xyz
    over its valid triangles (lo > hi for a cluster with none), then the
    root box over the valid clusters. The tiled and cluster kernels read the
    same table (``pack_scene`` pads to a multiple of 128, so it is
    ``triangle_rows(scene, scene.padded_tris)``); only this kernel has a
    cluster limit, checked by its wrappers.
    """
    cached = scene.cache.get("shortlist_table")
    if cached is not None:
        return cached
    tp = -(-scene.padded_tris // CLUSTER) * CLUSTER
    table = triangle_rows(scene, tp)
    lo, hi = twin.cluster_bounds(scene, CLUSTER)
    ok = (lo[:, 0] <= hi[:, 0])[:, None]
    root = torch.cat([torch.where(ok, lo, _BIG_F).amin(dim=0),
                      torch.where(ok, hi, -_BIG_F).amax(dim=0)])
    bounds = torch.cat([torch.cat([lo, hi], dim=1), root[None]]).contiguous()
    scene.cache["shortlist_table"] = (table, bounds)
    return table, bounds


def closest_tri_shortlist_kernel(scene, o, d):
    """Closest hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1 on a
    miss)."""
    if o.device.type == "cpu":
        return twin.closest_tri_shortlist(scene, o, d)
    check_rays(scene, o, d)
    from pathtracer_tpu_torch import kernels

    table, bounds = kernel_table(scene)
    check_clusters(bounds.shape[0] - 1)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    tri_id = torch.empty(b, dtype=torch.int64, device=o.device)
    if b == 0:
        return t, tri_id
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_shortlist_closest(
            o.data_ptr(), d.data_ptr(), table.data_ptr(), bounds.data_ptr(),
            bounds.shape[0] - 1, b, t.data_ptr(), tri_id.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "shortlist closest-hit kernel")
    launches["closest"] += 1
    return t, tri_id


def occluded_tri_shortlist_kernel(scene, o, d, t_cut):
    """Shadow occlusion -> occluded [B] bool: some triangle strictly before
    ``t_cut``."""
    if o.device.type == "cpu":
        return twin.occluded_tri_shortlist(scene, o, d, t_cut)
    check_rays(scene, o, d, t_cut)
    from pathtracer_tpu_torch import kernels

    table, bounds = kernel_table(scene)
    check_clusters(bounds.shape[0] - 1)
    b = o.shape[0]
    occ = torch.empty(b, dtype=torch.uint8, device=o.device)
    if b == 0:
        return occ.bool()
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_shortlist_occluded(
            o.data_ptr(), d.data_ptr(), t_cut.data_ptr(), table.data_ptr(),
            bounds.data_ptr(), bounds.shape[0] - 1, b, occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "shortlist any-hit kernel")
    launches["occluded"] += 1
    return occ.bool()
