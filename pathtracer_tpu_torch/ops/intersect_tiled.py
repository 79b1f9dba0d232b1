"""Tiled closest hit and any-hit: the CUDA kernel.

Port of ``pathtracer_tpu/ops/intersect_pallas.py`` (``closest_tri_pallas``;
the settings name ``intersector="pallas"`` is kept for parity with the JAX
package). The kernel (``csrc/intersect_tiled.cu``) reads the shortlist
kernel's table in 128-row tiles with their boxes: each ray tests a tile only
when it enters the tile's box before its own best ``t`` (or cutoff), so the
result is the brute sweep's, nearest ``t`` with the smallest id among equal
``t``, on scenes of any size. The any-hit entry answers "some triangle
before the per-ray cutoff" and, when asked, "some triangle at all": exactly
``t < t_cut`` and ``isfinite(t)`` of the closest entry.

Their plain versions are the brute sweeps ``intersect.closest_tri_brute`` and
``intersect._occluded_tri_brute``, which compute the same functions. The
wrappers take them for tensors on the CPU and launch the kernel for tensors
on a CUDA device: a CUDA tensor never reaches a plain version. ``launches``
counts the kernel launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.intersect_shortlist_kernel import kernel_table
from pathtracer_tpu_torch.ops.intersect_small import check_rays

# Kernel launches by entry point; only the wrappers below add to it.
launches = {"closest": 0, "occluded": 0}


def closest_tri_tiled(scene, o, d):
    """Closest hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1 on a
    miss)."""
    if o.device.type == "cpu":
        from pathtracer_tpu_torch.ops.intersect import closest_tri_brute

        return closest_tri_brute(scene, o, d)
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
        rc = lib.pt_tiled_closest(
            o.data_ptr(), d.data_ptr(), table.data_ptr(), bounds.data_ptr(),
            bounds.shape[0] - 1, b, t.data_ptr(), tri_id.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "tiled closest-hit kernel")
    launches["closest"] += 1
    return t, tri_id


def occluded_tri_tiled(scene, o, d, t_cut, want_any: bool = False):
    """Shadow occlusion -> (occluded [B] bool: some triangle strictly before
    ``t_cut``; hit_any [B] bool: some triangle at all, when ``want_any``,
    else None)."""
    if o.device.type == "cpu":
        from pathtracer_tpu_torch.ops.intersect import _occluded_tri_brute

        occ, hit_any = _occluded_tri_brute(scene, o, d, t_cut)
        return occ, (hit_any if want_any else None)
    check_rays(scene, o, d, t_cut)
    from pathtracer_tpu_torch import kernels

    table, bounds = kernel_table(scene)
    b = o.shape[0]
    occ = torch.empty(b, dtype=torch.uint8, device=o.device)
    hit_any = torch.empty(b, dtype=torch.uint8, device=o.device) if want_any else None
    if b == 0:
        return occ.bool(), (hit_any.bool() if want_any else None)
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_tiled_occluded(
            o.data_ptr(), d.data_ptr(), t_cut.data_ptr(), table.data_ptr(),
            bounds.data_ptr(), bounds.shape[0] - 1, b, occ.data_ptr(),
            hit_any.data_ptr() if want_any else None,
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "tiled any-hit kernel")
    launches["occluded"] += 1
    return occ.bool(), (hit_any.bool() if want_any else None)
