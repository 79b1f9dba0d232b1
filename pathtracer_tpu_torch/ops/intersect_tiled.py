"""Tiled brute closest hit: the CUDA kernel.

Port of ``pathtracer_tpu/ops/intersect_pallas.py`` (``closest_tri_pallas``;
the settings name ``intersector="pallas"`` is kept for parity with the JAX
package). The kernel (``csrc/intersect_tiled.cu``) sweeps every triangle for
each ray, streaming the triangle table through shared memory in 128-row
tiles, and keeps the nearest hit with the smallest id among equal ``t``. It
holds no more than a tile, so it takes scenes of any size.

Its plain version is the brute sweep ``intersect.closest_tri_brute``, which
computes the same function. The wrapper takes it for tensors on the CPU and
launches the kernel for tensors on a CUDA device: a CUDA tensor never reaches
the plain version. ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.intersect_shortlist_kernel import kernel_table
from pathtracer_tpu_torch.ops.intersect_small import check_rays

# Kernel launches by entry point; only the wrapper below adds to it.
launches = {"closest": 0}


def closest_tri_tiled(scene, o, d):
    """Closest hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1 on a
    miss)."""
    if o.device.type == "cpu":
        from pathtracer_tpu_torch.ops.intersect import closest_tri_brute

        return closest_tri_brute(scene, o, d)
    check_rays(scene, o, d)
    from pathtracer_tpu_torch import kernels

    table, _ = kernel_table(scene)
    b = o.shape[0]
    t = torch.empty(b, dtype=torch.float32, device=o.device)
    tri_id = torch.empty(b, dtype=torch.int64, device=o.device)
    if b == 0:
        return t, tri_id
    lib = kernels.library()
    with torch.cuda.device(o.device):
        rc = lib.pt_tiled_closest(
            o.data_ptr(), d.data_ptr(), table.data_ptr(), table.shape[0], b,
            t.data_ptr(), tri_id.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(rc, "tiled closest-hit kernel")
    launches["closest"] += 1
    return t, tri_id
