"""BVH-guided closest hit (the BVH oracle, ``intersector="bvh"``).

Port of ``pathtracer_tpu/ops/bvh_traverse.py``: every lane of a [B] ray batch
walks the flattened BVH (``Scene.bvh_*``) with its own stack held as data, a
[B, depth + 2] int64 tensor, and one loop iteration pops one node for every
lane still walking. The semantics are the JAX package's, so each lane's
``t`` and id equal its:

- the slab test is inclusive, ``tmax >= max(tmin, 0) - 1e-6``, and a child
  box is culled by its entry distance (0 when the origin is inside) against
  the best ``t`` so far, ``entry <= best_t``;
- ``inv_d = 1 / where(|d| > 1e-12, d, 1e-12)``: a tiny negative component
  becomes +1e12, as in JAX;
- a leaf tests its up to ``max_leaf_size`` contiguous triangles with a
  strict ``<``, so the traversal order picks the winner among equal ``t``
  (brute's smallest id may differ there);
- slot 0 is tested and pushed before slot 1, and the stack pops last in,
  first out.

Triangles go through ``intersect.mt_components``, brute's operation order.
Pushes and pops are gathers and ``scatter_`` (the JAX package's one-hot
select is a TPU workaround). Each iteration keeps only the lanes whose stack
is not empty, which changes no lane's result and keeps the cost in
proportion to the lanes still walking. It is an oracle, not a kernel.
"""

from __future__ import annotations

import torch

# ``inv_d``'s floor on |d|, and the slab test's slack (JAX's values).
_D_FLOOR = 1e-12
_SLAB_EPS = 1e-6


def _slab(o, inv_d, lo, hi):
    """Ray-AABB slab test -> (hit [A], entry distance [A], 0 if inside)."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    entry = torch.clamp(tmin, min=0.0)
    return tmax >= entry - _SLAB_EPS, entry


def closest_tri_bvh_stats(scene, o, d):
    """Closest triangle by the BVH walk -> (t [B], inf on miss; tri_id [B]
    i64, -1 on miss; loop iterations, the worst lane's node pops)."""
    from pathtracer_tpu_torch.ops.intersect import INF, mt_components

    b = o.shape[0]
    dev = o.device
    s_cap = scene.bvh_depth + 2
    out_t = torch.full((b,), INF, dtype=o.dtype, device=dev)
    out_id = torch.full((b,), -1, dtype=torch.int64, device=dev)

    inv_d = 1.0 / torch.where(torch.abs(d) > _D_FLOOR, d, _D_FLOOR)
    lane = torch.arange(b, dtype=torch.int64, device=dev)
    stack = torch.zeros((b, s_cap), dtype=torch.int64, device=dev)  # root = 0
    sp = torch.ones(b, dtype=torch.int64, device=dev)
    best_t, best_id = out_t.clone(), out_id.clone()
    oo, ii = o, inv_d
    iters = 0
    while True:
        # Publish every walking lane's best so far, then keep the lanes
        # whose stack is not empty (the loop's one wait on the device).
        out_t.index_copy_(0, lane, best_t)
        out_id.index_copy_(0, lane, best_id)
        keep = torch.nonzero(sp > 0).squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < lane.numel():
            lane, stack, sp, best_t, best_id, oo, ii = (
                x[keep] for x in (lane, stack, sp, best_t, best_id, oo, ii))
        iters += 1

        sp = sp - 1
        node = torch.gather(stack, 1, sp[:, None])[:, 0]
        dd = d[lane]
        for slot in range(2):
            box_hit, entry = _slab(oo, ii, scene.bvh_lo[node, slot],
                                   scene.bvh_hi[node, slot])
            hit_box = box_hit & (entry <= best_t)
            child = scene.bvh_child[node, slot]
            is_leaf = child < 0

            leaf_act = hit_box & is_leaf
            start = scene.bvh_leaf_start[node, slot]
            count = scene.bvh_leaf_count[node, slot]
            for k in range(scene.max_leaf_size):
                tri_ok = leaf_act & (k < count)
                safe = torch.where(tri_ok, start + k, 0)
                v0, e1, e2 = scene.tri_v0[safe], scene.tri_e1[safe], scene.tri_e2[safe]
                t, ok = mt_components(
                    oo[:, 0], oo[:, 1], oo[:, 2], dd[:, 0], dd[:, 1], dd[:, 2],
                    v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
                    e2[:, 0], e2[:, 1], e2[:, 2], tri_ok,
                )
                better = ok & (t < best_t)
                best_t = torch.where(better, t, best_t)
                best_id = torch.where(better, safe, best_id)

            # Internal child: push it at sp (the slot at sp is free; a lane
            # that does not push rewrites that free slot with what it holds).
            push = hit_box & ~is_leaf
            at = torch.clamp(sp, max=s_cap - 1)[:, None]
            held = torch.gather(stack, 1, at)[:, 0]
            stack = stack.scatter(1, at, torch.where(push, child, held)[:, None])
            sp = sp + push.to(torch.int64)
    return out_t, out_id, iters


def closest_tri_bvh(scene, o, d):
    """Closest triangle by the BVH walk -> (t [B], inf on miss; tri_id [B]
    i64, -1 on miss)."""
    t, tri_id, _ = closest_tri_bvh_stats(scene, o, d)
    return t, tri_id
