"""Block-shortlist closest hit for large scenes: the plain torch twin.

Port of ``pathtracer_tpu/ops/intersect_shortlist.py`` (``intersector=
"shortlist"``), and the plain version of the CUDA shortlist kernel
(``ops.intersect_shortlist_kernel``).

Algorithm (exact: ``t`` is bit-equal to ``intersect.closest_tri_brute``):

1. Triangles sit in packed (BVH-leaf) order, so consecutive ``cluster``-sized
   runs are spatially tight; each run gets the AABB of its valid triangles.
2. Every ray slab-tests every cluster box; only the minimum entry distance
   over each ``block`` of rays is kept, [NB, C].
3. Rounds: each block takes the ``k`` nearest unvisited clusters whose
   block-min entry lies before the block's largest best ``t`` (``before``;
   a cull that is exact: a block-min entry too late for the block's
   largest best ``t`` is too late for every ray of the block; the entry and
   the comparison are widened by ``SLACK``, as every cull of the port is,
   so that a cluster holding a hit that the slab test rounds away at a flat
   box's edge is still swept), sweeps their triangles in 128-wide tiles with
   the Moller-Trumbore of ``ops.intersect`` (so ``t`` rounds as the brute
   sweep's), keeps the min id within a tile, and improves each ray's best
   by a strict ``<``: across tiles the first-visited triangle wins ties.
4. The loop ends when no block has an improvable cluster left: one host
   check per round.

The JAX version's ``zero`` tricks, which keep ``shard_map`` carry types, have
no counterpart here. Padding rays start at best ``t`` 0, so they never hold a
cluster in a block's cull.
"""

from __future__ import annotations

import torch

EPS_TRI = 1e-8
INF = float("inf")
_BIG_F = 3.0e38
_BIG_ID = 1.0e9  # > any triangle id; ids are exact in f32 (< 2^24)
# The widening of every box cull of the port (kSlack in csrc/ray_triangle.cuh):
# the slab entry and the Moller-Trumbore t round differently, so a cull that
# compared them exactly could drop a box that holds an accepted hit.
SLACK = 1.0 / 4096

BLOCK = 256  # rays per shortlist decision
CLUSTER = 32  # triangles per cluster (gather and cull granularity)
K = 16  # clusters gathered per block per round

_COMPS = 11  # v0.xyz e1.xyz e2.xyz id valid
# Rays per chunk of the entry-distance pass, so [chunk, C] stays bounded.
_ENTER_CHUNK = 1 << 15


def cluster_bounds(scene, cluster: int):
    """(lo [C, 3], hi [C, 3]) of each ``cluster``-triangle run of valid
    triangles; a cluster without one gets lo = 3e38 > hi = -3e38."""
    t = scene.tri_v0.shape[0]
    tp = -(-t // cluster) * cluster
    v0, e1, e2 = (_pad(x, tp) for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    valid = _pad(scene.tri_valid, tp)
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)  # [tp, 3, 3]
    m = valid[:, None, None]
    c = tp // cluster
    lo = torch.where(m, pts, _BIG_F).reshape(c, cluster * 3, 3).amin(dim=1)
    hi = torch.where(m, pts, -_BIG_F).reshape(c, cluster * 3, 3).amax(dim=1)
    return lo, hi


def _pad(a, rows: int):
    if rows == a.shape[0]:
        return a
    pad = torch.zeros((rows - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad], dim=0)


def _cluster_table(scene, cluster: int):
    """(table [C, 11, cluster], lo [C, 3], hi [C, 3]), kept in ``scene.cache``.

    Component-major within a cluster (v0.xyz e1.xyz e2.xyz id valid), so a
    gathered cluster's component is one contiguous row. Padding triangles
    have valid = 0.
    """
    key = ("shortlist_twin", cluster)
    cached = scene.cache.get(key)
    if cached is not None:
        return cached
    t = scene.tri_v0.shape[0]
    tp = -(-t // cluster) * cluster
    c = tp // cluster
    v0, e1, e2 = (_pad(x, tp) for x in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
    valid = _pad(scene.tri_valid, tp)
    ids = torch.arange(tp, dtype=torch.float32, device=v0.device)
    cols = [v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
            e2[:, 0], e2[:, 1], e2[:, 2], ids, valid.to(torch.float32)]
    table = torch.stack([x.reshape(c, cluster) for x in cols], dim=1)
    lo, hi = cluster_bounds(scene, cluster)
    scene.cache[key] = (table.contiguous(), lo, hi)
    return scene.cache[key]


def _inv(w):
    mag = torch.clamp(torch.abs(w), min=1e-12)
    return torch.where(w >= 0.0, 1.0, -1.0) / mag


def enter_dists(o, d, lo, hi):
    """Slab entry distance of every ray to every box -> [B, C], as every cull
    of the port takes it (the kernels' ``box_enter_widened``): ``max(t_near,
    0)`` where the slab interval is empty by less than ``SLACK`` of that
    entry and ``t_far > 0``; +inf on a miss or an empty box (lo > hi). The
    JAX package's NaN-safe reciprocal; its exact test (``t_far >= t_near``)
    drops rays that meet a flat box at its edge."""
    t_near = torch.full((o.shape[0], lo.shape[0]), -_BIG_F, device=o.device)
    t_far = torch.full((o.shape[0], lo.shape[0]), _BIG_F, device=o.device)
    for ax in range(3):
        i = _inv(d[:, ax : ax + 1])  # [B, 1]
        t0 = (lo[None, :, ax] - o[:, ax : ax + 1]) * i
        t1 = (hi[None, :, ax] - o[:, ax : ax + 1]) * i
        t_near = torch.maximum(t_near, torch.minimum(t0, t1))
        t_far = torch.minimum(t_far, torch.maximum(t0, t1))
    e = torch.clamp(t_near, min=0.0)
    ok = (t_far >= e * (1.0 - SLACK)) & (t_far > 0.0) & (lo[None, :, 0] <= hi[None, :, 0])
    return torch.where(ok, e, INF)


def before(e, t):
    """Whether a box entered at ``e`` (``enter_dists``) may hold a hit
    strictly before ``t``: the kernels' ``improvable``, widened by
    ``SLACK``."""
    return e * (1.0 - SLACK) < t


def closest_tri_shortlist(scene, o, d, t_init=None, block: int = BLOCK,
                          k: int = K, cluster: int = CLUSTER,
                          max_rounds: int | None = None, any_hit: bool = False):
    """Closest triangle hit -> (t [B] f32, inf on a miss; tri_id [B] i64, -1
    on a miss). ``t`` is bit-equal to ``intersect.closest_tri_brute``.

    ``t_init`` ([B] f32) caps the search: only hits strictly before it are
    found, and lanes without one return ``t_init``. ``any_hit`` (the
    occlusion wrapper only) retires a lane at its first hit before
    ``t_init`` by setting its ``t`` to 0: then ``t`` and ``tri_id`` are no
    hit record, only ``t < t_init`` means something.
    """
    t, tri_id, _ = closest_tri_shortlist_stats(
        scene, o, d, t_init=t_init, block=block, k=k, cluster=cluster,
        max_rounds=max_rounds, any_hit=any_hit)
    return t, tri_id


def closest_tri_shortlist_stats(scene, o, d, t_init=None, block: int = BLOCK,
                                k: int = K, cluster: int = CLUSTER,
                                max_rounds: int | None = None,
                                any_hit: bool = False):
    """``closest_tri_shortlist`` plus the number of rounds it ran."""
    dev = o.device
    b = o.shape[0]
    bp = -(-b // block) * block
    best_t0 = (torch.full((b,), INF, device=dev) if t_init is None
               else t_init.to(torch.float32))
    if bp != b:
        pad = bp - b
        o = torch.cat([o, torch.full((pad, 3), 1e30, device=dev)])
        d = torch.cat([d, torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(pad, 3)])
        best_t0 = torch.cat([best_t0, torch.zeros(pad, device=dev)])
    nb = bp // block
    best_t0 = best_t0.reshape(nb, block)

    table, lo, hi = _cluster_table(scene, cluster)
    c = lo.shape[0]
    kc = min(k, c)
    if max_rounds is None:
        max_rounds = -(-c // kc)  # exactness backstop: every cluster visitable

    # Block-min entry [NB, C]; the [B, C] matrix exists one chunk at a time.
    chunk = max(block, _ENTER_CHUNK // block * block)
    min_enter = torch.cat([
        enter_dists(o[s : s + chunk], d[s : s + chunk], lo, hi)
        .reshape(-1, block, c).amin(dim=1)
        for s in range(0, bp, chunk)
    ])

    def improvable_key(best_t, visited):
        cull = visited[:, :c] | ~before(min_enter, best_t.amax(dim=1, keepdim=True))
        return torch.where(cull, INF, min_enter)

    rx, ry, rz = (o[:, j].reshape(nb, block, 1) for j in range(3))
    wx, wy, wz = (d[:, j].reshape(nb, block, 1) for j in range(3))
    # Column c of ``visited`` and row c of ``table_pad`` (valid = 0) back the
    # unpicked slots of the top k.
    visited = torch.zeros((nb, c + 1), dtype=torch.bool, device=dev)
    table_pad = torch.cat([table, torch.zeros_like(table[:1])])
    sweep_w = 128 if (kc * cluster) % 128 == 0 else cluster
    n_sweep = kc * cluster // sweep_w

    from pathtracer_tpu_torch.ops.intersect import mt_components

    best_t = best_t0
    best_id = torch.full((nb, block), -1, dtype=torch.int64, device=dev)
    key = improvable_key(best_t, visited)
    rounds = 0
    while rounds < max_rounds and bool(torch.isfinite(key).any()):
        # The kc nearest improvable clusters of each block. A stable sort
        # keeps jax.lax.top_k's order among equal keys (lower index first),
        # which torch.topk leaves open.
        vals, idx = torch.sort(key, dim=1, stable=True)
        vals, idx = vals[:, :kc], idx[:, :kc]
        idx = torch.where(torch.isfinite(vals), idx, c)
        visited.scatter_(1, idx, True)

        g = table_pad[idx].transpose(1, 2).reshape(nb, _COMPS, kc * cluster)
        for s in range(n_sweep):
            def comp(j):
                return g[:, j, s * sweep_w : (s + 1) * sweep_w][:, None, :]

            t, _ = mt_components(
                rx, ry, rz, wx, wy, wz,
                comp(0), comp(1), comp(2), comp(3), comp(4), comp(5),
                comp(6), comp(7), comp(8), comp(10) > 0.5,
            )
            tile_t = t.amin(dim=2)  # [NB, block]
            tile_id = torch.where(t == tile_t[:, :, None], comp(9), _BIG_ID).amin(dim=2)
            better = tile_t < best_t
            best_t = torch.where(better, tile_t, best_t)
            best_id = torch.where(better, tile_id.to(torch.int64), best_id)

        if any_hit:
            best_t = torch.where(best_t < best_t0, 0.0, best_t)
        key = improvable_key(best_t, visited)
        rounds += 1

    t_out = best_t.reshape(bp)[:b]
    id_out = best_id.reshape(bp)[:b]
    return t_out, torch.where(torch.isfinite(t_out), id_out, -1), rounds


def occluded_tri_shortlist(scene, o, d, t_cut, block: int = BLOCK, k: int = K,
                           cluster: int = CLUSTER):
    """Shadow occlusion -> occluded [B] bool: some triangle strictly before
    ``t_cut``. The loop starts at best ``t`` = ``t_cut`` in any-hit mode, so
    clusters beyond the cutoff are never swept and a lane retires at its
    first occluder."""
    t, _ = closest_tri_shortlist(scene, o, d, t_init=t_cut, block=block, k=k,
                                 cluster=cluster, any_hit=True)
    return t < t_cut
