// Cluster-culled closest-hit and any-hit ray/triangle kernels for Hopper
// (sm_90a): `intersector="cluster"`.
//
// Replaces the TPU kernel built by `_make_kernel` of
// pathtracer_tpu/ops/intersect_cluster.py (run by `_closest_flat`,
// pl.pallas_call at :182; entry point `closest_tri_cluster`).
//
// Contract (the brute sweeps ops/intersect.closest_tri_brute and
// ops/intersect._occluded_tri_brute are the oracles; the plain torch twin
// closest_tri_cluster_plain in ops/intersect_cluster.py, and t < t_cut and
// isfinite(t) of it, are the plain versions):
//   closest:  t [B] f32 of the nearest accepted triangle, inf on a miss, bit
//             for bit the brute sweep's; tri_id [B] i64, the smallest id among
//             equal t, -1 on a miss.
//   occluded: occ [B] u8 = some accepted triangle strictly before t_cut;
//             hit_any [B] u8 (optional) = some triangle accepted at all: the
//             closest entry's t < t_cut and isfinite(t), which the JAX package
//             answers occlusion with on this route.
// Inputs: tile_walk.cuh's (the shortlist kernel's table and 128-triangle
//   boxes, the root box last).
//
// What the TPU kernel does: per block of 1024 rays, a [1024, C] matrix of slab
// entries; a 512-triangle cluster is swept by the whole block if one ray of it
// enters the cluster before its best t, in index order with a strict `<`.
// Those were TPU sizes and costs; this kernel's earlier design kept the block
// vote (128 rays, a barrier and an 8 KB restage of the rows per live cluster),
// and on rays that are not coherent nearly every cluster was live for nearly
// every block. It also compared the unwidened entry with a strict `<`, which
// cannot promise the brute sweep's t: the slab entry and the Moller-Trumbore t
// round differently (tile_walk.cuh, Exactness).
//
// Here each warp runs tile_walk.cuh's walk, the tiled kernel's
// (intersect_tiled.cu) as it is: the root pre-test, a per-ray cull with the
// widened entry, dense or sparse sweeps over the clusters in index order, the
// keep_nearest update (the brute sweep's min id in any visit order) and the
// any-hit retirement. On this card the cluster route and the tiled kernel
// share one walk; this file gives it the route's entry points and launch
// counts. A front-to-back order per warp was measured on the pool-sorted lanes
// this route gets and did not beat index order by more than the spread of
// identical kernels in one call (PERF.md), so both entries keep index order.
//
// Exactness against the JAX kernel: where the unwidened cull would skip a
// cluster holding a ray's answer, this kernel still finds it; the brute sweep
// is the contract (ROADMAP.md records any such lane as a defect of the JAX
// kernel).
//
// What bounds it on the card: operations, issued per warp, as the tiled
// kernel. The pool's sort on this route (ops/wavefront.py, sort_rays_on: by
// origin cell and direction octant) does not group a warp's rays by the
// clusters they need: on sorted lanes the walk measured slower than on the
// same rays unsorted (PERF.md).

#include "tile_walk.cuh"

namespace {

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cluster_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_cut, const float* __restrict__ table,
                   const float* __restrict__ bounds, int c, int n,
                   float* __restrict__ t_out, int64_t* __restrict__ id_out,
                   uint8_t* __restrict__ occ_out, uint8_t* __restrict__ any_out) {
  trace_ray<kAnyHit>(o, d, t_cut, table, bounds, c, n, t_out, id_out, occ_out, any_out);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error.
int pt_cluster_closest(const float* o, const float* d, const float* table, const float* bounds,
                       int c, int n, float* t, int64_t* tri_id, void* stream) {
  return launch_walk(cluster_kernel<false>, o, d, nullptr, table, bounds, c, n, t, tri_id,
                     nullptr, nullptr, stream);
}

// hit_any may be null: then it is neither computed nor written.
int pt_cluster_occluded(const float* o, const float* d, const float* t_cut,
                        const float* table, const float* bounds, int c, int n,
                        uint8_t* occ, uint8_t* hit_any, void* stream) {
  return launch_walk(cluster_kernel<true>, o, d, t_cut, table, bounds, c, n, nullptr, nullptr,
                     occ, hit_any, stream);
}

}  // extern "C"
