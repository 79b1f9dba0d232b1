// Cluster-culled closest-hit ray/triangle kernel for Hopper (sm_90a):
// `intersector="cluster"`.
//
// Replaces the TPU kernel built by `_make_kernel` of
// pathtracer_tpu/ops/intersect_cluster.py (run by `_closest_flat`,
// pl.pallas_call at :182; entry point `closest_tri_cluster`).
//
// Contract (the plain torch twin closest_tri_cluster_plain in
// ops/intersect_cluster.py and the brute sweep ops/intersect.closest_tri_brute
// are the oracles):
//   t [B] f32 of the nearest accepted triangle, inf on a miss, bit for bit the
//   brute sweep's; tri_id [B] i64, -1 on a miss.
// Inputs: o, d [B,3] f32 contiguous; table [C*128, 16] f32 (ray_triangle.cuh
//   rows in packed, BVH-leaf, order); bounds [C(+1), 6] f32, per 128-triangle
//   cluster lo.xyz hi.xyz (lo = 3e38 > hi = -3e38 for a cluster without a valid
//   triangle), the shortlist kernel's table and boxes.
//
// Algorithm (the TPU kernel's, per group of 128 consecutive rays; the pool
// sorts its lanes by origin cell and direction octant for this route): the
// clusters are visited in index order; a cluster is swept only if some ray of
// the group enters its box before that ray's best t (intersect_cluster.py:
// 110-116), and then every ray of the group sweeps its 128 triangles in id
// order with a strict `<`, so the min id wins within a cluster and the earlier
// cluster across clusters, as in the TPU kernel. The slab math is JAX's
// (:82-105): the sign-preserving 1/max(|w|, 1e-12), enter = max(t_near, 0),
// box_hit = t_far >= t_near & t_far > 0 & lo <= hi, bounds clamped to +-3e38.
//
// Design. One 128-thread block owns 128 rays, one thread per ray. The TPU
// kernel keeps a resident [1024, C] entry matrix; here each thread computes
// its entry to cluster k when the loop reaches k (the box is one broadcast
// load), so nothing grows with C and there is no cluster cap. A block vote
// (__syncthreads_or) on "enter < best t" replaces jnp.any; the vote is also
// the barrier that lets the block restage: a live cluster's rows (8 KB) are
// copied into shared memory and read as warp broadcasts. Threads past the
// batch hold best t = 0, so they vote "not live" and sweep nothing; 512-
// triangle clusters of four lane-width subtiles were TPU sizes and are not
// kept.
//
// Exactness. hit_triangle and the slab test are ray_triangle.cuh's, shared
// with the other kernels and built with -fmad=false. The slab starts from
// -+3e38 where JAX takes the max and min of the three axes alone; the two
// differ only where every axis gives a value beyond 3e38, where both cull
// the same way.
//
// What bounds it on the card: per ray and live cluster, 128 x ~40 flops from
// shared memory; per ray and cluster a ~20-flop slab test and one block
// barrier. Compute and latency; the cull's strength depends on how coherent
// the 128 rays of a block are.

#include "ray_triangle.cuh"

namespace {

constexpr int kRays = 128;     // rays per block = threads per block
constexpr int kCluster = 128;  // triangles per cluster
constexpr int kCluster4 = kCluster * kCols / 4;  // float4s per cluster
static_assert(kCluster4 % kRays == 0, "a cluster must split evenly over the block");

__global__ void __launch_bounds__(kRays)
    cluster_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                           const float* __restrict__ table,
                           const float* __restrict__ bounds, int c, int n,
                           float* __restrict__ t_out, int64_t* __restrict__ id_out) {
  __shared__ float4 rows4[kCluster4];
  const int tid = threadIdx.x;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRays + tid;
  const bool in_batch = r < n;
  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  float best = 0.0f;
  if (in_batch) {
    ray = load_ray(o, d, r);
    best = INFINITY;
  }
  const float inv[3] = {inv_dir(ray.dx), inv_dir(ray.dy), inv_dir(ray.dz)};
  int64_t best_id = -1;

  for (int k = 0; k < c; ++k) {
    const float enter = box_enter(bounds + 6 * static_cast<int64_t>(k), ray, inv);
    // Every thread has swept the previous live cluster before any passes the
    // vote, so the block may overwrite the staged rows after it.
    if (!__syncthreads_or(enter < best)) continue;
    const float4* src =
        reinterpret_cast<const float4*>(table) + static_cast<int64_t>(k) * kCluster4;
    for (int i = tid; i < kCluster4; i += kRays) rows4[i] = src[i];
    __syncthreads();
    // Every accepted t is > kEps > 0: a thread at best t 0 (past the batch)
    // cannot improve, so skipping it is exact.
    if (best > 0.0f) {
      const float* rows = reinterpret_cast<const float*>(rows4);
      const int64_t base = static_cast<int64_t>(k) * kCluster;
      for (int i = 0; i < kCluster; ++i) {
        float t;
        if (hit_triangle(rows + i * kCols, ray, t) && t < best) {
          best = t;
          best_id = base + i;
        }
      }
    }
  }
  if (!in_batch) return;
  t_out[r] = best;
  id_out[r] = best_id;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the first CUDA error.
int pt_cluster_closest(const float* o, const float* d, const float* table,
                       const float* bounds, int c, int n, float* t,
                       int64_t* tri_id, void* stream) {
  if (c < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kRays - 1) / kRays);
  cluster_closest_kernel<<<grid, kRays, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, table, bounds, c, n, t, tri_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
