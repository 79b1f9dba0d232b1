// Block-shortlist closest-hit and any-hit ray/triangle kernels for Hopper
// (sm_90a): the main path's intersector for scenes of >= 2048 padded triangles.
//
// Replaces the TPU kernel `_kernel` / `_kernel_live` of
// pathtracer_tpu/ops/intersect_shortlist_pallas.py (driven by
// `_shortlist_pallas_raw`, pl.pallas_call at :425; entry points
// `closest_tri_shortlist_pallas` and `occluded_tri_shortlist_pallas`).
//
// Contract (the plain torch twin in ops/intersect_shortlist.py and the brute
// sweep ops/intersect.closest_tri_brute are the oracles):
//   closest:  t [B] f32 of the nearest accepted triangle, inf on a miss, bit
//             for bit the brute sweep's; tri_id [B] i64, -1 on a miss.
//   occluded: occ [B] u8 = some accepted triangle strictly before t_cut.
// Inputs: o, d [B,3] f32 and t_cut [B] f32, contiguous; table [C*128, 16] f32,
//   rows v0.xyz e1.xyz e2.xyz valid id ... in packed (BVH-leaf) order, 128 rows
//   per cluster; bounds [C+1, 6] f32, per cluster lo.xyz hi.xyz (lo > hi for an
//   empty cluster), the last row the root box over the valid clusters.
//
// Algorithm, per 128 consecutive rays (the pool sorts its lanes by origin cell
// and direction octant, so neighbouring rays are coherent):
//  1. Root pre-test (Pallas :169-192): a block none of whose rays reaches the
//     root box before its cutoff writes the miss output and exits.
//  2. The slab entry distance of every ray to every cluster box stays in shared
//     memory for the whole block (Pallas :210-223).
//  3. Rounds: of the unvisited clusters that some ray can still improve on
//     (enter < that ray's best t), the one with the smallest entry over those
//     rays is chosen, the smallest index on ties as jnp.argmin picks it. It is
//     staged into shared memory and every ray sweeps its 128 triangles in id
//     order with a strict `<`: the min id wins within a cluster, the
//     first-visited cluster across clusters. In any-hit mode a ray whose best
//     t fell below its cutoff is retired with best t = 0 (Pallas :317-324).
//     The block exits when no cluster is improvable.
//
// Design. The TPU kernel keeps a [block, CP] entry matrix in VMEM and takes two
// clusters per round by a vector argmin. Here one 128-thread block owns 128
// rays, one thread per ray. The entry matrix lives in dynamic shared memory,
// ray-major with an odd row stride, so both the per-ray writes and the
// per-cluster reads of the round's key are free of bank conflicts. Threads
// stride over clusters to build the key, then one block argmin (warp shuffles,
// then the 4 warp results) picks the cluster. Its rows (8 KB) come from the
// table in global memory (0.8 MB for 12,800 triangles, L2-resident), and every
// ray reads them as warp broadcasts. One cluster per round: the key costs a
// small part of a sweep.
//
// Limit: 4 * 128 * (C | 1) bytes of entry matrix beside the 8 KB stage and the
// boxes; the wrapper (ops/intersect_shortlist_kernel.py) refuses scenes above
// SHORTLIST_MAX_CLUSTERS and this file checks the device's opt-in limit.
//
// Exactness. The slab test keeps the JAX formulas and NaN propagation
// (nan_max/nan_min: fmaxf and fminf drop a NaN operand, jnp.maximum and
// torch.maximum keep it); hit_triangle is shared with the small kernel.
//
// What bounds it on the card: per ray and swept cluster, 128 x ~40 flops read
// from shared memory. Compute and latency, with occupancy bounded by the entry
// matrix's shared memory (3 blocks per SM at 100 clusters).

#include "ray_triangle.cuh"

namespace {

constexpr int kRays = 128;     // rays per block = threads per block
constexpr int kCluster = 128;  // triangles per cluster
constexpr int kWarps = kRays / 32;

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Dynamic shared memory of a block: the staged cluster rows, the boxes, the
// [128, C|1] entry matrix and the visited flags (mirrored by
// ops/intersect_shortlist_kernel.py smem_bytes).
__host__ __device__ constexpr int smem_bytes(int c) {
  return 4 * kCluster * kCols + align16(4 * 6 * (c + 1)) + 4 * kRays * (c | 1) + c;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kRays)
    shortlist_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_cut,
                     const float* __restrict__ table,
                     const float* __restrict__ bounds, int c, int n,
                     float* __restrict__ t_out, int64_t* __restrict__ id_out,
                     uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // [kCluster * kCols]
  float* box = rows + kCluster * kCols;           // [(c + 1) * 6]
  const int cs = c | 1;                           // odd row stride
  float* enter = box + align16(4 * 6 * (c + 1)) / 4;  // [kRays * cs]
  unsigned char* visited = reinterpret_cast<unsigned char*>(enter + kRays * cs);
  __shared__ float best_s[kRays];
  __shared__ float key_w[kWarps];
  __shared__ int idx_w[kWarps];

  const int tid = threadIdx.x;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRays + tid;
  const bool in_batch = r < n;
  // Threads past the batch start at best t = 0: no cluster is improvable for
  // them and they sweep nothing.
  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  float t0 = 0.0f;
  if (in_batch) {
    ray = load_ray(o, d, r);
    t0 = kAnyHit ? t_cut[r] : INFINITY;
  }

  for (int i = tid; i < 6 * (c + 1); i += kRays) box[i] = bounds[i];
  __syncthreads();

  const float inv[3] = {inv_dir(ray.dx), inv_dir(ray.dy), inv_dir(ray.dz)};
  float t_near, t_far;
  slab(box + 6 * c, ray, inv, t_near, t_far);
  const bool reach = in_batch && t_far >= t_near && t_far > 0.0f &&
                     nan_max(t_near, 0.0f) < t0;
  float best = t0;
  int64_t best_id = -1;
  if (__syncthreads_or(reach)) {
    for (int k = 0; k < c; ++k) enter[tid * cs + k] = box_enter(box + 6 * k, ray, inv);
    for (int k = tid; k < c; k += kRays) visited[k] = 0;
    best_s[tid] = best;
    __syncthreads();

    for (int round = 0; round < c; ++round) {
      // The key of the clusters this thread owns: the smallest entry over the
      // rays that can still improve, the smallest index on ties.
      float kmin = INFINITY;
      int kidx = c;
      for (int k = tid; k < c; k += kRays) {
        if (visited[k]) continue;
        float m = INFINITY;
        for (int j = 0; j < kRays; ++j) {
          const float e = enter[j * cs + k];
          if (e < best_s[j] && e < m) m = e;
        }
        if (m < kmin) {
          kmin = m;
          kidx = k;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_down_sync(0xffffffffu, kmin, off);
        const int oi = __shfl_down_sync(0xffffffffu, kidx, off);
        if (ok < kmin || (ok == kmin && oi < kidx)) {
          kmin = ok;
          kidx = oi;
        }
      }
      if ((tid & 31) == 0) {
        key_w[tid >> 5] = kmin;
        idx_w[tid >> 5] = kidx;
      }
      __syncthreads();
      float key = key_w[0];
      int cidx = idx_w[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        if (key_w[w] < key || (key_w[w] == key && idx_w[w] < cidx)) {
          key = key_w[w];
          cidx = idx_w[w];
        }
      }
      if (!(key < INFINITY)) break;  // the same decision in every thread

      if (tid == 0) visited[cidx] = 1;
      const float4* src = reinterpret_cast<const float4*>(
          table + static_cast<int64_t>(cidx) * kCluster * kCols);
      float4* dst = reinterpret_cast<float4*>(rows);
      for (int i = tid; i < kCluster * kCols / 4; i += kRays) dst[i] = src[i];
      __syncthreads();

      // Every accepted t is > kEps > 0, so a ray at best t <= 0 (retired, past
      // the batch, or a non-positive cutoff) cannot improve: skipping it is
      // exact.
      if (best > 0.0f) {
        const int64_t base = static_cast<int64_t>(cidx) * kCluster;
        for (int k = 0; k < kCluster; ++k) {
          float t;
          if (hit_triangle(rows + k * kCols, ray, t) && t < best) {
            best = t;
            best_id = base + k;
            if (kAnyHit) break;  // below the cutoff: retired just below
          }
        }
      }
      if (kAnyHit && best < t0) best = 0.0f;
      best_s[tid] = best;
      __syncthreads();
    }
  }

  if (!in_batch) return;
  if (kAnyHit) {
    occ_out[r] = best < t0;
  } else {
    t_out[r] = best;
    id_out[r] = best_id;
  }
}

template <bool kAnyHit>
int launch(const float* o, const float* d, const float* t_cut,
           const float* table, const float* bounds, int c, int n, float* t,
           int64_t* tri_id, uint8_t* occ, void* stream) {
  if (c < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(c);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, shortlist_kernel<kAnyHit>);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem + static_cast<int>(fa.sharedSizeBytes) > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(shortlist_kernel<kAnyHit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kRays - 1) / kRays);
  shortlist_kernel<kAnyHit><<<grid, kRays, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cut, table, bounds, c, n, t, tri_id, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error.
int pt_shortlist_closest(const float* o, const float* d, const float* table,
                         const float* bounds, int c, int n, float* t,
                         int64_t* tri_id, void* stream) {
  return launch<false>(o, d, nullptr, table, bounds, c, n, t, tri_id, nullptr, stream);
}

int pt_shortlist_occluded(const float* o, const float* d, const float* t_cut,
                          const float* table, const float* bounds, int c, int n,
                          uint8_t* occ, void* stream) {
  return launch<true>(o, d, t_cut, table, bounds, c, n, nullptr, nullptr, occ, stream);
}

}  // extern "C"
