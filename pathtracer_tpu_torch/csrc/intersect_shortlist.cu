// Shortlist closest-hit and any-hit ray/triangle kernels for Hopper (sm_90a):
// the main path's intersector for scenes of >= 2048 padded triangles.
//
// Replaces the TPU kernel `_kernel` / `_kernel_live` of
// pathtracer_tpu/ops/intersect_shortlist_pallas.py (driven by
// `_shortlist_pallas_raw`, pl.pallas_call at :425; entry points
// `closest_tri_shortlist_pallas` and `occluded_tri_shortlist_pallas`).
//
// Contract (the plain torch twin in ops/intersect_shortlist.py and the brute
// sweep ops/intersect.closest_tri_brute are the oracles):
//   closest:  t [B] f32 of the nearest accepted triangle, inf on a miss, bit
//             for bit the brute sweep's; tri_id [B] i64, the smallest id among
//             equal t, -1 on a miss.
//   occluded: occ [B] u8 = some accepted triangle strictly before t_cut.
// Inputs: o, d [B,3] f32 and t_cut [B] f32, contiguous; table [C*128, 16] f32,
//   rows v0.xyz e1.xyz e2.xyz valid id ... in packed (BVH-leaf) order, 128 rows
//   per cluster; bounds [C+1, 6] f32, per cluster lo.xyz hi.xyz (lo > hi for an
//   empty cluster), the last row the root box over the valid clusters.
//
// It computes what the TPU kernel computes, not the way that kernel does it.
// That kernel keeps a [block, C] entry matrix in VMEM and, round by round,
// sweeps the cluster nearest to the whole block with every ray of the block.
// On this card that matrix set occupancy (3 blocks of 4 warps per SM at 100
// clusters) and a cluster cap, and every ray paid for every round. Here:
//
//  1. Root pre-test (Pallas :169-192): a block none of whose rays reaches the
//     root box before its cutoff writes the miss output and exits.
//  2. Order, once per block of 128 rays: each cluster's key is the least slab
//     entry over the block's rays that enter its box before their cutoff (a
//     warp min, then one shared atomicMin per warp), packed with the cluster
//     index into 64 bits and sorted ascending (bitonic, in shared memory): the
//     nearest cluster first, the smaller index on equal keys.
//  3. Walk, per warp, without further barriers: at each cluster in key order a
//     lane recomputes its own entry from the box (one ~20-flop slab test) and
//     needs the cluster only if that entry is below its own best t (the TPU
//     kernel's exact per-ray cull, Pallas :235-239, applied per ray). A warp
//     skips a cluster no lane needs (__any_sync) and stops at the first key
//     that no live lane's best t admits: every later key, and so every later
//     entry of its lanes, is at least as large. For a cluster it needs:
//     - dense (at least kDenseLanes lanes need it): every lane tests the 128
//       rows in id order against its own ray, the rows read as broadcasts;
//     - sparse (fewer): the needing rays one at a time, each tested by the
//       whole warp (4 rows a lane), then a warp argmin of (t, id).
//     A lane keeps t < best or (t == best and a smaller id), so the id is the
//     brute sweep's min id whatever the visit order; for that, a closest lane
//     also takes clusters it enters exactly at its best t. In any-hit mode a
//     lane retires at its first hit below its cutoff (best t = 0, which no
//     entry is below), and the warp leaves a sweep or the walk when all of its
//     lanes have.
//
// Design. A warp pays for a cluster whenever one of its lanes needs it. Most
// rays need 2-3 of the 100 clusters of the 12,800-triangle stand-in, but the
// 32 rays of a warp, even sorted, need different ones: sweeping every cluster
// one ray per lane left most lanes idle most of the time (PERF.md has the
// times of both designs). The sparse sweep costs the warp 4 tests a lane and
// an argmin per needing lane; the dense one 128 tests, so it stays for
// clusters nearly all lanes need. Shared memory holds only the C keys (8
// bytes each, padded to a power of two): 1 KB at 100 clusters, so registers,
// not shared memory, set the warps per SM; the launch bound asks for at least
// 8 blocks of 4 warps.
// Rows come in 16-byte loads through the read-only path, from L1 or from L2,
// which holds the whole table (0.8 MB at 12,800 triangles): in the dense
// sweep every lane reads the same row (a broadcast), in the sparse sweep 32
// consecutive rows. That was chosen over cp.async staging: the warps of a
// block need different clusters at different times, and a per-warp buffer of
// 128 rows (6-12 KB) would cost the occupancy that a small shared footprint
// buys.
//
// Limit: 8 * next_pow2(C) bytes of keys; kMaxClusters = 16,384 clusters
// (2,097,152 padded triangles, 128 KB of keys). The wrapper
// (ops/intersect_shortlist_kernel.py) refuses scenes above its MAX_CLUSTERS
// by name, and the entries here with an error; a card test holds the two
// limits equal through pt_shortlist_blocks_per_sm.
//
// Exactness. hit_triangle and the slab test are ray_triangle.cuh's, shared
// with the other kernels and built with -fmad=false; the slab keeps the JAX
// formulas and NaN propagation. Both sweeps compute t with the same
// hit_triangle, so t is bit-equal whichever runs.
//
// What bounds it on the card: operations, issued per warp. Per needed (ray,
// cluster), 4 Moller-Trumbore tests a lane (46 flops and an IEEE division
// each) and, on a hit, an argmin of 5 shuffle rounds; per cluster the walk
// visits, a slab test; per block, C slab tests a ray for the keys. The tests
// are the bound's work; the slab tests, the argmins, the lanes idle in dense
// sweeps and the clusters a ray tests though it hits nearer are what the
// kernel does beyond it. The key pass grows with C: about a fifth of the
// time at 100 clusters, about half at 516 (shortlist_variants.py, in git at
// 8f97b9d).

#include "ray_triangle.cuh"

namespace {

constexpr int kThreads = 128;  // rays per block = threads per block
constexpr int kMinBlocks = 8;  // resident blocks per SM asked of ptxas
constexpr int kCluster = 128;  // triangles per cluster
constexpr int kRow4 = kCols / 4;  // float4s per table row
constexpr int kMaxClusters = 16384;
// A cluster needed by at least this many lanes of a warp is swept one ray per
// lane (sweep_rays); below, one ray at a time by the whole warp (sweep_rows):
// 128 row tests cost the warp about as much as 28 rays' 4 tests and argmin.
// shortlist_variants.py (8f97b9d) timed the choice: sparse sweeps alone (33)
// or dense alone (0) are slower on the torus stand-ins, thresholds 24-31 alike.
constexpr int kDenseLanes = 28;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf

__host__ __device__ constexpr int pow2_at_least(int c) {
  int p = 1;
  while (p < c) p <<= 1;
  return p;
}

// A lane at best t `best` needs a box entered at `e`: closest lanes also take
// e == best (a later cluster may hold an equal t at a smaller id); in any-hit
// mode only a hit strictly before the cutoff counts.
template <bool kAnyHit>
__device__ __forceinline__ bool improvable(float e, float best) {
  return kAnyHit ? e < best : (e <= best && e < INFINITY);
}

// Row j of a cluster's rows: the 12 floats v0.xyz e1.xyz e2.xyz valid id
// n.x in three 16-byte loads through the read-only path.
__device__ __forceinline__ void load_row(const float4* __restrict__ rows, int j,
                                         float (&row)[12]) {
  const float4 a = __ldg(rows + j * kRow4);
  const float4 b = __ldg(rows + j * kRow4 + 1);
  const float4 v = __ldg(rows + j * kRow4 + 2);
  row[0] = a.x, row[1] = a.y, row[2] = a.z, row[3] = a.w;
  row[4] = b.x, row[5] = b.y, row[6] = b.z, row[7] = b.w;
  row[8] = v.x, row[9] = v.y, row[10] = v.z, row[11] = v.w;
}

// Keep (t, id) if it is nearer, or as near with a smaller id: the brute
// sweep's min id among equal t, whatever order the clusters come in.
__device__ __forceinline__ void keep_nearest(float t, int id, float& best, int& best_id) {
  if (t < best || (t == best && id < best_id)) {
    best = t;
    best_id = id;
  }
}

// Dense sweep, for a cluster most lanes need: every lane tests the cluster's
// rows in id order against its own ray, the rows read as warp broadcasts; a
// lane that does not need the cluster idles. An any-hit lane retires at its
// first hit below its cutoff, and the warp leaves once all have.
template <bool kAnyHit>
__device__ __forceinline__ void sweep_rays(const float4* __restrict__ rows, int base,
                                           const Ray& ray, bool need, float& best,
                                           int& best_id) {
#pragma unroll 2
  for (int j = 0; j < kCluster; ++j) {
    float row[12];
    load_row(rows, j, row);
    float t;
    if (need && hit_triangle(row, ray, t)) {
      if (!kAnyHit) {
        keep_nearest(t, base + j, best, best_id);
      } else if (t < best) {
        best = 0.0f;
        need = false;
      }
    }
    if (kAnyHit && !__any_sync(kFull, need)) break;
  }
}

// Sparse sweep, for a cluster few lanes need: the needing lanes' rays one at
// a time, each tested by the whole warp, lane l taking rows l, l + 32, l + 64
// and l + 96 in that order; a warp argmin of (t, id) then gives the ray's
// nearest hit with the smallest id, which its own lane keeps.
template <bool kAnyHit>
__device__ __forceinline__ void sweep_rows(const float4* __restrict__ rows, int base,
                                           const Ray& ray, unsigned needing, int lane,
                                           float& best, int& best_id) {
  while (needing) {
    const int src = __ffs(needing) - 1;
    needing &= needing - 1;
    const Ray q = {__shfl_sync(kFull, ray.ox, src), __shfl_sync(kFull, ray.oy, src),
                   __shfl_sync(kFull, ray.oz, src), __shfl_sync(kFull, ray.dx, src),
                   __shfl_sync(kFull, ray.dy, src), __shfl_sync(kFull, ray.dz, src)};
    const float q_best = __shfl_sync(kFull, best, src);
    float t_min = INFINITY;
    int id_min = 0;
    // Not unrolled: four rows in flight would take the registers that 32
    // resident warps leave (ptxas then spills).
#pragma unroll 1
    for (int s = 0; s < kCluster / 32; ++s) {
      float row[12];
      load_row(rows, lane + 32 * s, row);
      float t;
      if (hit_triangle(row, q, t) && t < t_min) {
        t_min = t;
        id_min = base + lane + 32 * s;
      }
    }
    if (kAnyHit) {
      // Retire the ray at a hit below its cutoff.
      if (__any_sync(kFull, t_min < q_best) && lane == src) best = 0.0f;
    } else if (__any_sync(kFull, t_min <= q_best && t_min < INFINITY)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, t_min, off);
        const int oi = __shfl_xor_sync(kFull, id_min, off);
        if (ot < t_min || (ot == t_min && oi < id_min)) {
          t_min = ot;
          id_min = oi;
        }
      }
      if (lane == src) keep_nearest(t_min, id_min, best, best_id);
    }
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shortlist_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_cut,
                     const float* __restrict__ table,
                     const float* __restrict__ bounds, int c, int p, int n,
                     float* __restrict__ t_out, int64_t* __restrict__ id_out,
                     uint8_t* __restrict__ occ_out) {
  // Cluster keys: entry bits << 32 | cluster index; [p], p = next_pow2(c).
  extern __shared__ unsigned long long order[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const bool live = r < n;
  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  float t0 = 0.0f;
  if (live) {
    ray = load_ray(o, d, r);
    t0 = kAnyHit ? t_cut[r] : INFINITY;
  }
  const float inv[3] = {inv_dir(ray.dx), inv_dir(ray.dy), inv_dir(ray.dz)};
  float t_near, t_far;
  slab(bounds + 6 * static_cast<int64_t>(c), ray, inv, t_near, t_far);
  const bool reach = live && t_far >= t_near && t_far > 0.0f &&
                     nan_max(t_near, 0.0f) < t0;
  float best = t0;
  int best_id = -1;

  if (__syncthreads_or(reach)) {
    for (int k = tid; k < p; k += kThreads)
      order[k] = k < c ? (static_cast<unsigned long long>(kInfBits) << 32 | k) : ~0ull;
    __syncthreads();
    // Entries are >= 0 (or -0, masked to +0), and non-negative floats order as
    // their bits; a lane that cannot use the box before its cutoff adds +inf.
    for (int k = 0; k < c; ++k) {
      const float e = box_enter(bounds + 6 * static_cast<int64_t>(k), ray, inv);
      const unsigned bits = live && e < t0 ? __float_as_uint(e) & 0x7fffffffu : kInfBits;
      const unsigned m = __reduce_min_sync(kFull, bits);
      if (lane == 0 && m < kInfBits)
        atomicMin(&order[k], static_cast<unsigned long long>(m) << 32 | k);
    }
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        __syncthreads();
        for (int i = tid; i < p / 2; i += kThreads) {
          const int a = 2 * i - (i & (stride - 1));
          const unsigned long long x = order[a], y = order[a + stride];
          if ((x > y) == ((a & size) == 0)) {
            order[a] = y;
            order[a + stride] = x;
          }
        }
      }
    }
    __syncthreads();

    const float4* table4 = reinterpret_cast<const float4*>(table);
    for (int i = 0; i < c; ++i) {
      const unsigned long long key = order[i];
      const float kmin = __uint_as_float(static_cast<unsigned>(key >> 32));
      if (!(kmin < INFINITY) || !__any_sync(kFull, live && improvable<kAnyHit>(kmin, best)))
        break;
      const int k = static_cast<int>(key & 0xffffffffu);
      const float e = box_enter(bounds + 6 * static_cast<int64_t>(k), ray, inv);
      bool need = live && improvable<kAnyHit>(e, best);
      if (!__any_sync(kFull, need)) continue;

      const float4* rows = table4 + static_cast<int64_t>(k) * kCluster * kRow4;
      const unsigned needing = __ballot_sync(kFull, need);
      if (__popc(needing) >= kDenseLanes)
        sweep_rays<kAnyHit>(rows, k * kCluster, ray, need, best, best_id);
      else
        sweep_rows<kAnyHit>(rows, k * kCluster, ray, needing, lane, best, best_id);
    }
  }

  if (!live) return;
  if (kAnyHit) {
    occ_out[r] = best < t0;
  } else {
    t_out[r] = best;
    id_out[r] = best_id;
  }
}

// Lets the kernel take the keys of c clusters: their bytes of dynamic shared
// memory, or a negative CUDA error (also above kMaxClusters).
template <bool kAnyHit>
int set_smem(int c) {
  if (c < 1 || c > kMaxClusters) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = 8 * pow2_at_least(c);
  const cudaError_t e = cudaFuncSetAttribute(
      shortlist_kernel<kAnyHit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e == cudaSuccess ? smem : -static_cast<int>(e);
}

template <bool kAnyHit>
int launch(const float* o, const float* d, const float* t_cut,
           const float* table, const float* bounds, int c, int n, float* t,
           int64_t* tri_id, uint8_t* occ, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = set_smem<kAnyHit>(c);
  if (smem < 0) return -smem;
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kThreads - 1) / kThreads);
  shortlist_kernel<kAnyHit><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cut, table, bounds, c, smem / 8, n, t, tri_id, occ);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAnyHit>
int blocks_per_sm(int c) {
  const int smem = set_smem<kAnyHit>(c);
  if (smem < 0) return smem;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, shortlist_kernel<kAnyHit>, kThreads, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
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

// Resident blocks per SM of the closest (any_hit 0) or any-hit kernel over c
// clusters, as the runtime computes them from registers and shared memory
// for a launch; negative on a CUDA error, and above the cluster limit.
int pt_shortlist_blocks_per_sm(int c, int any_hit) {
  return any_hit ? blocks_per_sm<true>(c) : blocks_per_sm<false>(c);
}

}  // extern "C"
