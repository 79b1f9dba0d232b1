// The per-warp walk over 128-row tiles that the tiled and the cluster kernels
// share (csrc/intersect_tiled.cu, csrc/intersect_cluster.cu): one thread per
// ray, no shared memory, no block barrier.
//
// Inputs, for both: o, d [B,3] f32 and t_cut [B] f32, contiguous; table
// [C*128, 16] f32 (ray_triangle.cuh rows, row i for triangle i, in packed
// BVH-leaf order); bounds [C+1, 6] f32, per 128-row tile lo.xyz hi.xyz over
// its valid triangles (lo > hi for a tile without one), the last row the root
// box: the shortlist kernel's table and boxes. Any C >= 1, no cap.
//
// Per warp:
//  1. Root pre-test: a warp none of whose rays enters the root box before its
//     bound (best t, or the cutoff) writes its outputs and does no more.
//  2. Walk, over the tiles in index order: a lane computes its entry to the
//     tile's box and needs the tile only if the entry is within the slack of
//     its bound (improvable, the shortlist kernel's rule); a warp skips a
//     tile no lane needs. A needed tile is swept
//     - dense (at least kDenseLanes lanes need it): every lane tests the 128
//       rows in id order against its own ray, the rows read as broadcasts;
//     - sparse (fewer): the needing rays one at a time, each tested by the
//       whole warp (4 rows a lane), then a warp argmin of (t, id).
//     A lane keeps t < best or (t == best and a smaller id), so the id is the
//     brute sweep's min id whatever order the tiles come in.
//
// Any-hit. A lane's bound is its cutoff, or +inf while hit_any is asked for
// and no triangle was accepted yet; at its first hit below the cutoff the
// lane retires (bound 0, which no entry is below). A lane with cutoff 0 and no
// hit_any to find (a parked lane) tests nothing.
//
// Exactness. Culling only drops tests; it never changes a result as long as
// a tile holding a ray's answer is never skipped. The slab entry and the
// Moller-Trumbore t round differently, so the cull is widened: a tile counts
// as entered when its slab interval is empty by less than kSlack of the entry,
// and is needed when its entry times (1 - kSlack) is within the bound. An
// extra tile costs tests, never a different t or id. hit_triangle and the
// slab are ray_triangle.cuh's, built with -fmad=false: t is bit-equal to the
// brute sweep's in whichever sweep computes it.
//
// Rows. They are read in 16-byte loads through the read-only path, from L1 or
// L2: in a dense sweep every lane reads the same row (a broadcast), in a
// sparse one 32 consecutive rows. Staging them in shared memory measured
// slower (tiled_variants.py, in git at d707472; PERF.md).

#pragma once

#include "ray_triangle.cuh"

namespace {

constexpr int kThreads = 128;                // rays per block = threads per block
constexpr int kMinBlocks = 1024 / kThreads;  // ask ptxas for 32 resident warps
constexpr int kTile = 128;                   // rows per tile
constexpr int kRow4 = kCols / 4;             // float4s per table row
// A tile needed by at least this many lanes of a warp is swept one ray per
// lane; below, one ray at a time by the whole warp (the shortlist kernel's
// threshold: 128 row tests cost the warp about as much as 28 rays' 4 tests
// and argmin).
constexpr int kDenseLanes = 28;
constexpr unsigned kFull = 0xffffffffu;

// Row j of a tile's rows: the 12 floats v0.xyz e1.xyz e2.xyz valid id n.x in
// three 16-byte loads.
__device__ __forceinline__ void load_row(const float4* __restrict__ rows, int j,
                                         float (&row)[12]) {
  const float4 a = __ldg(rows + j * kRow4), b = __ldg(rows + j * kRow4 + 1),
               v = __ldg(rows + j * kRow4 + 2);
  row[0] = a.x, row[1] = a.y, row[2] = a.z, row[3] = a.w;
  row[4] = b.x, row[5] = b.y, row[6] = b.z, row[7] = b.w;
  row[8] = v.x, row[9] = v.y, row[10] = v.z, row[11] = v.w;
}

// Per-lane state: the bound, the closest lane's id, the any-hit lane's flags.
struct Lane {
  float best;   // closest: best t; any-hit: inf, the cutoff, or 0 (retired)
  int best_id;  // closest: the id at best t, -1 while none
  float cut;    // any-hit: the cutoff
  bool occ;     // any-hit: a hit before the cutoff was found
  bool any;     // any-hit: a hit at all was found
};

// Keep (t, id) if it is nearer, or as near with a smaller id: the brute
// sweep's min id among equal t, whatever order the tiles come in.
__device__ __forceinline__ void keep_nearest(float t, int id, Lane& s) {
  if (t < s.best || (t == s.best && id < s.best_id)) {
    s.best = t;
    s.best_id = id;
  }
}

// An any-hit lane's accepted hit; `below` when its t is before the cutoff.
__device__ __forceinline__ void take_hit(bool below, Lane& s) {
  s.any = true;
  s.occ = s.occ || below;
  s.best = below ? 0.0f : s.cut;
}

// Dense sweep: every needing lane tests the tile's rows in id order against
// its own ray; an any-hit lane stops needing the tile once it retires, and
// the warp leaves once none needs it.
template <bool kAnyHit>
__device__ __forceinline__ void sweep_rays(const float4* __restrict__ rows, int base,
                                           const Ray& ray, bool need, Lane& s) {
#pragma unroll 2
  for (int j = 0; j < kTile; ++j) {
    float row[12];
    load_row(rows, j, row);
    float t;
    if (need && hit_triangle(row, ray, t)) {
      if (!kAnyHit) {
        keep_nearest(t, base + j, s);
      } else {
        take_hit(t < s.cut, s);
        need = s.best > 0.0f;
      }
    }
    if (kAnyHit && !__any_sync(kFull, need)) break;
  }
}

// Sparse sweep: the needing lanes' rays one at a time, each tested by the
// whole warp, lane l taking rows l, l + 32, l + 64 and l + 96 in that order.
// Closest: a warp argmin of (t, id) gives the ray's nearest hit with the
// smallest id, which its own lane keeps. Any-hit: two warp votes give whether
// the ray hit anything and anything before its cutoff.
template <bool kAnyHit>
__device__ __forceinline__ void sweep_rows(const float4* __restrict__ rows, int base,
                                           const Ray& ray, unsigned needing, int lane,
                                           Lane& s) {
  while (needing) {
    const int src = __ffs(needing) - 1;
    needing &= needing - 1;
    const Ray q = {__shfl_sync(kFull, ray.ox, src), __shfl_sync(kFull, ray.oy, src),
                   __shfl_sync(kFull, ray.oz, src), __shfl_sync(kFull, ray.dx, src),
                   __shfl_sync(kFull, ray.dy, src), __shfl_sync(kFull, ray.dz, src)};
    const float q_bound = __shfl_sync(kFull, kAnyHit ? s.cut : s.best, src);
    float t_min = INFINITY;
    int id_min = 0;
    // Not unrolled: four rows in flight would take the registers that 32
    // resident warps leave.
#pragma unroll 1
    for (int k = 0; k < kTile / 32; ++k) {
      float row[12];
      load_row(rows, lane + 32 * k, row);
      float t;
      if (hit_triangle(row, q, t) && t < t_min) {
        t_min = t;
        id_min = base + lane + 32 * k;
      }
    }
    if (kAnyHit) {
      const bool hit = __any_sync(kFull, t_min < INFINITY);
      const bool below = __any_sync(kFull, t_min < q_bound);
      if (hit && lane == src) take_hit(below, s);
    } else if (__any_sync(kFull, t_min <= q_bound && t_min < INFINITY)) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFull, t_min, off);
        const int oi = __shfl_xor_sync(kFull, id_min, off);
        if (ot < t_min || (ot == t_min && oi < id_min)) {
          t_min = ot;
          id_min = oi;
        }
      }
      if (lane == src) keep_nearest(t_min, id_min, s);
    }
  }
}

// Visit tile k if some lane needs it, with the sweep its lanes call for.
template <bool kAnyHit>
__device__ __forceinline__ void visit(const float4* __restrict__ table4,
                                      const float* __restrict__ bounds, int k,
                                      const Ray& ray, const float inv[3], bool live,
                                      int lane, Lane& s) {
  const float e = box_enter_widened(bounds + 6 * static_cast<int64_t>(k), ray, inv);
  const bool need = live && improvable<kAnyHit>(e, s.best);
  const unsigned needing = __ballot_sync(kFull, need);
  if (!needing) return;
  const float4* rows = table4 + static_cast<int64_t>(k) * kTile * kRow4;
  if (__popc(needing) >= kDenseLanes)
    sweep_rays<kAnyHit>(rows, k * kTile, ray, need, s);
  else
    sweep_rows<kAnyHit>(rows, k * kTile, ray, needing, lane, s);
}

// One thread's ray of a kernel of kThreads a block: its load, the root
// pre-test, the walk and its outputs (closest: t, tri_id; any-hit: occ, and
// hit_any unless null).
template <bool kAnyHit>
__device__ __forceinline__ void trace_ray(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ t_cut,
                                          const float* __restrict__ table,
                                          const float* __restrict__ bounds, int c, int n,
                                          float* __restrict__ t_out,
                                          int64_t* __restrict__ id_out,
                                          uint8_t* __restrict__ occ_out,
                                          uint8_t* __restrict__ any_out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = r < n;
  const float4* table4 = reinterpret_cast<const float4*>(table);

  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  Lane s = {INFINITY, -1, 0.0f, false, false};
  if (live) {
    ray = load_ray(o, d, r);
    if (kAnyHit) {
      s.cut = t_cut[r];
      s.best = any_out != nullptr ? INFINITY : s.cut;
    }
  }
  const float inv[3] = {inv_dir(ray.dx), inv_dir(ray.dy), inv_dir(ray.dz)};
  const float root = box_enter_widened(bounds + 6 * static_cast<int64_t>(c), ray, inv);

  if (__any_sync(kFull, live && improvable<kAnyHit>(root, s.best))) {
    for (int k = 0; k < c; ++k) visit<kAnyHit>(table4, bounds, k, ray, inv, live, lane, s);
  }

  if (!live) return;
  if (kAnyHit) {
    occ_out[r] = s.occ;
    if (any_out != nullptr) any_out[r] = s.any;
  } else {
    t_out[r] = s.best;
    id_out[r] = s.best_id;
  }
}

// A route's kernel: its own __global__ wrapper of trace_ray (so that ptxas
// and a profile name the route), launched and queried through these two.
using WalkKernel = void (*)(const float* __restrict__, const float* __restrict__,
                            const float* __restrict__, const float* __restrict__,
                            const float* __restrict__, int, int, float* __restrict__,
                            int64_t* __restrict__, uint8_t* __restrict__,
                            uint8_t* __restrict__);

// Launch `kernel` over n rays and c tiles on `stream`; the first CUDA error.
inline int launch_walk(WalkKernel kernel, const float* o, const float* d,
                       const float* t_cut, const float* table, const float* bounds, int c,
                       int n, float* t, int64_t* tri_id, uint8_t* occ, uint8_t* hit_any,
                       void* stream) {
  if (n < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cut, table, bounds, c, n, t, tri_id, occ, hit_any);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
