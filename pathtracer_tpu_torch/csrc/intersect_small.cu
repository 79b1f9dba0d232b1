// Small-scene closest-hit and any-hit ray/triangle kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of pathtracer_tpu/ops/intersect_small_pallas.py
// (driven by `_small_pallas_raw`, pl.pallas_call at :176; entry points
// `closest_tri_small_pallas_attrs` and `occluded_tri_small_pallas`). It serves
// scenes of at most 256 triangles, 8-rounded, e.g. every Cornell-box scene.
//
// Contract (the plain torch versions in ops/intersect_small.py are the oracle):
//   closest:  t [B] f32, tri_id [B] i32, n_geo [B,3] f32, mat_id [B] i32 of the
//             nearest accepted triangle, smallest id among equal t;
//             a miss gives inf, -1, 0, 0.
//   occluded: occ [B] u8 = some accepted t < t_cut; hit_any [B] u8 (optional)
//             = some triangle accepted at all.
// Inputs: o, d [B,3] and t_cut [B] f32, contiguous; the scene's valid
//   triangles as R <= 256 rows in increasing id order (small_rows in
//   ops/intersect_small.py): on the device, table [R,16] f32 (v0.xyz e1.xyz
//   e2.xyz valid id n.xyz mat_id pad); on the host, the same rows and the root
//   box lo.xyz hi.xyz over their vertices.
//
// It computes what the TPU kernel computes (every ray against every triangle,
// a running (t, id) minimum and the winner's attributes), not the way that
// kernel does it. Three costs of a one-thread-per-ray sweep are cut:
//
//  1. Lanes with nothing to test. The path tracer parks its dead lanes (origin
//     1e6, direction +x: a sure miss), about a quarter of a Cornell render's
//     lanes, and gives inactive shadow rays a cutoff of 0. A lane sweeps only
//     if its ray enters the root box before its bound (+inf for closest hits
//     and for any-hit lanes that want hit_any, else the cutoff), by the tiled
//     kernel's widened box test, and, any-hit without hit_any, only if its
//     cutoff is above kEps (an accepted t is > kEps). Any other lane writes its
//     miss at once.
//  2. Lanes scattered among them. Each block takes kThreads consecutive rays,
//     lists the ones that need a sweep (a ballot and a prefix over the warps)
//     and hands them out in order, one per thread: its warps sweep full of
//     live rays, and the rest of them idle.
//  3. Rows that cannot accept. Only the scene's valid triangles are rows (the
//     Cornell box's 36, not its 40 8-rounded ones), so the valid test folds
//     away; a row's id is read only for the winner, from its table row.
//
// Rows as uniform operands. Every lane of a warp reads row k in step k, so the
// rows (v0.xyz e1.xyz e2.xyz, kRowFloats apart) travel in the launch's own
// parameters, a __grid_constant__ struct (10 KB; kernel parameters may hold
// 32 KB since CUDA 12.1): they sit in the constant bank and reach the warp as
// constant-cache loads (LDC), with no staging and no shared memory for them.
// A launch copies the host's rows into its parameters, so each launch carries
// its own scene's rows: two launches, on one stream or on two, cannot read
// each other's.
//
// Filling the card. ptxas is asked for 64 resident warps (32 registers, no
// spills), so 262,144 rays are 512 blocks in one wave. The grid is at most the
// blocks the card holds at once (the runtime's resident blocks per SM, times
// the SMs), each block taking an equal share of the rays in chunks of
// kThreads: no partial second wave if ptxas ever gives it more registers.
//
// Measured on the Cornell box, closest / any-hit (small_variants.py, in git
// at a09008f, on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6):
// rows staged in shared memory take 7-9% longer, rows read through L1/L2
// 35-36%; without the skip 31-43%, with the skip per lane but no list
// 14-25%; all 8-rounded rows 12%. 256 or 1024 threads a block take 1-6%
// longer (256: 15% on the 250-triangle soup's closest); freeing the registers
// (32 warps) 3-15%; unrolling the row loop spills and moves the time per
// render by less than 1%.
//
// Exactness. The skips only drop tests that cannot accept: the widened box
// test counts a box as entered whenever Moller-Trumbore could accept a hit in
// it. `hit_triangle` (ray_triangle.cuh) rounds operation by operation in the
// order of the JAX kernel (intersect_small_pallas.py:91-108) and of the torch
// version, built with -fmad=false: t agrees bit for bit; the strict < over
// rows in increasing id keeps the smallest id among equal t.
//
// What bounds it on the card: instructions issued per warp. A test is 76 of
// them on the closest entry's fast path (cuobjdump -sass): the 46 flops of
// hit_triangle without FMA, the IEEE reciprocal's refinement and range check,
// 8 compares, 5 constant-bank loads of the row and the loop; per ray, the slab
// test, the list and the stores (the "no sweep" variant: about 0.006 ms of
// the Cornell box's 0.026 ms on the same card).

#include <string.h>

#include "ray_triangle.cuh"

namespace {

constexpr int kThreads = 512;                // rays per chunk = threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2048 / kThreads;  // ask ptxas for 64 resident warps
constexpr int kMaxRows = 256;                // SMALL_MAX_T8
constexpr int kRowFloats = 10;               // v0.xyz e1.xyz e2.xyz and a pad
constexpr float kSlack = 1.0f / 4096;        // the tiled kernel's widening
constexpr unsigned kFull = 0xffffffffu;

// What every lane reads alike, carried in the launch's parameters.
struct Uniform {
  float box[6];  // root box lo.xyz hi.xyz over the rows; lo > hi when none
  int count;     // rows
  float rows[kMaxRows * kRowFloats];
};

// Row k as hit_triangle reads it: every row is a valid triangle.
__device__ __forceinline__ void row_at(const float* __restrict__ rows, int k,
                                       float (&row)[10]) {
#pragma unroll
  for (int j = 0; j < 9; ++j) row[j] = rows[k * kRowFloats + j];
  row[9] = 1.0f;
}

// Whether a lane has anything to test (design, point 1).
template <bool kAnyHit>
__device__ __forceinline__ bool needs_sweep(const float* box, const Ray& ray, float cut,
                                            bool want_any) {
  if (kAnyHit && !want_any && !(cut > kEps)) return false;
  const float inv[3] = {inv_dir(ray.dx), inv_dir(ray.dy), inv_dir(ray.dz)};
  const float e = box_enter_widened(box, ray, inv, kSlack);
  return improvable<kAnyHit>(e, kAnyHit && !want_any ? cut : INFINITY, kSlack);
}

// Closest result of ray r: the winner `best` (a row, -1 for a miss) at best_t.
__device__ __forceinline__ void write_closest(const float* __restrict__ table, int best,
                                              float best_t, int64_t r,
                                              float* __restrict__ t_out,
                                              int* __restrict__ id_out,
                                              float* __restrict__ n_out,
                                              int* __restrict__ mat_out) {
  t_out[r] = best_t;
  if (best >= 0) {
    const float* w = table + static_cast<int64_t>(best) * kCols;
    id_out[r] = static_cast<int>(w[10]);
    n_out[3 * r + 0] = w[11];
    n_out[3 * r + 1] = w[12];
    n_out[3 * r + 2] = w[13];
    mat_out[r] = static_cast<int>(w[14]);
  } else {
    id_out[r] = -1;
    n_out[3 * r + 0] = 0.0f;
    n_out[3 * r + 1] = 0.0f;
    n_out[3 * r + 2] = 0.0f;
    mat_out[r] = 0;
  }
}

// Every row against one ray, in increasing id: closest keeps the first of the
// nearest (strict <); any-hit stops at the first hit before the cutoff.
template <bool kAnyHit>
__device__ __forceinline__ void sweep(const float* __restrict__ rows, int count,
                                      const float* __restrict__ table, const Ray& ray,
                                      float cut, int64_t r, float* __restrict__ t_out,
                                      int* __restrict__ id_out, float* __restrict__ n_out,
                                      int* __restrict__ mat_out, uint8_t* __restrict__ occ_out,
                                      uint8_t* __restrict__ any_out) {
  float best_t = INFINITY;
  int best = -1;
  bool occ = false, any = false;
  for (int k = 0; k < count; ++k) {
    float row[10];
    row_at(rows, k, row);
    float t;
    if (!hit_triangle(row, ray, t)) continue;
    if (kAnyHit) {
      any = true;
      if (t < cut) {
        occ = true;
        break;
      }
    } else if (t < best_t) {
      best_t = t;
      best = k;
    }
  }
  if (kAnyHit) {
    occ_out[r] = occ;
    if (any_out != nullptr) any_out[r] = any;
  } else {
    write_closest(table, best, best_t, r, t_out, id_out, n_out, mat_out);
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    small_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_cut, const float* __restrict__ table,
                 const __grid_constant__ Uniform u, int n, int per_block,
                 float* __restrict__ t_out, int* __restrict__ id_out,
                 float* __restrict__ n_out, int* __restrict__ mat_out,
                 uint8_t* __restrict__ occ_out, uint8_t* __restrict__ any_out,
                 unsigned long long* __restrict__ swept) {
  __shared__ int list[kThreads];
  __shared__ int warp_need[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool want_any = any_out != nullptr;
  const float* rows = u.rows;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n ? begin + per_block : n;

  for (int64_t base = begin; base < end; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    bool need = false;
    if (r < end) {
      const Ray ray = load_ray(o, d, r);
      need = needs_sweep<kAnyHit>(u.box, ray, kAnyHit ? t_cut[r] : INFINITY, want_any);
      if (!need) {
        if (kAnyHit) {
          occ_out[r] = 0;
          if (want_any) any_out[r] = 0;
        } else {
          write_closest(table, -1, INFINITY, r, t_out, id_out, n_out, mat_out);
        }
      }
    }
    // List the chunk's lanes that need a sweep, in order (design, point 2).
    const unsigned mask = __ballot_sync(kFull, need);
    if (lane == 0) warp_need[warp] = __popc(mask);
    __syncthreads();
    int at = __popc(mask & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_need[w] : 0;
      total += warp_need[w];
    }
    if (need) list[at] = threadIdx.x;
    __syncthreads();
    if (swept != nullptr && threadIdx.x == 0) atomicAdd(swept, static_cast<unsigned long long>(total));
    if (threadIdx.x < total) {
      const int64_t q = base + list[threadIdx.x];
      sweep<kAnyHit>(rows, u.count, table, load_ray(o, d, q), kAnyHit ? t_cut[q] : 0.0f, q,
                     t_out, id_out, n_out, mat_out, occ_out, any_out);
    }
    __syncthreads();  // the next chunk reuses list and warp_need
  }
}

// Resident blocks of kThreads per SM, as the runtime computes them for a
// launch; negative on a CUDA error.
template <bool kAnyHit>
int blocks_per_sm() {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, small_kernel<kAnyHit>, kThreads, 0);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Blocks the card holds at once (the first device asked; the grid's size
// only, never a result, depends on it); negative on a CUDA error.
template <bool kAnyHit>
int resident_blocks() {
  static int blocks = 0;
  if (blocks < 1) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
    const int per_sm = blocks_per_sm<kAnyHit>();
    if (per_sm < 1) return per_sm < 0 ? per_sm : -static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = sms * per_sm;
  }
  return blocks;
}

template <bool kAnyHit>
int launch(const float* o, const float* d, const float* t_cut, const float* table,
           const float* table_host, const float* box, int count, int n, float* t,
           int* tri_id, float* n_geo, int* mat_id, uint8_t* occ, uint8_t* hit_any,
           unsigned long long* swept, void* stream) {
  if (count < 0 || count > kMaxRows || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_blocks<kAnyHit>();
  if (resident < 1) return -resident;
  Uniform u;
  memcpy(u.box, box, sizeof u.box);
  u.count = count;
  for (int k = 0; k < count; ++k)
    memcpy(&u.rows[k * kRowFloats], &table_host[k * kCols], 9 * sizeof(float));
  const int chunks = static_cast<int>((static_cast<int64_t>(n) + kThreads - 1) / kThreads);
  const int grid = chunks < resident ? chunks : resident;
  const int per_block = static_cast<int>((static_cast<int64_t>(n) + grid - 1) / grid);
  small_kernel<kAnyHit><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cut, table, u, n, per_block, t, tri_id, n_geo, mat_id, occ, hit_any, swept);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error.
// table: the rows on the device; table_host and box: the same rows and their
// root box on the host. swept may be null; else the kernel adds to it the
// lanes it swept.
int pt_small_closest(const float* o, const float* d, const float* table,
                     const float* table_host, const float* box, int count, int n,
                     float* t, int* tri_id, float* n_geo, int* mat_id,
                     unsigned long long* swept, void* stream) {
  return launch<false>(o, d, nullptr, table, table_host, box, count, n, t, tri_id, n_geo,
                       mat_id, nullptr, nullptr, swept, stream);
}

// hit_any may be null: then it is neither computed nor written.
int pt_small_occluded(const float* o, const float* d, const float* t_cut,
                      const float* table, const float* table_host, const float* box,
                      int count, int n, uint8_t* occ, uint8_t* hit_any,
                      unsigned long long* swept, void* stream) {
  return launch<true>(o, d, t_cut, table, table_host, box, count, n, nullptr, nullptr,
                      nullptr, nullptr, occ, hit_any, swept, stream);
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
