// Tiled brute closest-hit ray/triangle kernel for Hopper (sm_90a):
// `intersector="pallas"`.
//
// Replaces the TPU kernel built by `_make_kernel` of
// pathtracer_tpu/ops/intersect_pallas.py (run by `_closest_flat`,
// pl.pallas_call at :120; entry point `closest_tri_pallas`).
//
// Contract (the plain torch sweep ops/intersect.closest_tri_brute is the
// oracle):
//   t [B] f32 of the nearest accepted triangle, inf on a miss, bit for bit the
//   brute sweep's; tri_id [B] i64, the smallest id among equal t, -1 on a miss.
// Inputs: o, d [B,3] f32 contiguous; table [R,16] f32 (ray_triangle.cuh rows,
//   row i for triangle i), any R >= 1.
//
// Design. One thread per ray, 256 rays per block. The block streams the table
// through shared memory one 128-row tile (8 KB) at a time: each thread holds
// two float4s of the next tile in registers while the block sweeps the current
// one, and stores them into the other of two tile buffers, so one barrier per
// tile suffices. Every ray sweeps a tile's rows in id order with a strict `<`,
// which keeps the smallest id among equal t within a tile and the earlier tile
// across tiles: JAX's lowest-lane argmin plus its strict `<` across tiles.
// Nothing but one tile is resident, so the scene has no size cap. The TPU
// kernel's 512-ray padding and its [B,1] / [1,T] component layout are not
// carried over: threads past the batch help stage tiles and write nothing.
//
// What bounds it on the card: per ray, R x ~40 flops on rows read from shared
// memory as warp broadcasts: compute and latency. Each block reads the whole
// table (64 bytes a row) from L2 once.

#include "ray_triangle.cuh"

namespace {

constexpr int kBlock = 256;                        // rays per block
constexpr int kTile = 128;                         // rows per staged tile
constexpr int kTile4 = kTile * kCols / 4;          // float4s per tile
constexpr int kPerThread = kTile4 / kBlock;        // float4s each thread copies
static_assert(kTile4 % kBlock == 0, "a tile must split evenly over the block");

// Tile `k`'s float4s owned by this thread; rows past the table are zero
// (valid = 0, never accepted).
__device__ __forceinline__ void load_tile(const float4* __restrict__ table4,
                                          int64_t rows, int k,  // int64: rows * 4
                                          float4 (&reg)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = static_cast<int64_t>(k) * kTile4 + threadIdx.x + j * kBlock;
    reg[j] = i < rows * (kCols / 4) ? table4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kBlock)
    tiled_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ table, int rows, int n,
                         float* __restrict__ t_out, int64_t* __restrict__ id_out) {
  __shared__ float4 tiles[2][kTile4];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool in_batch = r < n;
  Ray ray = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
  if (in_batch) ray = load_ray(o, d, r);

  const float4* table4 = reinterpret_cast<const float4*>(table);
  const int n_tiles = (rows + kTile - 1) / kTile;
  float4 reg[kPerThread];
  load_tile(table4, rows, 0, reg);

  float best = INFINITY;
  int64_t best_id = -1;
  for (int k = 0; k < n_tiles; ++k) {
    float4* buf = tiles[k & 1];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) buf[threadIdx.x + j * kBlock] = reg[j];
    // All threads have swept tile k - 1 before any thread passes here, so the
    // next store into that buffer (at tile k + 1) is safe.
    __syncthreads();
    if (k + 1 < n_tiles) load_tile(table4, rows, k + 1, reg);  // in flight
    if (in_batch) {
      const float* rows_s = reinterpret_cast<const float*>(buf);
      const int base = k * kTile;
      const int m = min(kTile, rows - base);
      for (int i = 0; i < m; ++i) {
        float t;
        if (hit_triangle(rows_s + i * kCols, ray, t) && t < best) {
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
int pt_tiled_closest(const float* o, const float* d, const float* table, int rows,
                     int n, float* t, int64_t* tri_id, void* stream) {
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((static_cast<int64_t>(n) + kBlock - 1) / kBlock);
  tiled_closest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, table, rows, n, t, tri_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
