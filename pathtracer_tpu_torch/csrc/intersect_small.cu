// Small-scene closest-hit and any-hit ray/triangle kernels for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of pathtracer_tpu/ops/intersect_small_pallas.py
// (driven by `_small_pallas_raw`, entry points `closest_tri_small_pallas_attrs`
// and `occluded_tri_small_pallas`). It serves scenes of at most 256 triangles,
// 8-rounded (T8), e.g. every Cornell-box scene.
//
// Contract (the plain torch version in ops/intersect_small.py is the oracle):
//   closest:  t [B] f32, tri_id [B] i32, n_geo [B,3] f32, mat_id [B] i32 of the
//             nearest accepted triangle, smallest id among equal t;
//             a miss gives inf, -1, 0, 0.
//   occluded: occ [B] u8 = some accepted t < t_cut; hit_any [B] u8 (optional)
//             = some triangle accepted at all.
// Inputs: o, d [B,3] f32 contiguous; table [T8,16] f32 with columns
//   v0.xyz e1.xyz e2.xyz valid id n.xyz mat_id pad.
//
// Design. One thread per ray reads its origin and direction straight from the
// [B,3] tensors. Each block copies the whole table (at most 16 KB) into shared
// memory once; all threads of a warp then read the same row, a broadcast. The
// loop runs over triangles in increasing id with a strict `<` on t, which gives
// the min-id tie-break; the winner's normal and material are read from its
// shared-memory row after the loop. `occluded` returns at the first accepted
// t < t_cut: that also settles hit_any.
//
// Exactness. `hit_triangle` (ray_triangle.cuh, shared with the shortlist
// kernel) rounds Moller-Trumbore operation by operation in the order of the
// JAX kernel (intersect_small_pallas.py:91-108) and of the torch version:
// t agrees bit for bit.
//
// What bounds it on the card: per ray, T8 x ~40 flops against 28 bytes of ray
// traffic (plus the outputs), so compute and latency, not HBM. wgmma, TMA,
// warp-level ray packets and a wider T range are later work.

#include "ray_triangle.cuh"

namespace {

constexpr int kMaxT8 = 256;
constexpr int kBlock = 256;

__device__ __forceinline__ void stage_table(float* tab,
                                            const float* __restrict__ table,
                                            int t8) {
  for (int i = threadIdx.x; i < t8 * kCols; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
    small_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ table, int t8, int n,
                         float* __restrict__ t_out, int* __restrict__ id_out,
                         float* __restrict__ n_out, int* __restrict__ mat_out) {
  __shared__ float tab[kMaxT8 * kCols];
  stage_table(tab, table, t8);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(o, d, r);

  float best_t = INFINITY;
  int best = -1;
  for (int k = 0; k < t8; ++k) {
    float t;
    if (hit_triangle(&tab[k * kCols], ray, t) && t < best_t) {
      best_t = t;
      best = k;
    }
  }
  t_out[r] = best_t;
  id_out[r] = best;
  if (best >= 0) {
    const float* w = &tab[best * kCols];
    n_out[3 * r + 0] = w[11];
    n_out[3 * r + 1] = w[12];
    n_out[3 * r + 2] = w[13];
    mat_out[r] = static_cast<int>(w[14]);
  } else {
    n_out[3 * r + 0] = 0.0f;
    n_out[3 * r + 1] = 0.0f;
    n_out[3 * r + 2] = 0.0f;
    mat_out[r] = 0;
  }
}

__global__ void __launch_bounds__(kBlock)
    small_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_cut,
                          const float* __restrict__ table, int t8, int n,
                          uint8_t* __restrict__ occ_out,
                          uint8_t* __restrict__ any_out) {
  __shared__ float tab[kMaxT8 * kCols];
  stage_table(tab, table, t8);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(o, d, r);
  const float cut = t_cut[r];

  bool occ = false;
  bool any = false;
  for (int k = 0; k < t8; ++k) {
    float t;
    if (hit_triangle(&tab[k * kCols], ray, t)) {
      any = true;
      if (t < cut) {
        occ = true;
        break;
      }
    }
  }
  occ_out[r] = occ;
  if (any_out != nullptr) any_out[r] = any;
}

int grid_for(int n) {
  return static_cast<int>((static_cast<int64_t>(n) + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError().
int pt_small_closest(const float* o, const float* d, const float* table, int t8,
                     int n, float* t, int* tri_id, float* n_geo, int* mat_id,
                     void* stream) {
  if (t8 < 1 || t8 > kMaxT8 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  small_closest_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, table, t8, n, t, tri_id, n_geo, mat_id);
  return static_cast<int>(cudaGetLastError());
}

int pt_small_occluded(const float* o, const float* d, const float* t_cut,
                      const float* table, int t8, int n, uint8_t* occ,
                      uint8_t* hit_any, void* stream) {
  if (t8 < 1 || t8 > kMaxT8 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  small_occluded_kernel<<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, t_cut, table, t8, n, occ, hit_any);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
