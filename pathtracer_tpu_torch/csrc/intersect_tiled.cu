// Tiled closest-hit and any-hit ray/triangle kernels for Hopper (sm_90a):
// `intersector="pallas"`, `auto`'s route for 257-2047 padded triangles.
//
// Replaces the TPU kernel built by `_make_kernel` of
// pathtracer_tpu/ops/intersect_pallas.py (run by `_closest_flat`,
// pl.pallas_call at :120; entry point `closest_tri_pallas`).
//
// Contract (the plain torch sweeps ops/intersect.closest_tri_brute and
// ops/intersect._occluded_tri_brute are the oracles):
//   closest:  t [B] f32 of the nearest accepted triangle, inf on a miss, bit
//             for bit the brute sweep's; tri_id [B] i64, the smallest id among
//             equal t, -1 on a miss.
//   occluded: occ [B] u8 = some accepted triangle strictly before t_cut;
//             hit_any [B] u8 (optional) = some triangle accepted at all. These
//             are the closest entry's t < t_cut and isfinite(t), which the
//             JAX package answers occlusion with on this route.
// Inputs: tile_walk.cuh's (the shortlist kernel's table and boxes).
//
// It computes what the TPU kernel computes (every ray against every row, a
// running (t, id) minimum), not the way that kernel does it: that kernel, and
// this one's earlier design, made every ray test every row. A ray of the band
// needs about two of its 9-16 tiles, so here each warp runs tile_walk.cuh's
// walk (root pre-test, per-ray widened cull, dense or sparse sweeps) over the
// tiles in index order.
//
// Why index order: a front-to-back order per warp saved about as many tests
// as it cost, and measured 1.5-2.6% slower on the band stand-in (PERF.md):
// with unsorted rays, as `auto` leaves this route's, a warp's lanes need
// different tiles, so no one order suits them all.
//
// Rows. The whole table is at most 128 KB in the band (72 KB at 1,152 rows),
// read through L1/L2; staging it in shared memory once per block measured
// slower at 128 and at 512 threads a block (tiled_variants.py, in git at
// d707472; PERF.md).
//
// What bounds it on the card: operations, issued per warp. Per needed (ray,
// tile), 4 Moller-Trumbore tests a lane (46 flops and an IEEE division each)
// in a sparse sweep, or a share of 128 in a dense one, and an argmin of 5
// shuffle rounds; per ray, C slab tests. The tests are roofline.py's work;
// the slab tests, the argmins, the lanes idle in dense sweeps and the tiles
// a ray tests before its final t is known are what the kernel does beyond it.

#include "tile_walk.cuh"

namespace {

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tiled_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_cut, const float* __restrict__ table,
                 const float* __restrict__ bounds, int c, int n,
                 float* __restrict__ t_out, int64_t* __restrict__ id_out,
                 uint8_t* __restrict__ occ_out, uint8_t* __restrict__ any_out) {
  trace_ray<kAnyHit>(o, d, t_cut, table, bounds, c, n, t_out, id_out, occ_out, any_out);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error.
int pt_tiled_closest(const float* o, const float* d, const float* table, const float* bounds,
                     int c, int n, float* t, int64_t* tri_id, void* stream) {
  return launch_walk(tiled_kernel<false>, o, d, nullptr, table, bounds, c, n, t, tri_id,
                     nullptr, nullptr, stream);
}

// hit_any may be null: then it is neither computed nor written.
int pt_tiled_occluded(const float* o, const float* d, const float* t_cut,
                      const float* table, const float* bounds, int c, int n,
                      uint8_t* occ, uint8_t* hit_any, void* stream) {
  return launch_walk(tiled_kernel<true>, o, d, t_cut, table, bounds, c, n, nullptr, nullptr,
                     occ, hit_any, stream);
}

}  // extern "C"
