// Ray loading, the Moller-Trumbore test and the slab test shared by the port's
// kernels.
//
// Every kernel reads triangles from 16-column f32 rows laid out as v0.xyz
// e1.xyz e2.xyz valid id ..., and all must round t identically: built with
// -fmad=false and without fast math, the arithmetic below is rounded
// operation by operation in the order of the JAX sweeps
// (intersect_small_pallas.py:91-108, intersect_shortlist_pallas.py:275-293,
// intersect_pallas.py:58-79, intersect_cluster.py:125-146) and of the torch
// version (ops/intersect.py moller_trumbore), whose separate elementwise
// kernels never fuse into FMA: t agrees bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;  // f32 columns of a triangle row
constexpr float kEps = 1e-8f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Ray r of [B,3] origin and direction tensors (int64 r: 3 * r overflows int
// from about 715M rays on).
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int64_t r) {
  Ray ray;
  ray.ox = o[3 * r + 0];
  ray.oy = o[3 * r + 1];
  ray.oz = o[3 * r + 2];
  ray.dx = d[3 * r + 0];
  ray.dy = d[3 * r + 1];
  ray.dz = d[3 * r + 2];
  return ray;
}

// Moller-Trumbore against one table row; true when the triangle is accepted.
__device__ __forceinline__ bool hit_triangle(const float* __restrict__ row,
                                             const Ray& r, float& t_out) {
  const float ax = row[0], ay = row[1], az = row[2];
  const float bx = row[3], by = row[4], bz = row[5];
  const float cx = row[6], cy = row[7], cz = row[8];
  // pvec = d x e2
  const float px = r.dy * cz - r.dz * cy;
  const float py = r.dz * cx - r.dx * cz;
  const float pz = r.dx * cy - r.dy * cx;
  const float det = bx * px + by * py + bz * pz;
  const bool det_ok = fabsf(det) > kEps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  // s = o - v0
  const float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
  const float u = (sx * px + sy * py + sz * pz) * inv_det;
  // qvec = s x e1
  const float qx = sy * bz - sz * by;
  const float qy = sz * bx - sx * bz;
  const float qz = sx * by - sy * bx;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (cx * qx + cy * qy + cz * qz) * inv_det;
  t_out = t;
  return det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > kEps && row[9] > 0.5f;
}

constexpr float kBigF = 3.0e38f;

// Max and min that keep a NaN operand, as jnp.maximum and torch.maximum do
// (fmaxf and fminf drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// NaN-safe direction reciprocal of the JAX slab tests.
__device__ __forceinline__ float inv_dir(float w) {
  return (w >= 0.0f ? 1.0f : -1.0f) / nan_max(fabsf(w), 1e-12f);
}

// Slab test of box lo/hi (6 floats: lo.xyz hi.xyz) -> (t_near, t_far),
// starting from -+3e38 as the torch twins' enter_dists does.
__device__ __forceinline__ void slab(const float* box, const Ray& r,
                                     const float inv[3], float& t_near,
                                     float& t_far) {
  const float o[3] = {r.ox, r.oy, r.oz};
  t_near = -kBigF;
  t_far = kBigF;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (box[ax] - o[ax]) * inv[ax];
    const float t1 = (box[3 + ax] - o[ax]) * inv[ax];
    t_near = nan_max(t_near, nan_min(t0, t1));
    t_far = nan_min(t_far, nan_max(t0, t1));
  }
}

// The widening of every kernel's box cull: the slab entry and the
// Moller-Trumbore t round differently, so a cull that compared them exactly
// could drop a box holding an accepted hit (a ray that meets a flat box at its
// edge, where the slab interval comes out empty by a few ulps).
constexpr float kSlack = 1.0f / 4096;

// Slab entry distance of a ray to a box as a cull compares it, widened so that
// a box holding an accepted hit is never dropped: max(t_near, 0) where the
// slab interval [that entry, t_far] is empty by less than kSlack of the entry
// and t_far > 0, and lo.x <= hi.x (false for an empty box, whose lo = 3e38 >
// hi = -3e38); +inf elsewhere.
__device__ __forceinline__ float box_enter_widened(const float* box, const Ray& r,
                                                   const float inv[3]) {
  float t_near, t_far;
  slab(box, r, inv, t_near, t_far);
  const float e = nan_max(t_near, 0.0f);
  const bool ok = t_far >= e * (1.0f - kSlack) && t_far > 0.0f && box[0] <= box[3];
  return ok ? e : INFINITY;
}

// A lane at bound `best` needs a box entered at `e` (box_enter_widened) when
// the entry, less the slack, is within the bound: closest lanes also take
// entries equal to best (a later box may hold an equal t at a smaller id);
// any-hit lanes only a hit strictly before the bound.
template <bool kAnyHit>
__device__ __forceinline__ bool improvable(float e, float best) {
  const float s = e * (1.0f - kSlack);
  return kAnyHit ? s < best : (s <= best && e < INFINITY);
}

// The one box test of a cull: the widened entry `e` of a box where a lane at
// bound `best` needs it (box_enter_widened and improvable), +inf where it does
// not.
template <bool kAnyHit>
__device__ __forceinline__ float needed_entry(const float* box, const Ray& r,
                                              const float inv[3], float best) {
  const float e = box_enter_widened(box, r, inv);
  return improvable<kAnyHit>(e, best) ? e : INFINITY;
}

}  // namespace
