// Ray loading and the Moller-Trumbore test shared by the port's kernels.
//
// Both intersect_small.cu and intersect_shortlist.cu read triangles from
// 16-column f32 rows laid out as v0.xyz e1.xyz e2.xyz valid id ..., and both
// must round t identically: built with -fmad=false and without fast math, the
// arithmetic below is rounded operation by operation in the order of the JAX
// sweeps (intersect_small_pallas.py:91-108, intersect_shortlist_pallas.py:275-
// 293) and of the torch version (ops/intersect.py moller_trumbore), whose
// separate elementwise kernels never fuse into FMA: t agrees bit for bit.

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

}  // namespace
