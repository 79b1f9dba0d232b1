// The bounce of a fixed-depth wave and its adjoint, for Hopper (sm_90a): the
// path replay of inverse rendering by hand.
//
// Replaces no TPU kernel. The JAX package differentiates its bounce with
// jax.checkpoint around the scan step (pathtracer_tpu/ops/integrator.py);
// the port's plain path runs ops/integrator.py `bounce_core` under
// torch.utils.checkpoint, about a thousand small torch kernels per bounce and
// wave: the forward, its recomputation in the backward and autograd's
// backward of each op. Here a bounce is four launches (the route's closest
// hit, `bounce_shade_kernel`, the route's any-hit, `bounce_finish_kernel`) and
// a wave's backward is one launch of `bounce_adjoint_kernel`, whose rows the
// deterministic segment sum (gather_backward.cu) adds into the tables.
//
// Contract (ops/path_replay.py; its torch twin `record_plain` and
// `adjoint_plain` are the oracle):
//   The forward follows `bounce_core` op for op in float32 for the settings
//   `path_replay.covers` admits (fast shadows, one light sample, the Phong
//   lobe, geometric normals, the hash RNG, triangles only): the same RNG
//   bits, masks, miss-lane sanitising and parking. Where torch's CUDA
//   kernels round in an order of their own, this code takes that order:
//   a float tensor divided by a Python scalar is a product with the scalar's
//   float reciprocal (torch's div_true on CUDA), and a sum over the last
//   axis of a [B, 3] tensor is (x + z) + y (two threads share the three
//   terms in torch's reduction). The flags keep IEEE arithmetic
//   (-fmad=false, no fast math), as for every kernel of the port.
//   State [B] lanes: o, d, beta, rad [B, 3] f32, flags [B] u8 (bit 0 alive,
//   bit 1 the sticky specular flag). A lane that dies is parked for the next
//   bounce's closest hit, as `_park_rays` parks it (origin 1e6, direction +x).
//   Record of bounce k (ops/path_replay.py `Record`): ids [2, D, B] i32 (the
//   hit's material, the sampled light's material), bits [D, B] i32 (the
//   masks), f [D, 7, B] f32 (beta in, the NEE geometry term, the NEE and the
//   bounce's Phong q, the diffuse scale): 40 B a lane and bounce.
//   Adjoint: from dL/dradiance [B, 3] (radiance only accumulates, so one
//   gradient serves every bounce) each lane walks its records from the last
//   to the first carrying dL/dbeta, and writes bounce k's rows of the
//   gradients of Kd, Ks, Ns and Ke for the hit's material and of Ke for the
//   light's: rows of zeros where the lane adds nothing. A null row pointer is
//   a field that is not fitted: nothing is written for it.
//
// Deterministic: the same inputs give the same bits on every run. The ray
// count is an integer sum (one atomic add a warp); no float atomics.
//
// What bounds it: bytes. Per lane and bounce the shade kernel reads 49 B and
// writes 28; the finish kernel reads 74 and writes 89 with its record; the
// adjoint reads the record (40 B) and writes 52 B of rows. The material and
// light tables are a few hundred bytes and stay in L1. Measured
// (chip_smoke.py, an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6, row
// 6) at 262,144 lanes: shade 7.3 us, finish 23.5 us, the adjoint over 17
// bounces 156 us; 82%, 54% and 79% of that bound.

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;  // float(math.pi)
constexpr float kTwoPi = 2.0f * kPi;            // float(2.0 * math.pi)
// torch on CUDA: tensor / scalar = tensor * (1.0f / float(scalar))
constexpr float kInvPi = 1.0f / kPi;
constexpr float kInvTwoPi = 1.0f / kTwoPi;
constexpr float kParkPos = 1.0e6f;     // integrator._PARK_POS
constexpr float kNeeOffset = 1.0e-4f;  // integrator.NEE_OFFSET
constexpr float kRayOffset = 1.0e-3f;  // integrator.RAY_OFFSET
constexpr float kCutScale = 0.999f;    // 1 - rel_eps of intersect.occluded_before
constexpr float kTiny = 1.0e-20f;

// Record bits (ops/path_replay.py).
constexpr int kAdd = 1, kNee = 2, kPhongNee = 4, kLive = 8, kSpecular = 16, kGlossy = 32;
constexpr int kRecF = 7;

// ops/rng.py slots
constexpr int kLightChoice = 0, kLightBary = 1, kRr = 3, kFresnel = 4, kBsdfDir = 5;

}  // namespace

// The scene and settings a launch reads (ops/path_replay.py `_SceneArgs`).
struct BounceScene {
  const float* tri_v0;
  const float* tri_e1;
  const float* tri_e2;
  const float* tri_n;
  const int64_t* tri_mat;
  const float* mat_kd;
  const float* mat_ks;
  const float* mat_ke;
  const float* mat_ns;
  const float* mat_ni;
  const float* mat_illum;
  const int64_t* emissive_tri;
  const float* light_cdf;    // [e_pad] (area estimator) or null
  const float* light_total;  // [1] (area estimator) or null
  int e_pad;
  int n_emissive;            // max(num_emissive, 1)
  int compat_count;
  int compat_sticky;
  int compat_eta;
  float rr_prob;
  float inv_rr;              // float(1.0 / rr_prob)
  uint32_t seed_mix;         // rng._seed_mix(seed)
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p, long long i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void st3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 zero3() { return V3{0.0f, 0.0f, 0.0f}; }

// torch.sum(v, dim=-1) of a [B, 3] float tensor on CUDA.
__device__ __forceinline__ float hsum(V3 v) { return (v.x + v.z) + v.y; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return hsum(a * b); }
// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// bsdf.reflect: d - (2 (d.n)) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return d - (2.0f * dot(d, n)) * n; }

// --- the hash RNG (ops/rng.py), u32 arithmetic ---
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t slot_salt(uint32_t i) {
  uint32_t x = (i + 1u) * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return x;
}

// rng.bounce_uniforms_hash: a base hash of (pixel, sample, bounce), then one
// xorshift-multiply round per slot; the float is the top 24 bits.
struct Uniforms {
  uint32_t base;
  __device__ float operator()(int slot) const {
    uint32_t x = base ^ slot_salt(static_cast<uint32_t>(slot));
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  }
};

__device__ __forceinline__ Uniforms uniforms(int64_t pix, int64_t smp, int depth,
                                             uint32_t seed_mix) {
  uint32_t h = (static_cast<uint32_t>(pix) * 0x9E3779B1u) ^ seed_mix;
  h = fmix32(h ^ (static_cast<uint32_t>(smp) * 0x85EBCA77u));
  h = fmix32(h ^ (static_cast<uint32_t>(depth) * 0xC2B2AE3Du));
  return Uniforms{h};
}

// --- the closest hit's surface (intersect.closest_hit, miss lanes sanitised) ---
struct Surface {
  bool hit;
  long long mat;
  V3 point, n, kd, ks, ke;
  float ns, ni, illum;
};

__device__ __forceinline__ long long tri_at(const void* tri, int tri_bytes, long long i) {
  return tri_bytes == 4 ? static_cast<long long>(static_cast<const int32_t*>(tri)[i])
                        : static_cast<long long>(static_cast<const int64_t*>(tri)[i]);
}

__device__ Surface surface(const BounceScene& s, V3 o, V3 d, float t, long long tri) {
  Surface h;
  h.hit = isfinite(t) && tri >= 0;
  const float tp = h.hit ? t : 0.0f;
  h.point = o + tp * d;
  if (h.hit) {
    h.n = ld3(s.tri_n, tri);
    h.mat = s.tri_mat[tri];
    h.kd = ld3(s.mat_kd, h.mat);
    h.ks = ld3(s.mat_ks, h.mat);
    h.ke = ld3(s.mat_ke, h.mat);
    h.ns = s.mat_ns[h.mat];
    h.ni = s.mat_ni[h.mat];
    h.illum = s.mat_illum[h.mat];
  } else {
    h.n = v3(0.0f, 0.0f, 1.0f);
    h.mat = 0;
    h.kd = h.ks = h.ke = zero3();
    h.ns = 0.0f;
    h.ni = 1.0f;
    h.illum = 0.0f;
  }
  return h;
}

// --- the light sample (lights.sample_area_lights_detailed) ---
struct Light {
  V3 dir, point, n, ke;
  float t_target, weight;
  long long mat;
};

__device__ Light light_sample(const BounceScene& s, V3 x, float uc, float u1, float u2) {
  Light l;
  const int ne = s.n_emissive;
  long long j;
  if (s.compat_count) {
    j = static_cast<long long>(uc * static_cast<float>(ne));
    l.weight = 1.0f * (1.0f / static_cast<float>(ne));
  } else {
    // torch.searchsorted(cdf, u, right=True): the first entry above u.
    int lo = 0, hi = s.e_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.light_cdf[mid] <= uc) lo = mid + 1; else hi = mid;
    }
    j = lo;
    l.weight = 1.0f * s.light_total[0];
  }
  if (j > ne - 1) j = ne - 1;
  const long long tri = s.emissive_tri[j];
  const V3 v0 = ld3(s.tri_v0, tri);
  const V3 p1 = v0 + ld3(s.tri_e1, tri);
  const V3 p2 = v0 + ld3(s.tri_e2, tri);
  l.n = ld3(s.tri_n, tri);
  l.mat = s.tri_mat[tri];
  l.ke = ld3(s.mat_ke, l.mat);
  const float su = sqrtf(u1);
  const float b0 = 1.0f - su;
  const float b1 = u2 * su;
  const float b2 = (1.0f - b0) - b1;
  l.point = (b0 * v0 + b1 * p1) + b2 * p2;
  const V3 to_p = l.point - x;
  l.t_target = sqrtf(dot(to_p, to_p));
  const float len = clamp_min(l.t_target, kTiny);
  l.dir = V3{to_p.x / len, to_p.y / len, to_p.z / len};
  return l;
}

// bsdf._phong_spec's scalar: (ns + 2) / (2 pi) * clamp(q, 1e-20)^ns, and its
// derivative in ns.
__device__ __forceinline__ float phong_c(float ns, float q) {
  return ((ns + 2.0f) * kInvTwoPi) * powf(clamp_min(q, kTiny), ns);
}

__device__ __forceinline__ void phong_c_grad(float ns, float q, float& c, float& dc) {
  const float x = clamp_min(q, kTiny);
  const float p = powf(x, ns);
  const float a = (ns + 2.0f) * kInvTwoPi;
  c = a * p;
  dc = p * kInvTwoPi + c * logf(x);
}

__device__ __forceinline__ void park(float* o, float* d, long long i) {
  st3(o, i, v3(kParkPos, kParkPos, kParkPos));
  st3(d, i, v3(1.0f, 0.0f, 0.0f));
}

// What both kernels of a bounce derive alike from the lane's state and its
// closest hit: the surface and whether the lane goes on to NEE.
struct Lane {
  bool alive, spec, add, mid;
  Surface h;
};

__device__ Lane lane_at(const BounceScene& s, const float* o, const float* d,
                        const uint8_t* flags, const float* t, const void* tri, int tri_bytes,
                        long long i, int depth) {
  Lane L;
  const uint8_t f = flags[i];
  L.alive = (f & 1) != 0;
  L.spec = (f & 2) != 0;
  L.h = surface(s, ld3(o, i), ld3(d, i), t[i], tri_at(tri, tri_bytes, i));
  const bool active = L.alive && L.h.hit;
  L.add = active && hsum(L.h.ke) > 0.0f && (L.spec || depth == 0);
  L.mid = active && !L.add;
  return L;
}

__global__ void __launch_bounds__(kThreads)
bounce_shade_kernel(BounceScene s, const float* __restrict__ o, const float* __restrict__ d,
                    const uint8_t* __restrict__ flags, const float* __restrict__ t,
                    const void* __restrict__ tri, int tri_bytes,
                    const int64_t* __restrict__ pix, const int64_t* __restrict__ smp,
                    long long n, int depth, float* __restrict__ s_o, float* __restrict__ s_d,
                    float* __restrict__ t_cut) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Lane L = lane_at(s, o, d, flags, t, tri, tri_bytes, i, depth);
  if (!L.mid) {
    park(s_o, s_d, i);
    t_cut[i] = 0.0f * kCutScale;
    return;
  }
  const Uniforms u = uniforms(pix[i], smp[i], depth, s.seed_mix);
  const V3 x = L.h.point + L.h.n * kNeeOffset;
  const Light l = light_sample(s, x, u(kLightChoice), u(kLightBary), u(kLightBary + 1));
  st3(s_o, i, x);
  st3(s_d, i, l.dir);
  t_cut[i] = l.t_target * kCutScale;
}

__global__ void __launch_bounds__(kThreads)
bounce_finish_kernel(BounceScene s, float* __restrict__ o, float* __restrict__ d,
                     float* __restrict__ beta, float* __restrict__ rad,
                     uint8_t* __restrict__ flags, const float* __restrict__ t,
                     const void* __restrict__ tri, int tri_bytes,
                     const uint8_t* __restrict__ occ, const int64_t* __restrict__ pix,
                     const int64_t* __restrict__ smp, long long n, int depth, int max_depth,
                     int32_t* __restrict__ rec_ids, int32_t* __restrict__ rec_bits,
                     float* __restrict__ rec_f, unsigned long long* __restrict__ n_rays) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  bool counted_in = false, counted_mid = false;
  if (i < n) {
    const Lane L = lane_at(s, o, d, flags, t, tri, tri_bytes, i, depth);
    const Surface& h = L.h;
    counted_in = L.alive;
    counted_mid = L.mid;
    const V3 b = ld3(beta, i);
    V3 r = ld3(rad, i);
    if (L.add) r = r + b * h.ke;
    int bits = L.add ? kAdd : 0;
    long long light_mat = 0;
    float geom = 0.0f, q_nee = 0.0f, q_b = 0.0f, scale = 0.0f;
    bool live = false, new_spec = L.spec;
    if (L.mid) {
      const Uniforms u = uniforms(pix[i], smp[i], depth, s.seed_mix);
      const V3 dd = ld3(d, i);
      const V3 x = h.point + h.n * kNeeOffset;
      const Light l = light_sample(s, x, u(kLightChoice), u(kLightBary), u(kLightBary + 1));
      light_mat = l.mat;
      // -- NEE (integrator._nee, fast shadows, one sample)
      const bool nee = occ[i] == 0 && hsum(l.ke) > 0.0f;
      const V3 diff = h.point - l.point;
      const float d2 = dot(diff, diff);
      const float cos_l = dot(l.n, -l.dir);
      const bool phong = s.compat_count ? h.ns == 40.0f : hsum(h.ks) > 0.0f;
      const V3 refl = reflect(dd, h.n);
      q_nee = dot(refl, l.dir);
      V3 brdf;
      if (!phong) {
        brdf = h.kd * kInvPi;
      } else if (q_nee < 0.0f) {
        brdf = ((-q_nee) * h.kd) * kInvPi;
      } else {
        brdf = h.ks * phong_c(h.ns, q_nee);
      }
      const float cos_s = dot(h.n, l.dir);
      geom = ((cos_l * cos_s) / clamp_min(d2, kTiny)) * l.weight;
      if (nee) r = r + ((b * l.ke) * brdf) * geom;
      bits |= nee ? (kNee | (phong ? kPhongNee : 0)) : 0;
      // -- Russian roulette
      live = u(kRr) <= s.rr_prob;
      if (live) {
        // -- BSDF select (bsdf.dielectric_directions)
        const bool dielectric = h.illum == 7.0f;
        bool refract = false, chose_reflect = false;
        V3 refr = zero3();
        if (dielectric) {
          const float eta = s.compat_eta ? 2.5f : h.ni;
          const float cos_raw = fminf(fmaxf(dot(dd, h.n), -1.0f), 1.0f);
          const bool entering = cos_raw < 0.0f;
          const float cos_i = fabsf(cos_raw);
          const float eta_i = entering ? 1.0f : eta;
          const float eta_t = entering ? eta : 1.0f;
          const V3 n_ref = entering ? h.n : -h.n;
          const float rr = (eta_i - eta_t) / (eta_i + eta_t);
          const float r0 = rr * rr;
          const float r_theta = r0 + (1.0f - r0) * powf(1.0f - cos_i, 5.0f);
          const float ratio = eta_i / eta_t;
          const float k = 1.0f - (ratio * ratio) * (1.0f - cos_i * cos_i);
          const float coef = ratio * cos_i - sqrtf(fminf(fmaxf(k, 0.0f), 1.0f));
          refr = ratio * dd + coef * n_ref;
          const float len = clamp_min(sqrtf(dot(refr, refr)), kTiny);
          refr = V3{refr.x / len, refr.y / len, refr.z / len};
          chose_reflect = u(kFresnel) < r_theta;
          if (!s.compat_eta) chose_reflect = chose_reflect || k < 0.0f;
          refract = !chose_reflect;
        }
        const bool mirror = h.ns > 500.0f || (dielectric && chose_reflect);
        const bool specular = refract || mirror;
        const bool glossy = hsum(h.ks) > 0.0f && !specular;
        V3 new_d, new_b;
        bool bounce_spec = specular;
        if (specular) {
          new_d = refract ? refr : refl;
          new_b = b * s.inv_rr;
        } else {
          // bsdf.sample_cosine_hemisphere about n
          const float phi = kTwoPi * u(kBsdfDir);
          const float u2 = u(kBsdfDir + 1);
          const float cos_t = sqrtf(u2);
          const float sin_t = sqrtf(fmaxf(1.0f - u2, 0.0f));
          const float l0 = cosf(phi) * sin_t, l1 = sinf(phi) * sin_t;
          const V3 nn = h.n;
          const float sg = nn.z < 0.0f ? -1.0f : 1.0f;
          const float a = -(1.0f / (sg + nn.z));
          const float bb = (nn.x * nn.y) * a;
          const V3 tt = v3(1.0f + ((sg * nn.x) * nn.x) * a, sg * bb, (-sg) * nn.x);
          const V3 bt = v3(bb, sg + (nn.y * nn.y) * a, -nn.y);
          new_d = (l0 * tt + l1 * bt) + cos_t * nn;
          const float pdf = cos_t * kInvPi;
          q_b = dot(refl, new_d);
          V3 brdf_b;
          if (glossy) {
            brdf_b = q_b < 0.0f ? zero3() : h.ks * phong_c(h.ns, q_b);
          } else {
            brdf_b = h.kd * kInvPi;
          }
          const float cos_b = dot(new_d, nn);
          scale = (cos_b / clamp_min(pdf, kTiny)) * s.inv_rr;
          new_b = b * (brdf_b * scale);
          bounce_spec = glossy && depth == 0 && q_b >= 0.0f;
        }
        new_spec = s.compat_sticky ? (L.spec || bounce_spec) : specular;
        bits |= kLive | (specular ? kSpecular : 0) | (glossy ? kGlossy : 0);
        st3(o, i, h.point + kRayOffset * new_d);
        st3(d, i, new_d);
        st3(beta, i, new_b);
      }
    }
    if (!live) park(o, d, i);
    flags[i] = static_cast<uint8_t>((live ? 1 : 0) | (new_spec ? 2 : 0));
    st3(rad, i, r);
    const long long row = static_cast<long long>(depth) * n + i;
    rec_ids[row] = static_cast<int32_t>(h.mat);
    rec_ids[static_cast<long long>(max_depth) * n + row] = static_cast<int32_t>(light_mat);
    rec_bits[row] = bits;
    float* f = rec_f + static_cast<long long>(depth) * kRecF * n + i;
    f[0] = b.x;
    f[n] = b.y;
    f[2 * n] = b.z;
    f[3 * n] = geom;
    f[4 * n] = q_nee;
    f[5 * n] = q_b;
    f[6 * n] = scale;
  }
  // The rays this bounce traced: its live closest-hit rays and its shadow rays.
  const unsigned in = __popc(__ballot_sync(0xffffffffu, counted_in));
  const unsigned mid = __popc(__ballot_sync(0xffffffffu, counted_mid));
  if ((threadIdx.x & 31) == 0 && in + mid > 0)
    atomicAdd(n_rays, static_cast<unsigned long long>(in + mid));
}

__global__ void __launch_bounds__(kThreads)
bounce_adjoint_kernel(BounceScene s, const float* __restrict__ g_rad,
                      const int32_t* __restrict__ rec_ids, const int32_t* __restrict__ rec_bits,
                      const float* __restrict__ rec_f, long long n, int max_depth,
                      float* __restrict__ d_kd, float* __restrict__ d_ks,
                      float* __restrict__ d_ke, float* __restrict__ d_ns) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 gr = ld3(g_rad, i);
  const long long plane = static_cast<long long>(max_depth) * n;
  V3 gb = zero3();  // dL/dbeta after the bounce
  for (int k = max_depth - 1; k >= 0; --k) {
    const long long row = static_cast<long long>(k) * n + i;
    const int bits = rec_bits[row];
    V3 dkd = zero3(), dks = zero3(), dke = zero3(), dkel = zero3();
    float dns = 0.0f;
    if (bits != 0) {
      const long long m = rec_ids[row];
      const float* f = rec_f + static_cast<long long>(k) * kRecF * n + i;
      const V3 b = v3(f[0], f[n], f[2 * n]);
      const float geom = f[3 * n], q_nee = f[4 * n], q_b = f[5 * n], scale = f[6 * n];
      const V3 kd = ld3(s.mat_kd, m), ks = ld3(s.mat_ks, m);
      const float ns = s.mat_ns[m];
      V3 g = gb;  // dL/dbeta before the bounce
      // beta' = beta * (specular ? 1/rr : brdf * scale) on live lanes
      if (bits & kLive) {
        if (bits & kSpecular) {
          g = gb * s.inv_rr;
        } else {
          const V3 gf = (gb * b) * scale;  // dL/dbrdf
          V3 brdf;
          if (bits & kGlossy) {
            if (q_b >= 0.0f) {
              float c, dc;
              phong_c_grad(ns, q_b, c, dc);
              dks = dks + gf * c;
              dns += hsum(gf * ks) * dc;
              brdf = ks * c;
            } else {
              brdf = zero3();
            }
          } else {
            dkd = dkd + gf * kInvPi;
            brdf = kd * kInvPi;
          }
          g = gb * (brdf * scale);
        }
      }
      // radiance += ((beta * ke_light) * brdf) * geom
      if (bits & kNee) {
        const V3 kel = ld3(s.mat_ke, rec_ids[plane + row]);
        const V3 gx = gr * geom;
        V3 brdf;
        float c = 0.0f, dc = 0.0f;
        const bool phong = (bits & kPhongNee) != 0;
        if (!phong) {
          brdf = kd * kInvPi;
        } else if (q_nee < 0.0f) {
          brdf = ((-q_nee) * kd) * kInvPi;
        } else {
          phong_c_grad(ns, q_nee, c, dc);
          brdf = ks * c;
        }
        const V3 gbk = gx * brdf;  // dL/d(beta * ke_light)
        dkel = gbk * b;
        g = g + gbk * kel;
        const V3 gbr = gx * (b * kel);  // dL/dbrdf
        if (!phong) {
          dkd = dkd + gbr * kInvPi;
        } else if (q_nee < 0.0f) {
          dkd = dkd + (gbr * (-q_nee)) * kInvPi;
        } else {
          dks = dks + gbr * c;
          dns += hsum(gbr * ks) * dc;
        }
      }
      // radiance += beta * ke
      if (bits & kAdd) {
        dke = gr * b;
        g = g + gr * ld3(s.mat_ke, m);
      }
      gb = g;
    }
    if (d_kd) st3(d_kd, row, dkd);
    if (d_ks) st3(d_ks, row, dks);
    if (d_ns) d_ns[row] = dns;
    if (d_ke) {
      st3(d_ke, row, dke);
      st3(d_ke, plane + row, dkel);
    }
  }
}

unsigned blocks_for(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the first CUDA error.
// tri: the closest hit's triangle ids, int32 (tri_bytes 4) or int64 (8).

// The shadow ray of every lane that reaches NEE (origin, direction, cutoff
// t_target * 0.999); the other lanes' parked, with cutoff 0.
int pt_bounce_shade(const BounceScene* s, const float* o, const float* d, const uint8_t* flags,
                    const float* t, const void* tri, int tri_bytes, const int64_t* pix,
                    const int64_t* smp, int n, int depth, float* s_o, float* s_d, float* t_cut,
                    void* stream) {
  if (n < 0 || (tri_bytes != 4 && tri_bytes != 8)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  bounce_shade_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *s, o, d, flags, t, tri, tri_bytes, pix, smp, n, depth, s_o, s_d, t_cut);
  return static_cast<int>(cudaGetLastError());
}

// The rest of the bounce, in place on the lane state; bounce `depth`'s
// records of [max_depth, n]; adds the bounce's rays to n_rays.
int pt_bounce_finish(const BounceScene* s, float* o, float* d, float* beta, float* rad,
                     uint8_t* flags, const float* t, const void* tri, int tri_bytes,
                     const uint8_t* occ, const int64_t* pix, const int64_t* smp, int n,
                     int depth, int max_depth, int32_t* rec_ids, int32_t* rec_bits,
                     float* rec_f, unsigned long long* n_rays, void* stream) {
  if (n < 0 || depth < 0 || depth >= max_depth || (tri_bytes != 4 && tri_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  bounce_finish_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *s, o, d, beta, rad, flags, t, tri, tri_bytes, occ, pix, smp, n, depth, max_depth,
      rec_ids, rec_bits, rec_f, n_rays);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the material gradients from dL/dradiance and the records: d_kd,
// d_ks [max_depth, n, 3], d_ns [max_depth, n], d_ke [2, max_depth, n, 3]
// (the hit's material, then the light's); a null pointer is skipped.
int pt_bounce_adjoint(const BounceScene* s, const float* g_rad, const int32_t* rec_ids,
                      const int32_t* rec_bits, const float* rec_f, int n, int max_depth,
                      float* d_kd, float* d_ks, float* d_ke, float* d_ns, void* stream) {
  if (n < 0 || max_depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  bounce_adjoint_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *s, g_rad, rec_ids, rec_bits, rec_f, n, max_depth, d_kd, d_ks, d_ke, d_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
