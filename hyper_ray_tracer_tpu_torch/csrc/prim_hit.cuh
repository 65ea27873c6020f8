// The hit distance of one ray against one primitive of each type, as
// device functions that every trace kernel shares: the sweeps
// (sphere_sweep.cu K1, typed_sweep.cu K1b, through sweep_sphere.cuh) and
// the BVH traversal (bvh_traverse.cu K4).  Each follows the plain version
// in ops/intersect.py operation for operation.
//
// Rounding: every step is one IEEE round-to-nearest operation (__fadd_rn,
// __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) in the plain version's
// order, so nvcc cannot contract a * b + c into an FMA and no reciprocal
// replaces a division.  The slab's 1e-20 floor and the rect's dk == 0
// guard are kept.  The medium's log is the CUDA math library's logf (no
// fast math), the function torch's CUDA log calls.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hrt {

constexpr float kBig = 3.0e38f;
constexpr float kRehitEps = 1.0e-4f;  // constant_medium.rs:38
constexpr float kSlabFloor = 1e-20f;

// Primitive type tags (models/scene.py PT_*).
constexpr int kSphere = 0;
constexpr int kRect = 1;
constexpr int kMediumSphere = 2;
constexpr int kMediumBox = 3;
constexpr int kBox = 4;

// a.b summed left to right with one rounding per step (ops/intersect.py
// _dot3).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// x unchanged, as computed here.  The empty asm claims to change x, so
// the compiler cannot move x's computation (a correctly rounded division,
// say) into the pair loop that reads x, as it otherwise may to save a
// register: a per-ray term is computed once per ray, not once per pair.
__device__ __forceinline__ float pin(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// The half-b quadratic of a sphere (c, r2 = r * r) against ray (o, d)
// with a = |d|^2 (ops/intersect.py sphere_roots): the discriminant, and
// the roots when it is >= 0.
struct Roots {
  float t_near, t_far;
  bool exists;
};

__device__ __forceinline__ Roots sphere_roots(float cx, float cy, float cz,
                                              float r2, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float a) {
  const float ocx = __fsub_rn(ox, cx);
  const float ocy = __fsub_rn(oy, cy);
  const float ocz = __fsub_rn(oz, cz);
  const float half_b = dot3(ocx, ocy, ocz, dx, dy, dz);
  const float c = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), r2);
  const float disc = __fsub_rn(__fmul_rn(half_b, half_b), __fmul_rn(a, c));
  Roots out;
  out.exists = disc >= 0.0f;
  out.t_near = out.t_far = kBig;
  if (out.exists) {  // rare per pair: the ray's line meets the sphere
    const float sq = __fsqrt_rn(fmaxf(disc, 1e-30f));
    out.t_near = __fdiv_rn(__fsub_rn(-half_b, sq), a);
    out.t_far = __fdiv_rn(__fadd_rn(-half_b, sq), a);
  }
  return out;
}

// Nearer root first, inclusive [t_min, t_max] (sphere.rs:40-58); kBig on
// a miss.
__device__ __forceinline__ float sphere_t(float cx, float cy, float cz,
                                          float r2, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float a, float t_min,
                                          float t_max) {
  const Roots rt = sphere_roots(cx, cy, cz, r2, ox, oy, oz, dx, dy, dz, a);
  if (!rt.exists) return kBig;
  if (rt.t_near >= t_min && rt.t_near <= t_max) return rt.t_near;
  if (rt.t_far >= t_min && rt.t_far <= t_max) return rt.t_far;
  return kBig;
}

// ops/rng.py: fmix32, stream_bits(bits, P_MEDIUM, salt), bits_to_uniform.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float medium_uniform(uint32_t bits,
                                                uint32_t salt) {
  const uint32_t mixed = bits + 0x20u * 0x9E3779B9u + salt * 0x85EBCA6Bu;
  return __fmul_rn(__uint2float_rn(fmix32(mixed) >> 8), 0x1p-24f);
}

// Terms of the ray in a primitive's frame that every pair of the frame
// shares.
struct RayTerms {
  float a;           // |d|^2
  float ix, iy, iz;  // slab reciprocals
  float len;         // sqrt(|d|^2)
};

__device__ __forceinline__ float slab_inv(float d) {
  return __fdiv_rn(1.0f, fabsf(d) < kSlabFloor ? kSlabFloor : d);
}

// The terms a primitive of type kType reads (kType < 0: every type's).
template <int kType>
__device__ __forceinline__ RayTerms ray_terms(float dx, float dy, float dz) {
  constexpr bool kAll = kType < 0;
  RayTerms t{0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (kAll || kType == kSphere || kType == kMediumSphere ||
                kType == kMediumBox) {
    t.a = pin(dot3(dx, dy, dz, dx, dy, dz));
  }
  if constexpr (kAll || kType == kMediumSphere || kType == kMediumBox) {
    t.len = pin(__fsqrt_rn(t.a));
  }
  if constexpr (kAll || kType == kBox || kType == kMediumBox) {
    t.ix = pin(slab_inv(dx));
    t.iy = pin(slab_inv(dy));
    t.iz = pin(slab_inv(dz));
  }
  return t;
}

// World ray -> object frame: o' = R^T (o - t), d' = R^T d, component i
// summed left to right over R's rows (ops/intersect.py _xform_ray).
// x0..x2 hold R row-major, then t.
__device__ __forceinline__ void to_object(const float4 x0, const float4 x1,
                                          const float4 x2, float& ox,
                                          float& oy, float& oz, float& dx,
                                          float& dy, float& dz) {
  const float mx = __fsub_rn(ox, x2.y);
  const float my = __fsub_rn(oy, x2.z);
  const float mz = __fsub_rn(oz, x2.w);
  const float c0[3] = {x0.x, x0.w, x1.z};  // column 0: R00, R10, R20
  const float c1[3] = {x0.y, x1.x, x1.w};  // column 1
  const float c2[3] = {x0.z, x1.y, x2.x};  // column 2
  ox = dot3(c0[0], c0[1], c0[2], mx, my, mz);
  oy = dot3(c1[0], c1[1], c1[2], mx, my, mz);
  oz = dot3(c2[0], c2[1], c2[2], mx, my, mz);
  const float ex = dx, ey = dy, ez = dz;
  dx = dot3(c0[0], c0[1], c0[2], ex, ey, ez);
  dy = dot3(c1[0], c1[1], c1[2], ex, ey, ez);
  dz = dot3(c2[0], c2[1], c2[2], ex, ey, ez);
}

// ops/intersect.py rect_t: (k, a, b) axes by plane tag (rect.rs:54-58);
// geo = (a0, b0, k, a1), b1.
__device__ __forceinline__ float rect_t(const float4 g, float b1, int ax,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float t_min, float t_max) {
  float ok, oa, ob, dk, da, db;
  if (ax == 0) {  // XY: k on z
    ok = oz; oa = ox; ob = oy; dk = dz; da = dx; db = dy;
  } else if (ax == 1) {  // YZ: k on x
    ok = ox; oa = oy; ob = oz; dk = dx; da = dy; db = dz;
  } else {  // ZX: k on y
    ok = oy; oa = oz; ob = ox; dk = dy; da = dz; db = dx;
  }
  if (dk == 0.0f) return kBig;  // parallel to the plane
  const float t = __fdiv_rn(__fsub_rn(g.z, ok), dk);
  const float a = __fadd_rn(oa, __fmul_rn(t, da));
  const float b = __fadd_rn(ob, __fmul_rn(t, db));
  const bool hit = t >= t_min && t <= t_max && a >= g.x && a <= g.w &&
                   b >= g.y && b <= b1;
  return hit ? t : kBig;
}

// ops/intersect.py _box_slab with the reciprocals of the ray's direction.
__device__ __forceinline__ void box_slab(const float4 p0, const float4 p1,
                                         float ox, float oy, float oz,
                                         const RayTerms& rt, float& entry,
                                         float& exit) {
  const float lx = __fmul_rn(__fsub_rn(p0.x, ox), rt.ix);
  const float hx = __fmul_rn(__fsub_rn(p1.x, ox), rt.ix);
  const float ly = __fmul_rn(__fsub_rn(p0.y, oy), rt.iy);
  const float hy = __fmul_rn(__fsub_rn(p1.y, oy), rt.iy);
  const float lz = __fmul_rn(__fsub_rn(p0.z, oz), rt.iz);
  const float hz = __fmul_rn(__fsub_rn(p1.z, oz), rt.iz);
  entry = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  exit = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
}

// ops/intersect.py _medium_scatter_t: free flight inside [entry, exit].
__device__ __forceinline__ float medium_scatter_t(float entry, float exit,
                                                  float nid, float ray_len,
                                                  float t_min, float t_max,
                                                  float u) {
  bool exists = exit >= __fadd_rn(entry, kRehitEps);
  float t1 = fmaxf(entry, t_min);
  const float t2 = fminf(exit, t_max);
  exists = exists && t1 < t2;
  t1 = fmaxf(t1, 0.0f);
  const float dist_inside = __fmul_rn(__fsub_rn(t2, t1), ray_len);
  const float hit_dist = __fmul_rn(nid, logf(u));
  exists = exists && hit_dist <= dist_inside;
  return exists ? __fadd_rn(t1, __fdiv_rn(hit_dist, ray_len)) : kBig;
}

}  // namespace hrt
