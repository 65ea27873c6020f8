// One ray against primitives of any type, each read from its packed,
// type-tagged records: what a kernel needs whose thread carries one ray
// through primitives of many types in an order of its own.  Shared by the
// BVH walk (bvh_traverse.cu, K4) and the cluster sweep (cluster_sweep.cu,
// K5).
//
// The primitive test is ops/intersect.py prim_hit_t_lanes with a frame's
// flags: a sphere is lerped when its record names a shutter slot
// (sweep_sphere.cuh's layout), and the ray goes to the primitive's object
// frame when the records say it is transformed.  The per-type functions
// are prim_hit.cuh's.  A medium's uniform is the ray's bounce word
// through stream_bits (P_MEDIUM, salt stable_id), the wrapper's int64
// word narrowed here.  A primitive is its type tag (int32) and K1b's two
// float4 records, geo and aux (a rect's aux carries its plane tag in .y),
// plus three float4 of transform when the kernel's frame has one.
// Rounding: as prim_hit.cuh, in the order of the plain version.

#pragma once

#include "prim_hit.cuh"

namespace hrt {

// One ray's state through its walk.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // the slab test's 1 / d
  RayTerms rt;       // the untransformed ray's terms
  float time;        // shutter time
  uint32_t bits;     // bounce word of the media's uniform
  int slot;          // the shutter slot f holds, -1 for none yet
  float f;           // lerp factor of that slot
};

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ time,
                                        const long long* __restrict__ bits) {
  Ray ray;
  ray.ox = o[3 * i];
  ray.oy = o[3 * i + 1];
  ray.oz = o[3 * i + 2];
  ray.dx = d[3 * i];
  ray.dy = d[3 * i + 1];
  ray.dz = d[3 * i + 2];
  ray.ix = __fdiv_rn(1.0f, ray.dx);
  ray.iy = __fdiv_rn(1.0f, ray.dy);
  ray.iz = __fdiv_rn(1.0f, ray.dz);
  ray.rt = ray_terms<-1>(ray.dx, ray.dy, ray.dz);
  ray.time = time[i];
  ray.bits = static_cast<uint32_t>(bits[i]);  // a word below 2^32
  ray.slot = -1;
  ray.f = 0.f;
  return ray;
}

// The primitive records.
struct Prims {
  const float4* __restrict__ geo;
  const float4* __restrict__ aux;
  const int* __restrict__ tag;
  const float4* __restrict__ xf;
  const float2* __restrict__ shutter;
  bool has_xf;  // the primitives tested are transformed
};

// The candidate t of primitive `pid` (ops/intersect.py prim_hit_t_lanes),
// kBig on a miss.
__device__ __forceinline__ float prim_t(Ray& ray, int pid, const Prims& pr,
                                        float t_min, float t_max) {
  const int type = __ldg(&pr.tag[pid]);
  const float4 g = __ldg(&pr.geo[pid]);
  const float4 m = __ldg(&pr.aux[pid]);
  float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  RayTerms rt = ray.rt;
  if (pr.has_xf) {
    to_object(__ldg(&pr.xf[3 * pid]), __ldg(&pr.xf[3 * pid + 1]),
              __ldg(&pr.xf[3 * pid + 2]), ox, oy, oz, dx, dy, dz);
    rt = ray_terms<-1>(dx, dy, dz);
  }
  switch (type) {
    case kSphere: {
      float cx = g.x, cy = g.y, cz = g.z;
      const int slot = __float_as_int(m.w);
      if (slot >= 0) {
        if (slot != ray.slot) {
          const float2 s = __ldg(&pr.shutter[slot]);
          ray.f = __fdiv_rn(__fsub_rn(ray.time, s.x), s.y);
          ray.slot = slot;
        }
        cx = __fadd_rn(cx, __fmul_rn(ray.f, m.x));
        cy = __fadd_rn(cy, __fmul_rn(ray.f, m.y));
        cz = __fadd_rn(cz, __fmul_rn(ray.f, m.z));
      }
      return sphere_t(cx, cy, cz, g.w, ox, oy, oz, dx, dy, dz, rt.a, t_min,
                      t_max);
    }
    case kRect:
      return rect_t(g, m.x, __float_as_int(m.y), ox, oy, oz, dx, dy, dz,
                    t_min, t_max);
    case kBox: {
      float entry, exit;
      box_slab(g, m, ox, oy, oz, rt, entry, exit);
      if (!(exit > entry)) return kBig;
      if (entry >= t_min && entry <= t_max) return entry;
      if (exit >= t_min && exit <= t_max) return exit;
      return kBig;
    }
    case kMediumSphere: {
      const Roots r = sphere_roots(g.x, g.y, g.z, g.w, ox, oy, oz, dx, dy,
                                   dz, rt.a);
      if (!r.exists) return kBig;
      const float u = medium_uniform(ray.bits, __float_as_uint(m.y));
      return medium_scatter_t(r.t_near, r.t_far, m.x, rt.len, t_min, t_max,
                              u);
    }
    case kMediumBox: {
      float entry, exit;
      box_slab(g, m, ox, oy, oz, rt, entry, exit);
      if (!(exit > entry)) return kBig;
      const float u = medium_uniform(ray.bits, __float_as_uint(m.w));
      return medium_scatter_t(entry, exit, g.w, rt.len, t_min, t_max, u);
    }
    default:  // a pad slot (PT_NONE)
      return kBig;
  }
}

// Primitives first .. first + count - 1 in index order, each against the
// running best as the inclusive t_max; one wins with a smaller t, or an
// equal t and a lower index, so ties go to the lowest index in any visit
// order.
__device__ __forceinline__ void test_range(Ray& ray, int first, int count,
                                           const Prims& pr, float t_min,
                                           float& t_best, int& best) {
  for (int j = 0; j < count; ++j) {
    const int pid = first + j;
    const float t = prim_t(ray, pid, pr, t_min, t_best);
    if (t < t_best || (t == t_best && pid < best)) {
      t_best = t;
      best = pid;
    }
  }
}

}  // namespace hrt
